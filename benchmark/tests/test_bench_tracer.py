"""The benchmark and the port's tracer (``stages.py``): an untraced run
measures the program with its span recorder off, and its data holds the
keys it held before the recorder existed."""
import pytest

from benchmark import harness

KEYS = {"buffalo_l.stream_1080p_card": {"batches", "frames", "window_s",
                                        "faces"},
        "buffalo_l.lookup_pq10m": {"lookups", "window_s"}}


@pytest.mark.parametrize("cell", sorted(KEYS))
def test_an_untraced_run_leaves_the_recorder_off(small_cell, cell):
    from scrfd_arcface_facerecognition_tpu_torch import stages

    spec, ctx = small_cell(cell, 2 ** 31 + 7)
    out = harness.run_cell(spec, ctx)
    assert out["correct"]
    assert set(out["data"]) == KEYS[cell]
    assert stages.span("stream.finish") is stages.span("pq.search")
    assert stages.report() == {}

"""The benchmark's tests: on the CPU at small sizes, except those marked
``card``, which run on an NVIDIA card (``python3 -m pytest benchmark/tests
-m card`` there) and skip elsewhere, decided in a fixture."""
from __future__ import annotations

import time

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def small(ctx):
    """A cell's context cut to a size the CPU runs in seconds: few small
    frames, and models as their families cut them (``small``: one block a
    stage deep at their widths)."""
    from benchmark import core
    from benchmark.reference import standins

    for part, entry in core.model_entries(ctx.config).items():
        ctx.config[part] = standins.small(entry)
    if ctx.traffic["kind"] == "stream":
        ctx.traffic.update(frames=2, height=96, width=160, pool=2,
                           gallery_rows=16, gallery_near=8, calib_frames=2,
                           judge_share=1.0, trace_seconds=0.5)
    else:
        ctx.traffic.update(rows=40_000, identities=4_000, queries=8, pool=3,
                           trace_seconds=0.5)
    return ctx


@pytest.fixture
def small_cell():
    """A function (cell, seed, trace=False) -> the cell's context on the
    CPU at a small size."""
    import torch

    from benchmark import core, harness

    spec = core.load_spec()
    context = harness.context          # as it is before a test replaces it

    def make(cell, seed, trace=False, seconds=1.0):
        return spec, small(context(spec, cell, seed, seconds, trace,
                                   torch.device("cpu"), time.perf_counter()))
    return make

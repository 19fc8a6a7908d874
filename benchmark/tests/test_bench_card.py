"""The command itself: refused without a card; on a card (``-m card``),
every cell at its own size gives the contract's line with ``correct``
true, and the stream control at the cell's own size is not correct."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
SPEC = core.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run_py(cell, seed, seconds, trace, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env=dict(os.environ, **(env or {})))


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = run_py(CELLS[0], 2 ** 31 + 1, 1, 0, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_prints_the_contract_line(card, cell, trace):
    out = run_py(cell, 2 ** 31 + 17, 5, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = (core.per_layer_for(SPEC, cell) if trace
            else core.end_to_end_for(SPEC, cell))
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    else:
        assert line["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if "stream" in c])
def test_the_stream_control_fails_at_the_cells_size(card, cell):
    from benchmark import calibrate

    got = calibrate.control_readings(SPEC, cell, 2 ** 31 + 23, card)
    limits = core.read_json(core.limits_file(cell))["limits"]
    assert any(got[k] > limits[k] for k in got), (got, limits)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["the_top_faces_by_score",
                                   "max_det_left_out",
                                   "crops_from_the_wrong_frame",
                                   "a_stale_batch"])
@pytest.mark.parametrize("cell", [c for c in CELLS if "stream" in c][:1])
def test_a_stream_fault_fails_at_the_cells_size(card, cell, fault,
                                                monkeypatch):
    """The faults of ``test_bench_correct`` planted in the program on the
    card, the cell at its own size over a 3 s window; prints the
    numbers."""
    import time

    from benchmark import harness
    from benchmark.tests import test_bench_correct as faults

    getattr(faults, "plant_" + fault)(monkeypatch)
    ctx = harness.context(SPEC, cell, 2 ** 31 + 29, 3.0, False, card,
                          time.perf_counter())
    out = harness.run_cell(SPEC, ctx)
    print(fault, {c["name"]: c["value"] for c in out["checks"]})
    assert not out["correct"], out["checks"]

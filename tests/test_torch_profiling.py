"""The port's ``utils/profiling.py`` on the CPU, beside the tracer it
serves: the recorder's report (``stages.py``), ``trace(None)`` a no-op,
``trace(dir)`` writing a Chrome trace that holds the recorder's spans,
and ``sync`` over nested tensors."""
import json
import os
import time

import torch

from scrfd_arcface_facerecognition_tpu_torch import stages
from scrfd_arcface_facerecognition_tpu_torch.utils import profiling


def test_stage_timer_reports_each_stage():
    """The port's one timer of stages and spans is the tracer's recorder:
    host ms and counts by name, nothing once reset."""
    stages.enable()
    try:
        for _ in range(2):
            with stages.stage("scrfd"):
                time.sleep(0.01)
        with stages.span("scrfd_train.update"):
            torch.zeros(1)
        rep = stages.report()
    finally:
        stages.disable()
        stages.reset()
    assert set(rep) == {"scrfd", "scrfd_train.update"}
    assert rep["scrfd"]["n"] == 2 and rep["scrfd"]["ms"] >= 20
    assert rep["scrfd_train.update"]["n"] == 1
    assert stages.report() == {}


def test_sync_walks_nested_tensors_and_waits_on_cuda_devices(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    profiling.sync({"a": [torch.ones(2), (torch.zeros(1),)], "b": 3})
    assert waited == []               # CPU tensors are ready: no wait
    meta = torch.empty(2, device="meta")

    class Cuda:
        """A stand-in for a CUDA tensor's device."""
        type = "cuda"

    monkeypatch.setattr(profiling, "_tensors", lambda tree: [
        type("T", (), {"device": Cuda})(), meta])
    profiling.sync(None)
    assert waited == [Cuda]           # one wait for the one CUDA device


def test_trace_none_is_a_no_op(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    out = tmp_path / "trace"
    stages.enable()
    try:
        with profiling.trace(str(out)) as prof:
            with stages.span("scrfd_train.forward"):
                torch.randn(32, 32) @ torch.randn(32, 32)
    finally:
        stages.disable()
        stages.reset()
    assert prof is not None
    path = out / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "scrfd_train.forward" in names
    assert any("mm" in str(n) for n in names)

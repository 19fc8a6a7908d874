"""The port's ``utils/profiling.py`` on the CPU: ``StageTimer``'s report,
``trace(None)`` a no-op, ``trace(dir)`` writing a Chrome trace that holds
the ``annotate`` spans, and ``sync`` over nested tensors."""
import json
import os
import time

import torch

from scrfd_arcface_facerecognition_tpu_torch.utils import profiling


def test_stage_timer_reports_each_stage(monkeypatch):
    synced = []
    monkeypatch.setattr(profiling, "sync", synced.append)
    t = profiling.StageTimer()
    for _ in range(2):
        with t.stage("detect", items=8) as s:
            s["result"] = torch.ones(3)
            time.sleep(0.01)
    with t.stage("embed", sync_result=False) as s:
        s["result"] = torch.zeros(1)
    rep = t.report()
    assert set(rep) == {"detect", "embed"}
    d = rep["detect"]
    assert d["calls"] == 2 and d["total_s"] >= 0.02
    assert abs(d["ms_per_call"] - d["total_s"] * 500) < 0.1
    assert d["items_per_s"] > 0 and "items_per_s" not in rep["embed"]
    assert len(synced) == 2           # only the stages that asked for it
    t.reset()
    assert t.report() == {}


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
    with profiling.trace(str(out)) as prof:
        with profiling.annotate("scrfd_train.forward"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    assert prof is not None
    path = out / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "scrfd_train.forward" in names
    assert any("mm" in str(n) for n in names)

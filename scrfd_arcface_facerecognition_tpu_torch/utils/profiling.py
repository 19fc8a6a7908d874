"""Observability: per-stage timers and ``torch.profiler`` trace hooks.

- ``StageTimer``: named wall-clock accumulators that wait for the device
  when a stage ends, reporting per-stage ms and throughput;
- ``trace()``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (viewable in Perfetto or chrome://tracing);
- ``annotate()``: a named range on the profiler's timeline
  (``torch.profiler.record_function``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree: Any) -> None:
    """Wait until the work that makes the tensors of ``tree`` (a tensor, or
    dicts, lists and tuples of them) is done: one synchronize for each CUDA
    device they lie on; CPU tensors are ready when they exist."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall time per named stage.

    >>> t = StageTimer()
    >>> with t.stage("detect") as s:
    ...     s["result"] = detect_fn(...)   # synced on exit: device time,
    >>> t.report()                         # not just dispatch time
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, sync_result: bool = True):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if sync_result and "result" in holder:
                sync(holder["result"])
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.items[name] += items

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, total in self.totals.items():
            n = self.counts[name]
            entry = {"total_s": round(total, 4), "calls": n,
                     "ms_per_call": round(total / n * 1000, 3)}
            if self.items[name]:
                entry["items_per_s"] = round(self.items[name] / total, 2)
            out[name] = entry
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.items.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over a region (the CPU, and the card where there is
    one), its Chrome trace written to ``<log_dir>/trace.json``; yields the
    profiler. A no-op yielding None when ``log_dir`` is None, so call sites
    can leave the hook in place."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region on the profiler timeline."""
    return torch.profiler.record_function(name)

"""``torch.profiler`` traces and device waits.

- ``trace()``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (viewable in Perfetto or chrome://tracing);
- ``sync()``: wait for the device work behind a tree of tensors.

Named ranges and host spans are the port's tracer's (``stages.py``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, Optional

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


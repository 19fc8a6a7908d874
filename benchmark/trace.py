"""The device's side of a traced slice: ``torch.profiler`` over a short
stretch of the cell's own traffic, read from the profiler's raw events.

- Busy time: the union of the intervals of the device's own events
  (kernels, copies, sets), as the repository's ``chip_smoke.device_busy``
  takes it; the runtime's "Command Buffer Full" waits and annotations are
  not work.
- Device ops: the device events summed by name (``tools/trace_ops.py``'s
  ``summarize_trace``, here on the events in memory).
- Idle gaps: every stretch between busy intervals, named after the
  innermost host event (an operator, a runtime call or one of the
  benchmark's own spans) running at its middle, and summed by that name.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np

TOP = 10
LABELLED_GAPS = 400


def is_device_work(e, cuda) -> bool:
    return (e.device_type() == cuda and not e.is_user_annotation()
            and not e.name().startswith("Command Buffer"))


def traced(torch, fn: Callable[[], None], device) -> Dict:
    """Run ``fn`` under the profiler, the card synchronised at both ends;
    returns the slice's summary (see ``summarize``). On the CPU the slice
    holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    card = device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    return summarize(events, window, torch.autograd.DeviceType.CUDA)


def merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events, window_s: float, cuda) -> Dict:
    """{"busy_s", "window_s", "ops": {name: (seconds, count)},
    "device_ops": top [name, s], "idle_gaps": top [host activity, s]}."""
    dev = [e for e in events if is_device_work(e, cuda)]
    ops: Dict[str, List[float]] = {}
    for e in dev:
        rec = ops.setdefault(e.name(), [0.0, 0])
        rec[0] += e.duration_ns() / 1e9
        rec[1] += 1
    busy = merge([(e.start_ns(), e.end_ns()) for e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    host = [e for e in events if e.device_type() != cuda]
    return {"busy_s": busy_s, "window_s": window_s,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "device_ops": [[k, v[0]] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1][0])[:TOP]],
            "idle_gaps": gap_labels(gaps, host)}


def gap_labels(gaps: List[Tuple[int, int]], host) -> List[List]:
    """The idle time between device intervals summed by what the host was
    doing at each gap's middle (the innermost host event there); the
    shortest gaps past ``LABELLED_GAPS`` are summed as one entry."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    starts = np.array([e.start_ns() for e in host], dtype=np.int64)
    ends = np.array([e.end_ns() for e in host], dtype=np.int64)
    names = [e.name() for e in host]
    by: Dict[str, float] = {}
    for s, e in gaps[:LABELLED_GAPS]:
        mid = (s + e) // 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(inside):
            name = names[inside[np.argmin(ends[inside] - starts[inside])]]
        else:
            name = "(no host event)"
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    rest = sum(e - s for s, e in gaps[LABELLED_GAPS:]) / 1e9
    if rest:
        by[f"(the {len(gaps) - LABELLED_GAPS} shorter gaps)"] = rest
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_time(summary: Dict, name_part: str) -> Tuple[float, int]:
    """Seconds and launches of the device ops whose name holds
    ``name_part``."""
    s, n = 0.0, 0
    for name, (sec, cnt) in summary["ops"].items():
        if name_part in name:
            s += sec
            n += cnt
    return s, n

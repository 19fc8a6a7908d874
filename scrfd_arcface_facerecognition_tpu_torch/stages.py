"""The port's tracer: named pipeline stages, host spans and their recorder.

Stages. The pipeline wraps each of its stages in ``stage(name)``. A hook
set with ``set_stage_hook`` (a callable taking the stage name and
returning a context manager) sees every stage, for example to time it
with CUDA events.

Stage names, in the order the main path runs them: ``letterbox``,
``scrfd``, ``decode_nms``, ``align_warp``, ``arcface``, ``match``. The
gallery's (``GALLERY_STAGES``): the dense -> PQ migration with its codec
training and encoding, then the PQ search's LUT, ADC (kernel K2), masked
top-k and host rerank. The migration stages include host work, so a hook
that times them should synchronize the device when a stage ends.

Spans. ``span(name)`` marks host-side work: ``stream.dispatch``,
``stream.count_wait`` and ``stream.finish`` (``FacePipeline``),
``pq.search`` and ``pq.readback`` (``PQGallery.search``), the trainers'
``arcface_train.*`` and ``scrfd_train.*``. ``interval(name, t0, t1)``
records one whose ends lie apart, such as across a generator's yields,
from two ``now()`` stamps: ``stream.queued`` runs from the end of a
batch's dispatch to the start of its finish, while ``process_stream``
holds it in ``pending``.

The recorder. ``enable()`` starts a process-wide recorder, ``disable()``
stops it, ``reset()`` empties it; ``report()`` gives ``{name: {"ms": host
ms summed, "n": count}}`` and ``recorded()`` every ``(name, start_ns,
end_ns)``. While it is on, every ``stage`` and ``span`` records its host
interval and opens ``torch.profiler.record_function(name)``, so a
profiled stretch carries the program's names; the hook still sees the
stages as before. Stamps are on the profiler's clock (Unix epoch ns, as
kineto stamps its events): ``perf_counter_ns`` plus an offset taken at
``enable()`` and ``reset()``. What started before then is not recorded.
Off, ``stage`` and ``span`` check a module global and return one shared
null context: no allocation, no torch call.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

STAGES = ("letterbox", "scrfd", "decode_nms", "align_warp", "arcface",
          "match")
GALLERY_STAGES = ("pq_migrate", "pq_train", "pq_encode", "pq_lut", "pq_adc",
                  "pq_topk", "pq_rerank")

_NULL = contextlib.nullcontext()
_hook: Optional[Callable[[str], ContextManager]] = None
_on = False
_offset = time.time_ns() - time.perf_counter_ns()
_start = 0
_spans: List[Tuple[str, int, int]] = []
_record_function = None


def set_stage_hook(hook: Optional[Callable[[str], ContextManager]]) -> None:
    global _hook
    _hook = hook


def stage(name: str) -> ContextManager:
    if _on:
        return _Span(name, _hook)
    return _NULL if _hook is None else _hook(name)


def span(name: str) -> ContextManager:
    return _Span(name, None) if _on else _NULL


def now() -> int:
    """A stamp for ``interval``, on the profiler's clock."""
    return time.perf_counter_ns() + _offset


def interval(name: str, t0: int, t1: int) -> None:
    if _on and t0 >= _start:
        _spans.append((name, t0, t1))


def enable() -> None:
    global _on, _record_function
    from torch.profiler import record_function

    _record_function = record_function
    reset()
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    global _offset, _start
    _offset = time.time_ns() - time.perf_counter_ns()
    _start = now()
    _spans.clear()


def recorded() -> List[Tuple[str, int, int]]:
    return list(_spans)


def report() -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for name, t0, t1 in _spans:
        rec = out.setdefault(name, {"ms": 0.0, "n": 0})
        rec["ms"] += (t1 - t0) / 1e6
        rec["n"] += 1
    return out


class _Span:
    """A recorded stage or span: the host interval outermost, then the
    profiler's range, then the hook's context, if any."""

    __slots__ = ("name", "hook", "inner", "range", "t0")

    def __init__(self, name: str, hook):
        self.name = name
        self.hook = hook

    def __enter__(self):
        self.t0 = now()
        self.range = _record_function(self.name)
        self.range.__enter__()
        self.inner = None
        if self.hook is not None:
            self.inner = self.hook(self.name)
            self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            return (self.inner is not None
                    and bool(self.inner.__exit__(*exc)))
        finally:
            self.range.__exit__(*exc)
            interval(self.name, self.t0, now())

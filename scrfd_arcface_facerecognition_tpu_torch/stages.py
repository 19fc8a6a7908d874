"""Named pipeline stages, for per-stage timing.

The pipeline wraps each of its stages in ``stage(name)``. With no hook set
that is a no-op; a hook (a callable taking the stage name and returning a
context manager) can time the stages, for example with CUDA events.

Stage names, in the order the main path runs them: ``letterbox``,
``scrfd``, ``decode_nms``, ``align_warp``, ``arcface``, ``match``. The
gallery's (``GALLERY_STAGES``): the dense -> PQ migration with its codec
training and encoding, then the PQ search's LUT, ADC (kernel K2), masked
top-k and host rerank. The migration stages include host work, so a hook
that times them should synchronize the device when a stage ends.
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Optional

STAGES = ("letterbox", "scrfd", "decode_nms", "align_warp", "arcface",
          "match")
GALLERY_STAGES = ("pq_migrate", "pq_train", "pq_encode", "pq_lut", "pq_adc",
                  "pq_topk", "pq_rerank")

_hook: Optional[Callable[[str], ContextManager]] = None


def set_stage_hook(hook: Optional[Callable[[str], ContextManager]]) -> None:
    global _hook
    _hook = hook


def stage(name: str) -> ContextManager:
    return contextlib.nullcontext() if _hook is None else _hook(name)

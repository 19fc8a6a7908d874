"""Learning-rate schedules for the trainer: step -> learning rate.

arcface_torch trains w600k with linear warmup then polynomial decay
(power 2); cosine decay is the other common shape. ``make_lr_schedule``
builds either as a plain function of the step, with the numbers of the
optax schedules the JAX package joins (``optax.linear_schedule``,
``polynomial_schedule``, ``cosine_decay_schedule``, ``join_schedules``),
computed in float32 as there.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

_F = np.float32


def _poly(init: float, end: float, power: float, steps: int
          ) -> Callable[[int], float]:
    if steps <= 0:
        return lambda step: float(_F(init))

    def schedule(step: int) -> float:
        count = _F(min(max(step, 0), steps))
        frac = _F(1) - count / _F(steps)
        return float((_F(init) - _F(end)) * frac ** _F(power) + _F(end))
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    if not steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{steps}")

    def schedule(step: int) -> float:
        count = _F(min(step, steps))
        decay = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * count / _F(steps)))
        return float(_F(init) * ((_F(1) - _F(alpha)) * decay + _F(alpha)))
    return schedule


def make_lr_schedule(peak_lr: float, warmup_steps: int = 0,
                     decay_steps: Optional[int] = None, decay: str = "poly",
                     end_lr: float = 0.0, power: float = 2.0
                     ) -> Union[float, Callable[[int], float]]:
    """A constant float when nothing is requested; else step -> lr.

    warmup_steps: linear 0 -> peak_lr over this many steps.
    decay_steps: anneal peak_lr -> end_lr over this many steps after the
    warmup ("poly" with ``power``, or "cosine"). None holds peak_lr after
    the warmup. The parts join at ``warmup_steps``.
    """
    if not warmup_steps and decay_steps is None:
        return peak_lr
    parts = []
    if warmup_steps:
        parts.append(_poly(0.0, peak_lr, 1, warmup_steps))
    if decay_steps is not None:
        if decay == "cosine":
            alpha = (end_lr / peak_lr) if peak_lr else 0.0
            parts.append(_cosine(peak_lr, decay_steps, alpha))
        elif decay == "poly":
            parts.append(_poly(peak_lr, end_lr, power, decay_steps))
        else:
            raise ValueError(f"decay must be 'poly' or 'cosine', got "
                             f"{decay!r}")
    else:
        parts.append(lambda step: float(_F(peak_lr)))
    if len(parts) == 1:
        return parts[0]
    warm, after = parts

    def schedule(step: int) -> float:
        return warm(step) if step < warmup_steps else after(
            step - warmup_steps)
    return schedule

"""Operations and bytes the work needs, from shapes, and the card's peaks.

Counted on the reference's side, so the counts hold whatever implements
the work: the models' FLOPs with ``FlopCounterMode`` on the frozen
reference modules on the ``meta`` device (2 a multiply-add), K1's bytes
from the crops' geometry (each distinct source byte the crops touch read
once, the float32 crops written once, the matrices and indices read), K2's
from its shapes (the codes and the table read once, the scores written
once).
"""
from __future__ import annotations

from typing import Tuple

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# K1: per output pixel its coordinates, four weights, twelve taps and the
# input scaling
WARP_FLOPS_PER_PIXEL = 60


def model_flops(spec: dict, input_chw: Tuple[int, int, int]) -> float:
    """The FLOPs of one forward of the configured reference module on one
    (C, H, W) input."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.standins import architecture

    with torch.device("meta"):
        model = architecture(spec).eval().requires_grad_(False)
        x = torch.empty((1, *input_chw))
    with FlopCounterMode(display=False) as fc:
        model(x)
    return float(fc.get_total_flops())


def k1_bound(frames_bhw: Tuple[int, int, int], minv: torch.Tensor,
             frame_idx: torch.Tensor, launched: int,
             out_hw: Tuple[int, int] = (112, 112)) -> Tuple[float, str]:
    """K1's least time in seconds for one launch over ``launched`` crops,
    of which ``minv`` (F, 2, 3) dst -> src and ``frame_idx`` (F,) are the
    valid ones: the bytes (distinct source bytes of the valid crops'
    taps, every launched crop written, its matrix and index read) at the
    HBM rate, or the arithmetic at the float32 rate, whichever is longer;
    and which of the two bounds it."""
    b, h, w = frames_bhw
    oh, ow = out_hw
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32,
                                         device=minv.device),
                            torch.arange(ow, dtype=torch.float32,
                                         device=minv.device), indexing="ij")
    sx = (minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy
          + minv[:, 0, 2, None, None])
    sy = (minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy
          + minv[:, 1, 2, None, None])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    base = frame_idx.long()[:, None, None] * h
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            xt, yt = x0 + dx, y0 + dy
            inside = (xt >= 0) & (xt <= w - 1) & (yt >= 0) & (yt <= h - 1)
            lin = (base + torch.where(inside, yt, 0).long()) * w \
                + torch.where(inside, xt, 0).long()
            taps.append(lin[inside])
    distinct = int(torch.unique(torch.cat(taps)).numel())
    nbytes = distinct * 3 + launched * (3 * oh * ow * 4 + 6 * 4 + 4)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = launched * oh * ow * WARP_FLOPS_PER_PIXEL / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_bound(q: int, m: int, k: int, g: int,
             precision: str) -> Tuple[float, str]:
    """K2's least time in seconds for one (Q, G) scoring: code bytes, the
    table (2 bytes an entry in "hi"), the f32 scores once at the HBM
    rate; or Q*G*M adds at the float32 rate."""
    nbytes = g * m + q * m * k * (2 if precision == "hi" else 4) + q * g * 4
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = q * g * m / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lookup_bound(q: int, d: int, m: int, k: int, g: int) -> float:
    """A whole lookup's least time in seconds: the tables (2 Q D K flops)
    and the Q*G*M adds at the float32 rate, or the codes read once at the
    HBM rate (the scores need not leave the chip), whichever is longer."""
    t_ops = (2 * q * d * k + q * g * m) / PEAK_F32_FLOPS
    t_bytes = (g * m + q * d * 4) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes)

"""Per-crop scalars of the pass-decomposed face warp (kernel K3's inputs).

Counterpart of the geometry half of the JAX package's Pallas warp module
(``ops/pallas_warp.py``: its constants, ``WarpParams``,
``prepare_warp_params`` and ``planarize``). That module also holds the TPU
kernel, so the port keeps its own copy of what the band-mix warp
(``tools/exp_warp2.py``) needs.

The warp is split as Scale(sigma) . ShearX(u) . ShearY(v) . ShearX(u)
(Paeth), u = -tan(phi/2), v = sin(phi), resampled on a Q x Q working
canvas. A crop whose rotation or scale lies outside the passes' envelope
(|sin phi| > PHI_MAX, sigma > SIGMA_MAX or cos phi <= 0) is flagged
``fallback``; a face too large for the full frame's window is taken from
the letterbox canvas (pyramid level 1).

``prepare_warp_params`` repeats the reference's float32 operations in the
same order, so both packages give equal integers and float32 scalars.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .warp import invert_affine

OUT = 112            # output crop side
Q = 192              # working canvas side
PW = 512             # source x-window width (lanes), a multiple of 128
R = 384              # scale-pass source row window of the reference kernel
CQ = (Q - 1) / 2.0   # canvas center
C0 = (OUT - 1) / 2.0  # crop center (55.5)
LANE_OFF = int(CQ - C0 + 0.5)  # 40: final lane extraction offset
SRC_MIN_H = 32       # minimum level-0 frame height
PHI_MAX = 0.24       # |sin phi| bound of the shear passes (~13.9 deg)
# x: mx + sigma * CQ <= PW with mx < 320; y: 2 * sigma * CQ + 19 <= R
SIGMA_MAX = min((PW - 320) / CQ, (R - 19) / (2 * CQ))


class WarpParams(NamedTuple):
    iparams: torch.Tensor   # (F, 8) int32: frame, level, 0, ox, 0...
    fparams: torch.Tensor   # (F, 8) f32: sigma, u, v, my, mx, 0...
    fallback: torch.Tensor  # (F,) bool: the crop exceeds the envelope
    order: torch.Tensor     # (F,) int32: crops sorted by (frame, level)


def _f32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float -> integer the way XLA converts: saturating, NaN to 0 (a plain
    cast of NaN or an out-of-range value is undefined)."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 40, 2.0 ** 40).to(
        torch.int64)


def prepare_warp_params(matrices: torch.Tensor, frame_idx: torch.Tensor,
                        frame_hw: Tuple[int, int], det_scale: float,
                        canvas_hw: Tuple[int, int] = (640, 640)
                        ) -> WarpParams:
    """(F, 2, 3) src -> dst umeyama matrices and (F,) frame indices ->
    the kernel's per-crop scalars, on the matrices' device.

    Level 0 samples the full frame (it must be at least PW wide and
    SRC_MIN_H tall), level 1 the letterbox canvas at ``det_scale``. ``ox``
    is the 128-aligned origin of the PW-lane window, rounded to the nearest
    128 and clamped against the lane-padded source width.
    """
    minv = invert_affine(matrices.to(torch.float32))         # dst -> src
    a = minv[:, 0, 0]
    c = minv[:, 1, 0]
    sigma0 = torch.sqrt(a * a + c * c)
    cos_phi = a / torch.clamp_min(sigma0, 1e-12)
    sin_phi = c / torch.clamp_min(sigma0, 1e-12)
    u = -sin_phi / torch.clamp_min(1.0 + cos_phi, 1e-6)
    v = sin_phi

    # the crop center in source coordinates
    cx = minv[:, 0, 0] * C0 + minv[:, 0, 1] * C0 + minv[:, 0, 2]
    cy = minv[:, 1, 0] * C0 + minv[:, 1, 1] * C0 + minv[:, 1, 2]

    fh, fw = frame_hw
    ch, cw = canvas_hw
    frame_ok = fw >= PW and fh >= SRC_MIN_H
    level = torch.where((sigma0 <= SIGMA_MAX) & frame_ok, 0, 1).to(torch.int32)
    lam = torch.where(level == 0, 1.0, det_scale).to(torch.float32)
    sigma = sigma0 * lam
    cxl = cx * lam
    cyl = cy * lam
    src_w = torch.where(level == 0, fw, cw)

    fallback = (v.abs() > PHI_MAX) | (sigma > SIGMA_MAX) | (cos_phi <= 0.0)

    padded_w = ((src_w + 127) // 128) * 128
    ox = torch.clamp(_f32_to_i64(torch.div(cxl - PW / 2 + 64, 128,
                                           rounding_mode="floor")) * 128,
                     min=0)
    ox = torch.minimum(ox, torch.clamp_min(padded_w - PW, 0)).to(torch.int32)
    my = cyl
    mx = cxl - ox.to(torch.float32)

    f = matrices.shape[0]
    izero = torch.zeros((f,), dtype=torch.int32, device=matrices.device)
    fzero = torch.zeros((f,), dtype=torch.float32, device=matrices.device)
    iparams = torch.stack([frame_idx.to(torch.int32), level, izero, ox,
                           izero, izero, izero, izero], dim=1)
    fparams = torch.stack([sigma, u, v, my, mx, fzero, fzero, fzero], dim=1)
    order = torch.argsort(frame_idx.to(torch.int64) * 2 + level,
                          stable=True).to(torch.int32)
    return WarpParams(iparams=iparams, fparams=fparams, fallback=fallback,
                      order=order)


def planarize(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 3, H, W), contiguous (the kernel's layout)."""
    return frames.permute(0, 3, 1, 2).contiguous()

"""Affine warp with cv2.warpAffine semantics for 112x112 face alignment.

cv2.warpAffine(image, M, (112, 112), borderValue=0) with INTER_LINEAR and
the inverse-map convention: M maps src -> dst, and each dst pixel samples
src = M^-1 @ (x, y, 1) bilinearly, zero outside the source image.

``warp_affine_inv_flat`` is the plain PyTorch form of the face-crop warp;
the hand-written kernel (``ops/warp_align.py``) computes the same
function, and on the CPU its wrapper runs this code.
"""
from __future__ import annotations

from typing import Tuple

import torch


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices (a zero determinant gives
    non-finite entries, as in the reference)."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    inv_det = 1.0 / det
    ia = d * inv_det
    ib = -b * inv_det
    ic = -c * inv_det
    id_ = a * inv_det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def warp_affine_inv_flat(frames: torch.Tensor, minv: torch.Tensor,
                         frame_idx: torch.Tensor,
                         out_hw: Tuple[int, int] = (112, 112)) -> torch.Tensor:
    """F crops out of a frame batch, given dst -> src matrices.

    frames (B, H, W, C) uint8 or float; minv (F, 2, 3) dst -> src;
    frame_idx (F,). Returns (F, h, w, C) float32.

    Each tap's inside mask is decided on the float coordinate before any
    cast, so NaN or huge coordinates never reach an integer conversion:
    an outside tap contributes value * (weight * 0), which is 0 for a
    finite weight and NaN for a NaN weight, as in the reference. A crop
    whose frame_idx lies outside [0, B) has every tap outside (it samples
    the zero border), as the kernel of ``ops/warp_align.py`` does; the
    reference's gather instead wraps a negative index and fills NaN past B.
    """
    b, h, w, c = frames.shape
    oh, ow = out_hw
    dev = frames.device
    minv = minv.to(torch.float32)
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    # operand order of the reference: (m0 * gx + m1 * gy) + m2
    sx = (minv[:, 0, 0, None, None] * gx + minv[:, 0, 1, None, None] * gy
          + minv[:, 0, 2, None, None])
    sy = (minv[:, 1, 0, None, None] * gx + minv[:, 1, 1, None, None] * gy
          + minv[:, 1, 2, None, None])
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    flat = frames.reshape(b * h * w, c).to(torch.float32)
    fi = frame_idx.to(torch.int64)
    ok = (fi >= 0) & (fi < b)
    base = (torch.where(ok, fi, 0) * h)[:, None, None]
    frame_ok = ok[:, None, None]

    def tap(yt, xt, wgt):
        inside = frame_ok & (xt >= 0) & (xt <= w - 1) & (yt >= 0) & (
            yt <= h - 1)
        zero = torch.zeros_like(xt)
        xi = torch.where(inside, xt, zero).to(torch.int64)
        yi = torch.where(inside, yt, zero).to(torch.int64)
        vals = flat[(base + yi) * w + xi]                 # (F, oh, ow, C)
        return vals * (wgt * inside.to(torch.float32))[..., None]

    return (tap(y0, x0, (1 - fx) * (1 - fy))
            + tap(y0, x0 + 1, fx * (1 - fy))
            + tap(y0 + 1, x0, (1 - fx) * fy)
            + tap(y0 + 1, x0 + 1, fx * fy))


def warp_affine_flat(frames: torch.Tensor, ms: torch.Tensor,
                     frame_idx: torch.Tensor,
                     out_hw: Tuple[int, int] = (112, 112)) -> torch.Tensor:
    """F crops out of a frame batch, given src -> dst matrices ms (F, 2, 3)."""
    return warp_affine_inv_flat(frames, invert_affine(ms.to(torch.float32)),
                                frame_idx, out_hw)

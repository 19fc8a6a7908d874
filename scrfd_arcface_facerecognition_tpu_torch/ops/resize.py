"""Bilinear resize + letterbox with cv2.resize(INTER_LINEAR) semantics.

cv2's INTER_LINEAR samples at half-pixel centers with edge clamping:

    src_x = (dst_x + 0.5) * (src_w / dst_w) - 0.5

The separable interpolation is two dense matrices Wy (new_h, H) and
Wx (new_w, W) with two non-zeros per row, so the resize is a pair of
matrix products over the batch (left to cuBLAS, as the JAX package left it
to XLA). The matrices are built on the host once per shape pair and cached
per device.

``resize_bilinear_u8_exact`` reproduces cv2's integer u8 pipeline bit for
bit (11-bit coefficients, the vertical descale, the 2x-down INTER_AREA
reroute); ``letterbox(exact_u8=True)`` takes it. ``letterbox_matrices`` /
``letterbox_dynamic`` carry each image's letterbox geometry as data, so
images of different shapes padded into one bucket get the canvas that
exact-shape letterboxing gives them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..device import full_f32_matmul


@functools.lru_cache(maxsize=64)
def _interp_matrix(dst_size: int, src_size: int) -> np.ndarray:
    """(dst, src) row-stochastic bilinear interpolation matrix, cv2 semantics."""
    w = np.zeros((dst_size, src_size), dtype=np.float32)
    if dst_size == src_size:
        np.fill_diagonal(w, 1.0)
        return w
    scale = src_size / dst_size
    for d in range(dst_size):
        sx = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        frac = sx - x0
        x0c = min(max(x0, 0), src_size - 1)
        x1c = min(max(x0 + 1, 0), src_size - 1)
        w[d, x0c] += 1.0 - frac
        w[d, x1c] += frac
    return w


@functools.lru_cache(maxsize=64)
def _interp_matrix_on(dst_size: int, src_size: int, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix(dst_size, src_size)).to(
        device=device, dtype=dtype)


def resize_bilinear(images: torch.Tensor, out_hw: Tuple[int, int],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) float32, cv2 INTER_LINEAR semantics.

    ``dtype`` is the two products' compute dtype: float32 for cv2 parity;
    bfloat16 when the detector computes in it, as the JAX package's
    letterbox does (at most one intensity step on the canvas).
    """
    h_in, w_in = images.shape[-3], images.shape[-2]
    h_out, w_out = out_hw
    wy = _interp_matrix_on(h_out, h_in, images.device, dtype)
    wx = _interp_matrix_on(w_out, w_in, images.device, dtype)
    x = images.to(dtype)
    x = torch.einsum("oh,...hwc->...owc", wy, x)
    return torch.einsum("pw,...owc->...opc", wx, x).to(torch.float32)


# ----------------------------------------------------------------------
# Exact cv2 uint8 fixed-point path
# ----------------------------------------------------------------------

_COEF_BITS = 11                       # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS         # 2048


@functools.lru_cache(maxsize=64)
def _fixed_taps(dst_size: int, src_size: int, horizontal: bool):
    """cv2 u8 resize taps: (idx0, idx1, a0, a1) int arrays of length dst.

    cv2's coefficient setup: half-pixel mapping in float32, floor, then
    ``saturate_cast<short>(coef * 2048)`` with round-half-to-even
    (``np.rint``). The horizontal taps clamp the coefficient at the
    borders (sx < 0 -> fx = 0; sx >= w - 1 -> fx = 0, sx = w - 1); the
    vertical pass only clips the row index and keeps the fraction, so
    border rows mix the replicated row with split coefficients.
    """
    scale = src_size / dst_size
    idx0 = np.zeros(dst_size, np.int32)
    idx1 = np.zeros(dst_size, np.int32)
    a0 = np.zeros(dst_size, np.int32)
    a1 = np.zeros(dst_size, np.int32)
    one = np.float32(1.0)
    coef = np.float32(_COEF_SCALE)
    for d in range(dst_size):
        # float32 from this cast on, as cv2 computes it
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = int(np.floor(fx))
        fx = np.float32(fx - sx)
        if horizontal:
            if sx < 0:
                fx, sx = np.float32(0.0), 0
            if sx >= src_size - 1:
                fx, sx = np.float32(0.0), src_size - 1
            idx0[d] = sx
            idx1[d] = min(sx + 1, src_size - 1)
        else:
            idx0[d] = min(max(sx, 0), src_size - 1)
            idx1[d] = min(max(sx + 1, 0), src_size - 1)
        a0[d] = int(np.rint((one - fx) * coef))
        a1[d] = int(np.rint(fx * coef))
    return idx0, idx1, a0, a1


def resize_bilinear_u8_exact(images: torch.Tensor,
                             out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., h, w, C) uint8, bit-exact to
    cv2.resize(INTER_LINEAR) on uint8 inputs.

    The horizontal pass accumulates src * short_coef in int32; the
    vertical pass computes
    ``uchar(((b0 * (H0 >> 4)) >> 16) + ((b1 * (H1 >> 4)) >> 16) + 2) >> 2``.
    Both run in int32 here (the horizontal sums fit: 255 * 2048 * 2).
    """
    if images.dtype != torch.uint8:
        raise ValueError(f"exact u8 resize needs uint8 input, got "
                         f"{images.dtype}")
    h_in, w_in = images.shape[-3], images.shape[-2]
    h_out, w_out = out_hw
    x = images.to(torch.int32)
    if h_in == 2 * h_out and w_in == 2 * w_out:
        # cv2 reroutes an exact 2x-down INTER_LINEAR to its INTER_AREA
        # fast path: dst = (s00 + s01 + s10 + s11 + 2) >> 2
        s = (x[..., 0::2, 0::2, :] + x[..., 0::2, 1::2, :]
             + x[..., 1::2, 0::2, :] + x[..., 1::2, 1::2, :])
        return ((s + 2) >> 2).to(torch.uint8)
    dev = images.device

    def taps(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    xi0, xi1, xa0, xa1 = taps(*_fixed_taps(w_out, w_in, True))
    yi0, yi1, yb0, yb1 = taps(*_fixed_taps(h_out, h_in, False))
    cshape = (-1, 1)                                   # (w_out, C)
    hrows = (x.index_select(-2, xi0) * xa0.reshape(cshape)
             + x.index_select(-2, xi1) * xa1.reshape(cshape)) >> 4
    rshape = (-1, 1, 1)                                # (h_out, w, C)
    acc = (((hrows.index_select(-3, yi0) * yb0.reshape(rshape)) >> 16)
           + ((hrows.index_select(-3, yi1) * yb1.reshape(rshape)) >> 16))
    return ((acc + 2) >> 2).clamp(0, 255).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class LetterboxPlan:
    """Static letterbox geometry for a (frame, model) shape pair: an
    aspect-preserving resize to ``new_hw`` anchored at the top-left of a
    zero ``model_hw`` canvas."""
    frame_hw: Tuple[int, int]
    model_hw: Tuple[int, int]
    new_hw: Tuple[int, int]
    det_scale: float


def letterbox_plan(frame_hw: Tuple[int, int],
                   model_hw: Tuple[int, int] = (640, 640)) -> LetterboxPlan:
    fh, fw = frame_hw
    mh, mw = model_hw
    im_ratio = fh / fw
    model_ratio = mh / mw
    if im_ratio > model_ratio:
        new_h = mh
        new_w = int(new_h / im_ratio)
    else:
        new_w = mw
        new_h = int(new_w * im_ratio)
    det_scale = float(new_h) / fh
    return LetterboxPlan(frame_hw=(fh, fw), model_hw=(mh, mw),
                         new_hw=(new_h, new_w), det_scale=det_scale)


def tight_letterbox_plan(frame_hw: Tuple[int, int],
                         model_hw: Tuple[int, int] = (640, 640),
                         multiple: int = 64,
                         min_hw: Tuple[int, int] = (64, 512)) -> LetterboxPlan:
    """Letterbox plan whose canvas trims the all-zero pad band to the next
    ``multiple`` (1080p -> (384, 640) instead of (640, 640)).

    Same det_scale and resized content as the square canvas; SCRFD is
    fully convolutional, so the trim only stops convolving pad. The
    ``min_hw`` floor is kept exactly as the JAX package has it (there it
    serves its TPU warp kernel's window) so that plans, and therefore
    detections, agree with the reference.
    """
    full = letterbox_plan(frame_hw, model_hw)
    nh, nw = full.new_hw
    mh = min(full.model_hw[0], max(min_hw[0], -(-nh // multiple) * multiple))
    mw = min(full.model_hw[1], max(min_hw[1], -(-nw // multiple) * multiple))
    return LetterboxPlan(frame_hw=full.frame_hw, model_hw=(mh, mw),
                         new_hw=full.new_hw, det_scale=full.det_scale)


def letterbox_matrices(frame_hw: Tuple[int, int],
                       padded_hw: Tuple[int, int],
                       model_hw: Tuple[int, int] = (640, 640)):
    """Per-image letterbox matrices for batches of mixed shapes.

    Returns (wy (model_h, padded_h), wx (model_w, padded_w), det_scale)
    as numpy f32: the taps come from the ORIGINAL ``frame_hw``, rows past
    the resized content are zero (the letterbox pad) and columns past the
    content are never tapped, so applied to the image zero-padded to
    ``padded_hw`` they give the canvas that exact-shape letterboxing of the
    image gives (the added terms are exact zeros).
    """
    plan = letterbox_plan(frame_hw, model_hw)
    nh, nw = plan.new_hw
    fh, fw = frame_hw
    ph, pw = padded_hw
    mh, mw = model_hw
    if ph < fh or pw < fw:
        raise ValueError(f"padded {padded_hw} smaller than frame {frame_hw}")
    wy = np.zeros((mh, ph), np.float32)
    wy[:nh, :fh] = _interp_matrix(nh, fh)
    wx = np.zeros((mw, pw), np.float32)
    wx[:nw, :fw] = _interp_matrix(nw, fw)
    return wy, wx, plan.det_scale


def letterbox_dynamic(frames: torch.Tensor, wy: torch.Tensor,
                      wx: torch.Tensor) -> torch.Tensor:
    """(B, Hp, Wp, C) frames + per-image matrices -> (B, mh, mw, C) f32.

    wy (B, mh, Hp) and wx (B, mw, Wp) are ``letterbox_matrices`` stacked.
    The two batched products run in full f32 (no TF32), so the canvas
    stays within rounding of the exact-shape ``letterbox``.
    """
    x = frames.to(torch.float32)
    with full_f32_matmul():
        x = torch.einsum("boh,bhwc->bowc", wy, x)
        return torch.einsum("bpw,bowc->bopc", wx, x)


def letterbox(frames: torch.Tensor, plan: LetterboxPlan,
              exact_u8: bool = False,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) frames -> (..., model_h, model_w, C) float32 canvas,
    resized content at the top-left, zero padding. ``exact_u8=True`` sends
    uint8 frames through the bit-exact cv2 resize first; ``dtype`` is the
    resize's compute dtype (``resize_bilinear``)."""
    new_h, new_w = plan.new_hw
    mh, mw = plan.model_hw
    if exact_u8 and frames.dtype == torch.uint8:
        resized = resize_bilinear_u8_exact(
            frames, (new_h, new_w)).to(torch.float32)
    else:
        resized = resize_bilinear(frames, (new_h, new_w), dtype=dtype)
    # F.pad pads from the last dim backwards: (C, W, H)
    return torch.nn.functional.pad(resized,
                                   (0, 0, 0, mw - new_w, 0, mh - new_h))

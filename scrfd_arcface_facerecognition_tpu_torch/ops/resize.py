"""Bilinear resize + letterbox with cv2.resize(INTER_LINEAR) semantics.

cv2's INTER_LINEAR samples at half-pixel centers with edge clamping:

    src_x = (dst_x + 0.5) * (src_w / dst_w) - 0.5

The separable interpolation is two dense matrices Wy (new_h, H) and
Wx (new_w, W) with two non-zeros per row, so the resize is a pair of
matrix products over the batch (left to cuBLAS, as the JAX package left it
to XLA). The matrices are built on the host once per shape pair and cached
per device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


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
def _interp_matrix_on(dst_size: int, src_size: int,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix(dst_size, src_size)).to(device)


def resize_bilinear(images: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) float32, cv2 INTER_LINEAR semantics."""
    h_in, w_in = images.shape[-3], images.shape[-2]
    h_out, w_out = out_hw
    wy = _interp_matrix_on(h_out, h_in, images.device)
    wx = _interp_matrix_on(w_out, w_in, images.device)
    x = images.to(torch.float32)
    x = torch.einsum("oh,...hwc->...owc", wy, x)
    return torch.einsum("pw,...owc->...opc", wx, x)


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


def letterbox(frames: torch.Tensor, plan: LetterboxPlan) -> torch.Tensor:
    """(..., H, W, C) frames -> (..., model_h, model_w, C) float32 canvas,
    resized content at the top-left, zero padding."""
    new_h, new_w = plan.new_hw
    mh, mw = plan.model_hw
    resized = resize_bilinear(frames, (new_h, new_w))
    # F.pad pads from the last dim backwards: (C, W, H)
    return torch.nn.functional.pad(resized,
                                   (0, 0, 0, mw - new_w, 0, mh - new_h))

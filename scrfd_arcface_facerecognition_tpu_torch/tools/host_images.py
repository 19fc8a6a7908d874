"""cv2's resizes of the decision tools' compositing, in numpy.

The card's machine has no cv2, and ``tools.exp_decisions`` composites
every training and evaluation scene on the host with three cv2 calls.
These functions give cv2's bits (5.0, x86-64, IPP on, as it is by
default) without it:

- ``resize_area_u8``: ``cv2.resize(INTER_AREA)`` on uint8, on each of its
  three routes: an integer shrink factor takes the fast path (the 2 x 2
  mean ``(a + b + c + d + 2) >> 2``; other factors the block sum times
  ``1.f / area``, rounded half to even), any other shrink the general
  area path (per-axis cell weights in float32, a row's taps summed in
  source order, then the rows' weighted sum, rounded half to even), and
  an enlargement the two-tap fixed-point resize with cv2's area-mode
  taps (``e2e_oracle.linear_taps_u8``);
- ``resize_linear_f32``: ``cv2.resize(INTER_LINEAR)`` on a float32 image
  of 3 channels, enlarged. cv2 hands it to IPP, which interpolates each
  axis as ``fma(f, s1 - s0, s0)``, the columns first. Where the columns
  clamped to an edge pixel on one side number 5 to 15, it rounds the
  product and the sum of their channels 0 and 1 apart (no FMA) in the
  vertical pass. That rule gives cv2's bits on the maps ``make_scene``
  enlarges (scene // 16 to scene, every scene from 32 to 1024: about 16
  times); at other factors IPP treats the clamped columns otherwise and
  some of them differ;
- ``resize_linear_u8``: ``cv2.resize(INTER_LINEAR)`` on uint8, the
  replica's own (``e2e_oracle``).

JPEG decoding stays with cv2 (``imread``), imported when it is called.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from .e2e_oracle import fma_f32, linear_taps_u8, resize_linear_u8

__all__ = ["resize_area_u8", "resize_linear_f32", "resize_linear_u8",
           "imread", "imwrite"]

_DBL_EPSILON = np.finfo(np.float64).eps


def _cv2():
    try:
        import cv2
    except ImportError as e:       # the card's machine has none
        raise RuntimeError(
            "reading or writing a JPEG needs cv2, which is not installed "
            "here; pass the images in memory instead") from e
    return cv2


def imread(path: str):
    """``cv2.imread(path)``: a BGR uint8 image, or None."""
    return _cv2().imread(path)


def imwrite(path: str, image: np.ndarray) -> bool:
    return bool(_cv2().imwrite(path, image))


@functools.lru_cache(maxsize=512)
def _area_taps(src: int, dst: int):
    """cv2's ``computeResizeAreaTab`` along one axis as (dst, n) source
    indices and float32 weights, each row's taps in source order (the
    order cv2 sums them); unused slots weigh 0. Cached: the arrays are
    shared, read only."""
    scale = src / dst
    taps = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    n = max(len(r) for r in taps)
    idx = np.zeros((dst, n), np.int64)
    wgt = np.zeros((dst, n), np.float32)
    for d, row in enumerate(taps):
        for k, (s, a) in enumerate(row):
            idx[d, k], wgt[d, k] = s, np.float32(a)
    return idx, wgt


def _area_general(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2's ``ResizeArea_Invoker`` on (H, W, C) float32 values: a source
    row's taps summed per output column in float32, then the rows'
    ``beta * row`` summed per output row. A weight-0 slot adds an exact
    zero, so the padded slots leave every sum as cv2 forms it."""
    h, w = x.shape[:2]
    xi, xa = _area_taps(w, ow)
    yi, ya = _area_taps(h, oh)
    rows = np.zeros((h, ow, x.shape[2]), np.float32)
    for k in range(xi.shape[1]):
        rows += x[:, xi[:, k]] * xa[None, :, k, None]
    acc = np.zeros((oh, ow, x.shape[2]), np.float32)
    for k in range(yi.shape[1]):
        acc += ya[:, k, None, None] * rows[yi[:, k]]
    return np.rint(acc)


def resize_area_u8(image: np.ndarray, out_hw: Tuple[int, int]
                   ) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=INTER_AREA)`` on a uint8
    (H, W) or (H, W, C) image, bit for bit."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"resize_area_u8 needs uint8, got {image.dtype}")
    h, w = image.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image.copy()
    # cv2's scales are 1 / (dst / src), in double
    sx, sy = 1.0 / (ow / w), 1.0 / (oh / h)
    if sx < 1 or sy < 1:
        return linear_taps_u8(image, out_hw, area=True)
    ix, iy = int(round(sx)), int(round(sy))
    x = image.reshape(h, w, -1)
    if abs(sx - ix) < _DBL_EPSILON and abs(sy - iy) < _DBL_EPSILON:
        s = x[:oh * iy, :ow * ix].astype(np.int64).reshape(
            oh, iy, ow, ix, -1).sum(axis=(1, 3))
        if ix == 2 and iy == 2:
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32)
                          * np.float32(1.0 / (ix * iy)))
    else:
        out = _area_general(x.astype(np.float32), oh, ow)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (oh, ow) + image.shape[2:])


def _ipp_taps(dst: int, src: int):
    """The half-pixel map of one axis: (index0, index1, float32 fraction,
    clamped); a position left of the first or right of the last source
    centre takes the edge pixel (fraction 0)."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    clamped = (s < 0) | (s >= src - 1)
    frac = np.where(clamped, 0.0, f - s).astype(np.float32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), frac,
            clamped)


def resize_linear_f32(image: np.ndarray, out_hw: Tuple[int, int]
                      ) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=INTER_LINEAR)`` on a
    float32 (H, W, 3) image enlarged (or kept) on both axes, as cv2's IPP
    route computes it (bit for bit at about 16 times; see the module)."""
    x = np.asarray(image)
    if x.dtype != np.float32 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"resize_linear_f32 needs float32 (H, W, 3), got "
                         f"{x.dtype} {x.shape}")
    h, w = x.shape[:2]
    oh, ow = out_hw
    if oh < h or ow < w:
        raise ValueError(f"resize_linear_f32 enlarges: {(h, w)} -> "
                         f"{(oh, ow)}")
    xi0, xi1, fx, edge = _ipp_taps(ow, w)
    yi0, yi1, fy, _ = _ipp_taps(oh, h)
    rows = fma_f32(fx[:, None], x[:, xi1] - x[:, xi0], x[:, xi0])
    r0 = rows[yi0]
    d = rows[yi1] - r0
    fy = fy[:, None, None]
    out = fma_f32(fy, d, r0)
    for side in (edge & (np.arange(ow) < ow // 2),
                 edge & (np.arange(ow) >= ow // 2)):
        if 5 <= side.sum() <= 15:
            out[:, side, :2] = r0[:, side, :2] + fy * d[:, side, :2]
    return out

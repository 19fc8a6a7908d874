"""SCRFD anchor-center grids.

For each FPN stride s the anchor centers form an (H/s, W/s) grid of pixel
coordinates (x, y) = (col*s, row*s), repeated ``num_anchors`` times per
location and flattened row-major, matching the head's flattened output:

    index = (row * width + col) * num_anchors + anchor
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

SCRFD_STRIDES: Tuple[int, ...] = (8, 16, 32)
SCRFD_NUM_ANCHORS: int = 2


@functools.lru_cache(maxsize=128)
def _anchor_centers_np(height: int, width: int, stride: int,
                       num_anchors: int) -> np.ndarray:
    cols = np.arange(width, dtype=np.float32) * stride
    rows = np.arange(height, dtype=np.float32) * stride
    xs, ys = np.meshgrid(cols, rows)
    centers = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    return np.repeat(centers, num_anchors, axis=0)


@functools.lru_cache(maxsize=128)
def _anchor_centers_on(height: int, width: int, stride: int,
                       num_anchors: int, device: torch.device) -> torch.Tensor:
    # one upload per (grid, device): the detector reuses it every batch
    return torch.from_numpy(
        _anchor_centers_np(height, width, stride, num_anchors)).to(device)


def anchor_centers(height: int, width: int, stride: int,
                   num_anchors: int = SCRFD_NUM_ANCHORS,
                   device=None) -> torch.Tensor:
    """(H*W*A, 2) float32 anchor centers in input-image pixels, on
    ``device`` (None: the card)."""
    return _anchor_centers_on(height, width, stride, num_anchors,
                              resolve_device(device))


def scrfd_anchor_table(input_size: Tuple[int, int],
                       strides: Sequence[int] = SCRFD_STRIDES,
                       num_anchors: int = SCRFD_NUM_ANCHORS,
                       device=None) -> torch.Tensor:
    """Anchor centers of every stride at ``input_size`` (h, w), stride-8
    first (640x640 -> 16800 rows), on ``device`` (None: the card)."""
    h, w = input_size
    device = resolve_device(device)
    return torch.cat([anchor_centers(h // s, w // s, s, num_anchors, device)
                      for s in strides], dim=0)

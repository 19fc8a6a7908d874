"""Distance-to-box / distance-to-keypoint decoding, with leading batch dims."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """points (..., N, 2), (left, top, right, bottom) distances (..., N, 4)
    -> x1y1x2y2 boxes (..., N, 4)."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1])
        y1 = y1.clamp(0, max_shape[0])
        x2 = x2.clamp(0, max_shape[1])
        y2 = y2.clamp(0, max_shape[0])
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2kps(points: torch.Tensor, distance: torch.Tensor,
                 max_shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """points (..., N, 2), offsets (..., N, 2K) -> keypoints (..., N, K, 2)."""
    k = distance.shape[-1] // 2
    kps = points[..., None, :] + distance.reshape(distance.shape[:-1] + (k, 2))
    if max_shape is not None:
        kps = torch.stack([kps[..., 0].clamp(0, max_shape[1]),
                           kps[..., 1].clamp(0, max_shape[0])], dim=-1)
    return kps

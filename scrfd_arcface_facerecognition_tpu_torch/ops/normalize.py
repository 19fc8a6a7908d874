"""Image normalization with cv2.dnn.blobFromImage semantics, NHWC in and out.

SCRFD feeds (x - 127.5) / 128 and ArcFace (x - 127.5) / 127.5, both with
the BGR -> RGB swap folded in. The layout stays NHWC here, as in the JAX
package; the models permute to NCHW themselves.
"""
from __future__ import annotations

import torch

SCRFD_MEAN = 127.5
SCRFD_STD = 128.0
ARCFACE_MEAN = 127.5
ARCFACE_STD = 127.5


def normalize_image(image: torch.Tensor, mean: float, std: float,
                    swap_rb: bool = True) -> torch.Tensor:
    """(..., H, W, 3) uint8/float BGR -> normalized float32 RGB, NHWC."""
    x = image.to(torch.float32)
    if swap_rb:
        x = x.flip(-1)
    return (x - mean) * (1.0 / std)

"""Closed-form 5-point similarity alignment (the skimage Umeyama fit).

In 2D the rotation-constrained least-squares similarity has the closed form

    a = sum(src_c . dst_c) / sum(|src_c|^2)        (= s*cos(theta))
    b = sum(src_c x dst_c) / sum(|src_c|^2)        (= s*sin(theta))
    M = [[a, -b, tx], [b, a, ty]],  t = mu_dst - R_s @ mu_src

which equals the SVD solution, so the fit is a handful of elementwise ops
batched over every face.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Canonical ArcFace 112x112 landmark template.
ARCFACE_DST = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor,
                       eps: float = 1e-12) -> torch.Tensor:
    """Least-squares similarity src -> dst for (..., P, 2) point sets;
    returns (..., 2, 3) matrices M with dst ~= M[:, :2] @ src + M[:, 2].

    ``var_s`` is clamped to ``eps``, so degenerate landmarks give huge or
    non-finite matrices exactly as the reference does.
    """
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d

    var_s = sc.square().sum(dim=(-2, -1))
    dot = (sc * dc).sum(dim=(-2, -1))
    cross = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(dim=-1)

    inv = 1.0 / var_s.clamp_min(eps)
    a = dot * inv
    b = cross * inv

    mu_sx, mu_sy = mu_s[..., 0, 0], mu_s[..., 0, 1]
    mu_dx, mu_dy = mu_d[..., 0, 0], mu_d[..., 0, 1]
    tx = mu_dx - (a * mu_sx - b * mu_sy)
    ty = mu_dy - (b * mu_sx + a * mu_sy)

    row0 = torch.stack([a, -b, tx], dim=-1)
    row1 = torch.stack([b, a, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


@functools.lru_cache(maxsize=8)
def _template_on(device: torch.device) -> torch.Tensor:
    """The template on ``device``, copied there once: a copy from host
    memory on every call would make the stream wait for it."""
    return torch.as_tensor(ARCFACE_DST, device=device)


def estimate_norm(landmarks: torch.Tensor, image_size: int = 112
                  ) -> torch.Tensor:
    """(..., 5, 2) landmarks -> (..., 2, 3) alignment matrices onto the
    ArcFace template scaled by image_size/112."""
    dst = _template_on(landmarks.device) * (float(image_size) / 112.0)
    dst = dst.expand(landmarks.shape[:-2] + dst.shape)
    return umeyama_similarity(landmarks, dst)

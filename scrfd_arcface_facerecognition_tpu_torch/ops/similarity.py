"""Embedding normalization."""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    norm = x.to(torch.float32).square().sum(dim=dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps)).to(x.dtype)

"""Embedding similarity: L2-normalize, cosine, batched gallery matching.

Counterpart of the JAX package's ``ops/similarity.py``. Matching is one f32
matmul (``query @ gallery.T``) followed by a top-k whose order among equal
scores is ``lax.top_k``'s: lower index first (``stable_top_k``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .nms import stable_top_k


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    # float32 at least (float64 stays float64)
    wide = torch.promote_types(x.dtype, torch.float32)
    norm = x.to(wide).square().sum(dim=dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps)).to(x.dtype)


def compute_similarity(feat1: torch.Tensor, feat2: torch.Tensor
                       ) -> torch.Tensor:
    """Cosine similarity of two flat feature vectors."""
    f1 = feat1.reshape(-1).to(torch.float32)
    f2 = feat2.reshape(-1).to(torch.float32)
    denom = torch.linalg.vector_norm(f1) * torch.linalg.vector_norm(f2)
    return torch.dot(f1, f2) / denom.clamp_min(1e-12)


def cosine_matrix(queries: torch.Tensor, gallery: torch.Tensor,
                  normalized: bool = False) -> torch.Tensor:
    """(Q, D) x (G, D) -> (Q, G) cosine-similarity matrix, one matmul."""
    q = queries.to(torch.float32)
    g = gallery.to(torch.float32)
    if not normalized:
        q = l2_normalize(q)
        g = l2_normalize(g)
    return q @ g.T


def top_k_matches(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                  normalized: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery matches per query: (Q, k) scores and (Q, k) indices."""
    sims = cosine_matrix(queries, gallery, normalized=normalized)
    return stable_top_k(sims, min(k, sims.shape[-1]))

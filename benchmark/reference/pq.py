"""The plain reference's PQ search: asymmetric distance computation and
the k best rows, in float64.

score[q, g] = sum_m queries[q, m-th sub-vector] . centroids[m, codes[g, m]]

Imports torch only.
"""
from __future__ import annotations

import torch


def lut(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (M, K, S) -> (Q, M, K) float64 tables."""
    m, _, s = centroids.shape
    q = queries.double().reshape(-1, m, s)
    return torch.einsum("qms,mks->qmk", q, centroids.double())


def scores(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) tables x (G, M) u8 codes -> (Q, G) float64."""
    acc = torch.zeros((table.shape[0], codes.shape[0]), dtype=torch.float64,
                      device=table.device)
    for j in range(table.shape[1]):
        acc += table[:, j].index_select(1, codes[:, j].long())
    return acc


def top(table: torch.Tensor, codes: torch.Tensor, k: int,
        block: int = 1 << 20) -> torch.Tensor:
    """The k best scores of every query over all rows, best first
    (Q, k), scanned ``block`` rows at a time."""
    best = None
    for g0 in range(0, codes.shape[0], block):
        s = scores(table, codes[g0:g0 + block])
        cand = s.topk(min(k, s.shape[1]), dim=1).values
        best = cand if best is None else torch.cat([best, cand], 1).topk(
            k, dim=1).values
    return best


def at(table: torch.Tensor, codes: torch.Tensor,
       rows: torch.Tensor) -> torch.Tensor:
    """The score of query q at row rows[q, r]: (Q, R) float64."""
    picked = codes[rows.clamp(0, codes.shape[0] - 1).reshape(-1)].long()
    picked = picked.reshape(*rows.shape, -1)                 # (Q, R, M)
    vals = torch.gather(table[:, None].expand(-1, rows.shape[1], -1, -1), 3,
                        picked[..., None]).squeeze(3)        # (Q, R, M)
    return vals.sum(2)

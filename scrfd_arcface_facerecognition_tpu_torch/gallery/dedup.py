"""Duplicate detection / merging over the whole gallery as G x G matmuls.

Counterpart of the JAX package's ``gallery/dedup.py``: a cosine matmul on
the device followed by a host union-find over the thresholded pairs. Past
8k rows the pair scan is blocked, so neither the device nor the host ever
holds the G x G matrix. Products are f32 without TF32; per-row top-k ties
break by lower column, as ``lax.top_k`` does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import full_f32_matmul, resolve_device
from ..ops import l2_normalize, stable_top_k


def all_pairs_similarity(embeddings: np.ndarray, device=None) -> np.ndarray:
    """(G, D) -> (G, G) cosine matrix, computed on the device in one shot."""
    g = embeddings.shape[0]
    if g == 0:
        return np.zeros((0, 0), np.float32)
    e = l2_normalize(torch.from_numpy(
        np.ascontiguousarray(embeddings, np.float32)).to(
            resolve_device(device)))
    with full_f32_matmul():
        return (e @ e.T).cpu().numpy()


def find_duplicate_pairs(embeddings: np.ndarray, threshold: float,
                         ids: Sequence[int] = None, device=None
                         ) -> List[Tuple[int, int, float]]:
    """All (id_i, id_j, sim) with i<j and sim >= threshold, each unordered
    pair once."""
    sims = all_pairs_similarity(embeddings, device)
    g = sims.shape[0]
    if ids is None:
        ids = list(range(g))
    iu, ju = np.triu_indices(g, k=1)
    hits = sims[iu, ju] >= threshold
    return [(ids[i], ids[j], float(sims[i, j]))
            for i, j in zip(iu[hits], ju[hits])]


def find_duplicate_pairs_blocked(
        embeddings: np.ndarray, threshold: float,
        ids: Optional[Sequence[int]] = None, block: int = 4096,
        k_neighbors: int = 16, device=None) -> List[Tuple[int, int, float]]:
    """All (id_i, id_j, sim) with i<j and sim >= threshold — BLOCKED.

    Streams (block, G) device matmuls and reads back only each row's top
    `k_neighbors` candidates of the strictly-upper triangle, so host memory
    is O(G x k) and device memory O(G x D + block x G). Rows whose whole
    top-k cleared the threshold may have more duplicates past the cap and
    are rescanned at full width. Grouping semantics equal
    find_duplicate_pairs'.
    """
    mat = np.asarray(embeddings, np.float32)
    g = mat.shape[0]
    if ids is None:
        ids = list(range(g))
    if g < 2:
        return []
    dev = resolve_device(device)
    # the (block, G) f32 similarity slab must fit next to the (G, D) rows:
    # cap it at ~2 GB (block 512 at G=1M)
    block = max(128, min(block, (2 << 30) // max(4 * g, 1)))
    k = min(k_neighbors, g)
    # normalize once on the device
    emb = l2_normalize(torch.from_numpy(np.ascontiguousarray(mat)).to(dev))
    cols = torch.arange(g, device=dev)[None, :]
    pairs: List[Tuple[int, int, float]] = []
    saturated: List[int] = []
    for r0 in range(0, g, block):
        blk = emb[r0:r0 + block]
        with full_f32_matmul():
            sims = blk @ emb.T
        rows = r0 + torch.arange(len(blk), device=dev)[:, None]
        sims = torch.where(cols > rows, sims, -torch.inf)
        s, j = stable_top_k(sims, k)
        s = s.cpu().numpy()
        j = j.cpu().numpy()
        hit = s >= threshold
        for bi in np.nonzero(hit.any(axis=1))[0]:
            row = r0 + int(bi)
            for col, sim in zip(j[bi][hit[bi]], s[bi][hit[bi]]):
                pairs.append((ids[row], ids[int(col)], float(sim)))
            if hit[bi].all():
                saturated.append(row)
    # rescan saturated rows exactly (full width), in batched device calls,
    # against an index of the pairs already found
    if saturated:
        have_by_row: dict = {}
        for a, b, _ in pairs:
            have_by_row.setdefault(a, set()).add(b)
        cols_idx = np.arange(g)
        chunk = max(1, min(256, (2 << 30) // max(4 * g, 1)))
        for c0 in range(0, len(saturated), chunk):
            rows = saturated[c0:c0 + chunk]
            r = l2_normalize(torch.from_numpy(mat[rows]).to(dev))
            with full_f32_matmul():
                sims = (r @ emb.T).cpu().numpy()
            for ri, row in enumerate(rows):
                extra = np.nonzero((sims[ri] >= threshold)
                                   & (cols_idx > row))[0]
                have = have_by_row.get(ids[row], set())
                for col in extra:
                    if ids[int(col)] not in have:
                        pairs.append((ids[row], ids[int(col)],
                                      float(sims[ri, int(col)])))
    return pairs


class UnionFind:
    """Host-side union-find for transitive duplicate grouping."""

    def __init__(self, items: Sequence[int]):
        self.parent = {i: i for i in items}

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # smaller id wins, mirroring "merge person2 into person1"
            lo, hi = (ra, rb) if ra < rb else (rb, ra)
            self.parent[hi] = lo


def duplicate_groups(embeddings: np.ndarray, threshold: float,
                     ids: Sequence[int] = None,
                     block_above: int = 8192, device=None) -> List[List[int]]:
    """Group transitively-duplicate identities; each group sorted ascending,
    groups of size >= 2 only (the merge worklist: keep group[0], merge rest).

    Past `block_above` rows the pair scan is blocked. Grouping runs through
    the native union-find (runtime/native.py uf_group_roots, Python fallback
    inside); ids map to their ascending rank so the min-rank root is the
    min id ("merge into the smaller id")."""
    from ..runtime.native import uf_group_roots

    g = embeddings.shape[0]
    if ids is None:
        ids = list(range(g))
    if g > block_above:
        pairs = find_duplicate_pairs_blocked(embeddings, threshold, ids,
                                             device=device)
    else:
        pairs = find_duplicate_pairs(embeddings, threshold, ids, device)
    if not pairs:
        return []
    order = sorted(ids)
    rank = {pid: r for r, pid in enumerate(order)}
    idx_pairs = np.asarray([(rank[a], rank[b]) for a, b, _ in pairs],
                           np.int64)
    roots = uf_group_roots(len(order), idx_pairs)
    groups = {}
    for r, pid in zip(roots, order):
        groups.setdefault(int(r), []).append(pid)
    return sorted([sorted(v) for v in groups.values() if len(v) > 1])

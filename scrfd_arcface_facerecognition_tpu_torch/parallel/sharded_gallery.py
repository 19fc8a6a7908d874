"""Gallery rows sharded over a mesh axis: local search, then a merge.

Counterpart of the JAX package's ``parallel/sharded_gallery.py``. The
(G, D) matrix is split row-wise over the slots of an axis; a search is

    per shard:  sims = q @ shard.T (f32, no TF32: JAX's HIGHEST)
                invalid rows -> -inf; local stable top-k + global offset
    merge:      the shards' (Q, k) candidates copied to one device,
                concatenated in shard order, stable top-k

which is what the JAX package's ``shard_map`` body, its tiled
``all_gather`` and the final ``lax.top_k`` compute: ties rank the lower
global row first, since each shard keeps its rows' order and the shards
are joined in order. Only Q * k candidates a shard cross devices.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..device import full_f32_matmul, on_device
from ..ops import l2_normalize, stable_top_k
from .mesh import Mesh, Slot


class RowShards(NamedTuple):
    """A (G, ...) matrix split by rows: ``rows[s]`` holds rows [s * per,
    (s + 1) * per) on ``slots[s].device``, ``valid[s]`` marks the real
    ones (padding rows are False)."""
    rows: Tuple[torch.Tensor, ...]
    valid: Tuple[torch.Tensor, ...]
    slots: Tuple[Slot, ...]

    @property
    def per(self) -> int:
        return self.rows[0].shape[0]

    @property
    def nbytes(self) -> int:
        return sum(r.numel() * r.element_size() for r in self.rows)

    @classmethod
    def split(cls, mat: torch.Tensor, valid: torch.Tensor,
              slots: Sequence[Slot]) -> "RowShards":
        """Rows zero-padded (valid False) to a multiple of the slot count,
        then split in order, each shard copied to its slot's device."""
        n = len(slots)
        g = mat.shape[0]
        gp = max(1, -(-g // n)) * n
        if gp != g:
            mat = torch.cat([mat, mat.new_zeros((gp - g, *mat.shape[1:]))])
            valid = torch.cat([valid, valid.new_zeros(gp - g)])
        per = gp // n
        return cls(tuple(mat[i * per:(i + 1) * per].to(s.device).contiguous()
                         for i, s in enumerate(slots)),
                   tuple(valid[i * per:(i + 1) * per].to(s.device)
                         for i, s in enumerate(slots)),
                   tuple(slots))

    def best(self, emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(F, D) f32 -> each row's best similarity over every shard's
        valid rows and its global row, on ``emb``'s device: ``max`` and
        ``argmax`` of the unsharded (F, G) product. Each shard gives its
        first maximum; the shards' are compared in order, so a tie goes to
        the lower global row (and a NaN wins, as ``argmax`` ranks it)."""
        sims, rows = [], []
        for s, (g, v) in enumerate(zip(self.rows, self.valid)):
            with on_device(g.device), full_f32_matmul():
                x = emb.to(g.device) @ g.T
                x = torch.where(v[None, :], x, -torch.inf)
                sims.append(x.max(dim=-1).values.to(emb.device))
                rows.append((x.argmax(dim=-1) + s * self.per)
                            .to(emb.device))
        sims, rows = torch.stack(sims), torch.stack(rows)       # (S, F)
        which = sims.argmax(dim=0, keepdim=True)
        return (sims.gather(0, which)[0], rows.gather(0, which)[0])


def local_top_k(scores: torch.Tensor, k: int, shard: int, per: int):
    """A shard's (Q, per) masked scores -> its (Q, min(k, per)) candidates
    with global row indices."""
    s, i = stable_top_k(scores, min(k, per))
    return s, i + shard * per


def merge_top_k(cands: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' candidates, in shard order, joined on ``device`` ->
    (Q, min(k, all candidates)) scores and global rows."""
    s = torch.cat([c[0].to(device) for c in cands], dim=1)
    i = torch.cat([c[1].to(device) for c in cands], dim=1)
    top, pos = stable_top_k(s, min(k, s.shape[1]))
    return top, torch.gather(i, 1, pos)


def sharded_top_k(queries: torch.Tensor, gallery: RowShards, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine search over a row-sharded gallery: (Q, D) queries ->
    (Q, k') scores and global rows on the queries' device, k' = min(k,
    shards * min(k, rows a shard))."""
    cands: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for s, (g, v) in enumerate(zip(gallery.rows, gallery.valid)):
        with on_device(g.device), full_f32_matmul():
            sims = queries.to(g.device) @ g.T
            sims = torch.where(v[None, :], sims, -torch.inf)
            cands.append(local_top_k(sims, k, s, gallery.per))
    return merge_top_k(cands, k, queries.device)


class ShardedGallery:
    """A gallery matrix row-sharded over a mesh axis, with top-k search.

    Rows are L2-normalized and padded to a multiple of the axis size;
    results equal the single-device cosine top-k. Search results land on
    the axis's first slot.
    """

    def __init__(self, embeddings, mesh: Mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        slots = mesh.axis_slots(axis)
        emb = torch.as_tensor(np.asarray(embeddings, np.float32)
                              if not isinstance(embeddings, torch.Tensor)
                              else embeddings).float()
        self.size = emb.shape[0]
        self.device = slots[0].device
        valid = torch.ones(self.size, dtype=torch.bool, device=emb.device)
        self._rows = RowShards.split(l2_normalize(emb), valid, slots)

    def search(self, queries, k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) -> (Q, k) scores and global row indices (numpy).

        k clamps to the REAL row count (padding rows are -inf-masked and
        must never surface as result indices)."""
        q = torch.as_tensor(np.asarray(queries, np.float32)
                            if not isinstance(queries, torch.Tensor)
                            else queries).float().to(self.device)
        k_eff = max(1, min(k, self.size))
        scores, idx = sharded_top_k(l2_normalize(q), self._rows, k_eff)
        return scores.cpu().numpy(), idx.cpu().numpy()

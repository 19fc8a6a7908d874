"""Product-quantized gallery tier: million-identity search in device memory.

Counterpart of the JAX package's ``gallery/pq.py``. Each embedding becomes
M uint8 codes (default M=64: one code per 8-dim subspace, 256 centroids
each), 64 B a row instead of 2 KB, and search uses asymmetric distance
computation (ADC):

    LUT[q, m, k] = q_m . centroid[m, k]        (one small batched matmul)
    score[q, g]  = sum_m LUT[q, m, codes[g, m]] (kernel K2, gallery/pq_adc.py)

Training is batched Lloyd's k-means over all M subspaces at once, from the
same numpy draws as the JAX codec, so both packages train the same codec
from the same rows. The gallery is capacity-padded: K2 scans every capacity
row and a validity mask follows. Everything runs on the CUDA card unless
the caller passes ``device="cpu"``: the kernel on the card, its plain
version (the f32 or bf16-LUT scan) on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import full_f32_matmul, resolve_device
from ..ops import stable_top_k
from ..stages import stage
from .pq_adc import adc_scores_plain, pq_adc_scores


@dataclasses.dataclass
class PQCodec:
    """Per-subspace k-means codebooks. dim = M * sub_dim."""
    centroids: torch.Tensor       # (M, K, sub_dim) f32, on the codec's device

    def __post_init__(self):
        if self.centroids.shape[1] > 256:
            # codes are uint8: a larger codebook would wrap assignments
            raise ValueError(
                f"k={self.centroids.shape[1]} > 256 does not fit uint8 "
                f"codes")

    @classmethod
    def from_centroids(cls, centroids, device=None) -> "PQCodec":
        """A codec from (M, K, sub_dim) centroids given as a numpy array
        (for example the JAX codec's ``np.asarray(codec.centroids)``)."""
        return cls(torch.from_numpy(
            np.array(centroids, np.float32, copy=True)).to(
                resolve_device(device)))

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]

    @property
    def sub_dim(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.sub_dim

    # ------------------------------------------------------------- train

    @staticmethod
    def train(embeddings: np.ndarray, m: int = 64, k: int = 256,
              iters: int = 20, seed: int = 0, chunk: int = 8192,
              device=None) -> "PQCodec":
        """Batched Lloyd's k-means, all M subspaces at once on the device.

        embeddings (N, dim) with dim % m == 0; N should be >= ~4k for a
        256-centroid codebook (empty clusters re-seed from the data). The
        init and re-seed rows are the JAX codec's numpy draws. The
        assignment and update sweep `chunk`-row blocks, so device memory is
        O(M * chunk * K) whatever N is; distances and sums are f32 matmuls
        without TF32, and argmin takes the first minimum, as in JAX.
        """
        x = np.asarray(embeddings, np.float32)
        n, dim = x.shape
        if dim % m:
            raise ValueError(f"dim {dim} not divisible by m={m}")
        if k > 256:
            raise ValueError(f"k={k} > 256 does not fit uint8 codes")
        dev = resolve_device(device)
        sub = dim // m
        data_np = x.reshape(n, m, sub).transpose(1, 0, 2)            # (M,N,S)
        rng = np.random.default_rng(seed)
        k_eff = min(k, n)
        init_idx = rng.choice(n, size=k_eff, replace=False)
        cent = torch.from_numpy(
            np.ascontiguousarray(data_np[:, init_idx, :])).to(dev)  # (M,K,S)
        reseed_idx = rng.choice(n, size=(iters, k_eff))
        reseed = torch.from_numpy(np.ascontiguousarray(
            data_np[:, reseed_idx.reshape(-1), :]
            .reshape(m, iters, k_eff, sub).transpose(1, 0, 2, 3))).to(dev)
        data = torch.from_numpy(np.ascontiguousarray(data_np)).to(dev)
        c = min(chunk, n)
        with full_f32_matmul():
            for i in range(iters):
                c2 = (cent * cent).sum(-1)                           # (M,K)
                counts = torch.zeros((m, k_eff), dtype=torch.float32,
                                     device=dev)
                sums = torch.zeros((m, k_eff, sub), dtype=torch.float32,
                                   device=dev)
                for s0 in range(0, n, c):
                    d = data[:, s0:s0 + c]                           # (M,C,S)
                    # assignment: argmin ||x-c||^2 = argmin (||c||^2 - 2 x.c)
                    xc = torch.bmm(d, cent.transpose(1, 2))          # (M,C,K)
                    assign = torch.argmin(c2[:, None, :] - 2.0 * xc, dim=-1)
                    oh = torch.nn.functional.one_hot(
                        assign, k_eff).to(torch.float32)             # (M,C,K)
                    counts += oh.sum(1)
                    sums += torch.bmm(oh.transpose(1, 2), d)         # (M,K,S)
                new = sums / counts.clamp_min(1.0)[..., None]
                # re-seed empty clusters from random data points
                cent = torch.where(counts[..., None] > 0, new, reseed[i])
        return PQCodec(centroids=cent)

    # ----------------------------------------------------- encode/decode

    def encode(self, embeddings, chunk: int = 16384) -> torch.Tensor:
        """(N, dim) -> (N, M) uint8 codes on the codec's device, in
        `chunk`-row blocks (device memory O(chunk * M * K))."""
        x = np.asarray(embeddings, np.float32).reshape(-1, self.dim)
        out = torch.empty((x.shape[0], self.m), dtype=torch.uint8,
                          device=self.device)
        c2 = (self.centroids * self.centroids).sum(-1)               # (M,K)
        ct = self.centroids.transpose(1, 2)                          # (M,S,K)
        with stage("pq_encode"), full_f32_matmul():
            for i0 in range(0, x.shape[0], chunk):
                blk = torch.from_numpy(np.ascontiguousarray(
                    x[i0:i0 + chunk])).to(self.device)
                data = blk.reshape(-1, self.m, self.sub_dim).transpose(0, 1)
                xc = torch.bmm(data, ct)                             # (M,C,K)
                out[i0:i0 + chunk] = torch.argmin(
                    c2[:, None, :] - 2.0 * xc, dim=-1).T.to(torch.uint8)
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(N, M) uint8 -> (N, dim) reconstruction."""
        sub = torch.arange(self.m, device=self.device)[None, :]
        return self.centroids[sub, codes.long()].reshape(codes.shape[0],
                                                         self.dim)

    def lut(self, queries) -> torch.Tensor:
        """(Q, dim) -> (Q, M, K) inner-product lookup tables, contiguous."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        qs = q.reshape(-1, self.m, self.sub_dim).transpose(0, 1)     # (M,Q,S)
        with full_f32_matmul():
            t = torch.bmm(qs, self.centroids.transpose(1, 2))        # (M,Q,K)
        return t.transpose(0, 1).contiguous()


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) LUTs x (G, M) codes -> (Q, G) inner-product scores: the
    plain f32 scan over the subspaces, on any device."""
    return adc_scores_plain(lut, codes, "hilo")


class PQGallery:
    """Capacity-padded PQ store with the GalleryStore search surface.

    >>> codec = PQCodec.train(corpus)         # once, on the device
    >>> g = PQGallery(codec, capacity=1_000_000)
    >>> g.add(ids, embeddings)                # encodes on the device
    >>> scores, found_ids = g.search(query, k=5)

    It works on the CUDA card unless given ``device="cpu"`` (the codec
    moves there). keep_exact keeps the full-precision rows in host memory,
    so search() can rerank the ADC shortlist exactly.
    """

    def __init__(self, codec: PQCodec, capacity: int = 1 << 20,
                 keep_exact: bool = False, device=None):
        self.device = resolve_device(device)
        if codec.device != self.device:
            codec = PQCodec(codec.centroids.to(self.device))
        self.codec = codec
        self.capacity = capacity
        self._exact = (np.zeros((capacity, codec.dim), np.float32)
                       if keep_exact else None)
        self._codes = torch.zeros((capacity, codec.m), dtype=torch.uint8,
                                  device=self.device)
        self._valid = torch.zeros((capacity,), dtype=torch.bool,
                                  device=self.device)
        self._ids = np.full((capacity,), -1, np.int64)
        self._free = list(range(capacity - 1, -1, -1))  # deleted slots reuse

    def __len__(self) -> int:
        return self.capacity - len(self._free)

    def add(self, ids, embeddings) -> np.ndarray:
        """Add rows; returns the slot indices written."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if (ids < 0).any():
            # -1 is the empty-slot sentinel; snapshot() derives validity
            # from id sign, so a negative id would vanish across
            # snapshot/restore
            raise ValueError("person ids must be >= 0")
        emb = np.atleast_2d(np.asarray(embeddings, np.float32))
        n = len(ids)
        if n > len(self._free):
            raise ValueError(f"PQ gallery full ({self.capacity})")
        codes = self.codec.encode(emb)
        rows = np.asarray([self._free.pop() for _ in range(n)], np.int64)
        pos = torch.from_numpy(rows).to(self.device)
        self._codes[pos] = codes
        self._valid[pos] = True
        self._ids[rows] = ids
        if self._exact is not None:
            self._exact[rows] = emb
        return rows

    def delete(self, person_id: int) -> bool:
        rows = np.nonzero(self._ids == person_id)[0]
        if not len(rows):
            return False
        self._valid[torch.from_numpy(rows).to(self.device)] = False
        self._ids[rows] = -1
        self._free.extend(int(r) for r in rows)
        return True

    # ------------------------------------------------------- persistence

    def snapshot(self, path: str) -> None:
        """Atomic PQ-tier checkpoint: codebooks + codes + ids (+ the exact
        rerank rows when keep_exact), as the JAX package's npz (every member
        zip-CRC-checked; tmp write + os.replace)."""
        valid_rows = np.nonzero(self._ids >= 0)[0]
        pos = torch.from_numpy(valid_rows).to(self.device)
        arrays = dict(
            centroids=self.codec.centroids.cpu().numpy(),
            codes=self._codes[pos].cpu().numpy(),
            ids=self._ids[valid_rows],
            capacity=np.int64(self.capacity))
        if self._exact is not None:
            arrays["exact"] = self._exact[valid_rows]
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    @classmethod
    def restore(cls, path: str, capacity: Optional[int] = None,
                device=None) -> "PQGallery":
        """Rebuild a gallery from snapshot(); codes load directly (no
        re-encode)."""
        with np.load(path) as z:
            centroids = z["centroids"]
            codes = z["codes"]
            ids = z["ids"].astype(np.int64)
            cap = int(capacity if capacity is not None else z["capacity"])
            exact = z["exact"] if "exact" in z.files else None
        n = len(ids)
        g = cls(PQCodec.from_centroids(centroids, device),
                capacity=max(cap, n, 1), keep_exact=exact is not None,
                device=device)
        if n:
            g._codes[:n] = torch.from_numpy(codes).to(g.device)
            g._valid[:n] = True
            g._ids[:n] = ids
            g._free = list(range(g.capacity - 1, n - 1, -1))
            if exact is not None:
                g._exact[:n] = exact
        return g

    def search(self, queries, k: int = 5, rerank: int = 0,
               precision: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, dim) or (dim,) -> (scores (Q, k), ids (Q, k)); ids -1 and
        score 0 where fewer than k valid rows exist.

        lut -> K2 -> mask -> top-k on the device; ties rank the lower slot
        first and NaN scores (from a non-finite query) first, as
        ``lax.top_k`` ranks them. rerank > 0 (requires keep_exact=True):
        the ADC pass shortlists max(k, rerank) candidates and exact host
        inner products re-order them.

        precision: the ADC pass's LUT, "hilo" (exact f32) or "hi" (bf16);
        default "hi" when an exact rerank follows, "hilo" otherwise.
        """
        q = np.atleast_2d(np.asarray(queries, np.float32))
        k_fetch = max(k, rerank) if rerank else k
        if precision is None:
            precision = "hi" if rerank else "hilo"
        if rerank and self._exact is None:
            raise ValueError("rerank needs PQGallery(keep_exact=True)")
        with stage("pq_lut"):
            lut = self.codec.lut(q)
        with stage("pq_adc"):
            scores = pq_adc_scores(lut, self._codes, precision)
        with stage("pq_topk"):
            scores = torch.where(self._valid[None], scores, -torch.inf)
            s, i = stable_top_k(scores, min(k_fetch, self.capacity))
            s = s.cpu().numpy()
            i = i.cpu().numpy()
        if s.shape[1] < k_fetch:
            # capacity < k: honor the (Q, k) contract, padding with -inf
            # scores (masked to ids=-1 below)
            pad = ((0, 0), (0, k_fetch - s.shape[1]))
            s = np.pad(s, pad, constant_values=-np.inf)
            i = np.pad(i, pad)
        if rerank:
            with stage("pq_rerank"):
                exact = np.einsum("qd,qrd->qr", q, self._exact[i])
                exact = np.where(np.isfinite(s), exact, -np.inf)
                order = np.argsort(-exact, axis=1)[:, :k]
                s = np.take_along_axis(exact, order, axis=1)
                i = np.take_along_axis(i, order, axis=1)
        else:
            s, i = s[:, :k], i[:, :k]
        ids = np.where(np.isfinite(s), self._ids[i], -1)
        return np.where(np.isfinite(s), s, 0.0), ids

"""Device-resident embedding store with the QdrantManager API surface.

Counterpart of the JAX package's ``gallery/store.py``:

- embeddings live as one [capacity, D] float32 tensor on the gallery's
  device (L2-normalized rows) with a validity mask, and a host mirror of
  the same rows, so reads (snapshot, dense_matrix, get_embedding) never copy
  from the device;
- search is one f32 matmul (no TF32) + a top-k whose order among equal
  scores is ``lax.top_k``'s (lower row first); NaN similarities rank last;
- payloads and the id <-> row maps are host dicts;
- snapshot()/restore() write the native CRC-checked files (or the npz
  fallback) that the JAX package reads and writes too.

The store works on the CUDA card unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import full_f32_matmul, resolve_device
from ..ops import l2_normalize, stable_top_k


class SearchHit(NamedTuple):
    id: int
    score: float
    payload: Dict[str, Any]


class GalleryStore:
    def __init__(self, vector_size: int = 512, capacity: int = 1024,
                 distance: str = "cosine", device=None):
        if distance != "cosine":
            raise ValueError("only cosine distance is supported")
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.capacity = capacity
        self._emb = torch.zeros((capacity, vector_size), dtype=torch.float32,
                                device=self.device)
        self._host = np.zeros((capacity, vector_size), np.float32)
        self._valid = torch.zeros((capacity,), dtype=torch.bool,
                                  device=self.device)
        self._row_of: Dict[int, int] = {}       # external id -> row
        self._id_of: Dict[int, int] = {}        # row -> external id
        self._payloads: Dict[int, Dict[str, Any]] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        # change-sets since the last snapshot event (incremental snapshots)
        self._dirty_adds: set = set()
        self._dirty_dels: set = set()

    # ----------------------------------------------------------- internals

    def _topk(self, queries: np.ndarray, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        q = l2_normalize(torch.from_numpy(
            np.ascontiguousarray(queries)).to(self.device))
        with full_f32_matmul():
            sims = q @ self._emb.T
        sims = torch.where(self._valid[None, :], sims, -torch.inf)
        # NaN sims (non-finite query) would sort first and take the k
        # slots; rank them last instead
        sims = torch.where(torch.isnan(sims), -torch.inf, sims)
        return stable_top_k(sims, k)

    def _grow(self, min_capacity: Optional[int] = None) -> None:
        """Double capacity (to at least min_capacity) in one rebuild."""
        new_cap = self.capacity * 2
        while min_capacity is not None and new_cap < min_capacity:
            new_cap *= 2
        emb = torch.zeros((new_cap, self.vector_size), dtype=torch.float32,
                          device=self.device)
        emb[: self.capacity] = self._emb
        valid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
        valid[: self.capacity] = self._valid
        host = np.zeros((new_cap, self.vector_size), np.float32)
        host[: self.capacity] = self._host
        self._free = list(range(new_cap - 1, self.capacity - 1, -1)) + self._free
        self.capacity = new_cap
        self._emb = emb
        self._host = host
        self._valid = valid

    # ----------------------------------------------------------------- API

    def add_embedding(self, person_id: int, embedding,
                      payload: Optional[Dict[str, Any]] = None) -> bool:
        """Upsert one embedding; non-finite vectors are refused."""
        vec = np.asarray(embedding, dtype=np.float32).reshape(-1)
        if vec.shape[0] != self.vector_size:
            return False
        if not np.all(np.isfinite(vec)):
            # a NaN row would poison every later search; refuse it so
            # callers' rollback paths fire
            return False
        if person_id in self._row_of:
            row = self._row_of[person_id]
        else:
            if not self._free:
                self._grow()
            row = self._free.pop()
            self._row_of[person_id] = row
            self._id_of[row] = person_id
        norm = np.linalg.norm(vec)
        vec = vec / max(norm, 1e-12)
        self._write_rows(np.asarray([row]), vec[None])
        self._payloads[person_id] = dict(payload or {})
        self._dirty_adds.add(person_id)
        self._dirty_dels.discard(person_id)
        return True

    def add_batch(self, ids, embeddings,
                  payloads: Optional[List[Dict[str, Any]]] = None) -> int:
        """Bulk upsert in one device write. Later duplicates of the same id
        win, as sequential add_embedding calls would. Non-finite rows are
        dropped. Returns the number of rows written."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        mat = np.atleast_2d(np.asarray(embeddings, np.float32))
        if mat.shape[0] != len(ids) or mat.shape[1] != self.vector_size:
            return 0
        # checked before the filter below, which would otherwise index a
        # wrong-length list (IndexError) or shift payloads onto other ids
        if payloads is not None and len(payloads) != len(ids):
            raise ValueError("payloads length must match ids")
        finite = np.all(np.isfinite(mat), axis=1)
        if not finite.all():
            keep = np.flatnonzero(finite)
            ids = ids[keep]
            mat = mat[keep]
            if payloads is not None:
                payloads = [payloads[i] for i in keep]
        if len(ids) == 0:
            return 0
        # collapse duplicate ids (last write wins) before allocating rows
        last = {int(pid): i for i, pid in enumerate(ids)}
        order = sorted(last.values())
        n_new = sum(1 for i in order if int(ids[i]) not in self._row_of)
        if n_new > len(self._free):
            self._grow(self.capacity + (n_new - len(self._free)))
        rows = np.empty(len(order), np.int64)
        for j, i in enumerate(order):
            pid = int(ids[i])
            row = self._row_of.get(pid)
            if row is None:
                row = self._free.pop()
                self._row_of[pid] = row
                self._id_of[row] = pid
            rows[j] = row
            self._payloads[pid] = dict(payloads[i]) if payloads else {}
            self._dirty_adds.add(pid)
            self._dirty_dels.discard(pid)
        vecs = mat[order]
        vecs = vecs / np.maximum(
            np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
        self._write_rows(rows, vecs)
        return len(order)

    def _write_rows(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        """Write N normalized rows to the host mirror and, in one indexed
        copy, to the device."""
        self._host[rows] = vecs
        pos = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        self._emb[pos] = torch.from_numpy(
            np.ascontiguousarray(vecs)).to(self.device)
        self._valid[pos] = True

    def search_similar(self, query, k: int = 5,
                       threshold: Optional[float] = None) -> List[SearchHit]:
        """k-NN over the gallery."""
        hits = self.search_batch(np.asarray(query, np.float32).reshape(1, -1),
                                 k=k, threshold=threshold)
        return hits[0]

    def search_batch(self, queries, k: int = 5,
                     threshold: Optional[float] = None) -> List[List[SearchHit]]:
        """Batched k-NN: (Q, D) queries in one device matmul."""
        q = np.asarray(queries, np.float32)
        if self.get_embedding_count() == 0:
            return [[] for _ in range(len(q))]
        k_eff = max(1, min(k, self.capacity))
        scores, idx = self._topk(np.atleast_2d(q), k_eff)
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        out: List[List[SearchHit]] = []
        for qi in range(len(q)):
            row_hits = []
            for score, row in zip(scores[qi], idx[qi]):
                if not np.isfinite(score):
                    continue
                if threshold is not None and score < threshold:
                    continue
                pid = self._id_of.get(int(row))
                if pid is None:
                    continue
                row_hits.append(SearchHit(pid, float(score),
                                          self._payloads.get(pid, {})))
            out.append(row_hits)
        return out

    def get_embedding(self, person_id: int) -> Optional[np.ndarray]:
        row = self._row_of.get(person_id)
        if row is None:
            return None
        return self._host[row].copy()

    def get_payload(self, person_id: int) -> Optional[Dict[str, Any]]:
        return self._payloads.get(person_id)

    def update_embedding(self, person_id: int, embedding,
                         payload: Optional[Dict[str, Any]] = None) -> bool:
        if person_id not in self._row_of:
            return False
        return self.add_embedding(person_id, embedding,
                                  payload if payload is not None
                                  else self._payloads.get(person_id))

    def delete_embedding(self, person_id: int) -> bool:
        row = self._row_of.pop(person_id, None)
        if row is None:
            return False
        self._id_of.pop(row, None)
        self._payloads.pop(person_id, None)
        self._valid[row] = False
        self._free.append(row)
        self._dirty_adds.discard(person_id)
        self._dirty_dels.add(person_id)
        return True

    def get_embedding_count(self) -> int:
        return len(self._row_of)

    def clear_all(self) -> bool:
        # record as deletions so incremental snapshots replay the clear
        self._dirty_dels.update(self._row_of.keys())
        self._dirty_adds.clear()
        self._emb.zero_()
        self._host[:] = 0.0
        self._valid.zero_()
        self._row_of.clear()
        self._id_of.clear()
        self._payloads.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        return True

    def ids(self) -> List[int]:
        return list(self._row_of.keys())

    def dense_matrix(self) -> "tuple[np.ndarray, list]":
        """(G, D) matrix of valid embeddings + aligned id list (sorted)."""
        ids = sorted(self._row_of.keys())
        if not ids:
            return np.zeros((0, self.vector_size), np.float32), []
        return self._read_rows([self._row_of[i] for i in ids]), ids

    def _read_rows(self, rows) -> np.ndarray:
        """Gather N rows from the host mirror — no device traffic."""
        return self._host[np.asarray(rows, np.int64)].copy()

    def duplicate_groups(self, threshold: float) -> List[List[int]]:
        """Merge worklist over the resident rows (blocked pair scan past
        8k rows)."""
        from .dedup import duplicate_groups

        mat, ids = self.dense_matrix()
        if len(ids) < 2:
            return []
        return duplicate_groups(mat, threshold, ids, device=self.device)

    # ------------------------------------------------------- persistence

    def snapshot(self, path: str) -> None:
        """Write an atomic gallery checkpoint: embeddings + ids through the
        native CRC-checked file (npz without the library), payloads in
        <path>.meta.json (atomic replace)."""
        from ..runtime.native import snapshot_write

        mat, ids = self.dense_matrix()
        snapshot_write(path, mat, np.asarray(ids, np.int64))
        meta_tmp = path + ".meta.json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump({str(i): self._payloads.get(i, {}) for i in ids}, f)
        os.replace(meta_tmp, path + ".meta.json")

    @classmethod
    def restore(cls, path: str, capacity: Optional[int] = None,
                device=None) -> "GalleryStore":
        from ..runtime.native import snapshot_read

        vecs, ids = snapshot_read(path)
        payloads = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                payloads = json.load(f)
        cap = capacity or max(1024, 2 * len(ids))
        store = cls(vector_size=int(vecs.shape[1]) if len(vecs) else 512,
                    capacity=cap, device=device)
        if len(ids):
            store.add_batch(ids, vecs,
                            [payloads.get(str(int(p)), {}) for p in ids])
        return store

    # ------------------------------------------- incremental persistence

    def snapshot_incremental(self, directory: str) -> str:
        """Write only what changed since the last snapshot call.

        Layout: `base.bin` (full snapshot) + ordered `delta_NNNNN.bin`
        segments (upserts since the previous segment; deletions ride in the
        segment's .meta.json) + an atomically-replaced MANIFEST.json.
        Returns the path written.
        """
        from ..runtime.native import snapshot_write

        os.makedirs(directory, exist_ok=True)
        manifest_path = os.path.join(directory, "MANIFEST.json")
        manifest = {"base": None, "deltas": []}
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)

        if manifest["base"] is None:
            path = os.path.join(directory, "base.bin")
            self.snapshot(path)
            manifest = {"base": "base.bin", "deltas": []}
        elif not self._dirty_adds and not self._dirty_dels:
            # nothing changed since the last snapshot: no empty delta
            return os.path.join(directory, manifest["base"])
        else:
            seq = len(manifest["deltas"]) + 1
            name = f"delta_{seq:05d}.bin"
            path = os.path.join(directory, name)
            adds = sorted(self._dirty_adds)
            if adds:
                mat = self._read_rows([self._row_of[i] for i in adds])
            else:
                mat = np.zeros((0, self.vector_size), np.float32)
            snapshot_write(path, mat, np.asarray(adds, np.int64))
            meta_tmp = path + ".meta.json.tmp"
            with open(meta_tmp, "w") as f:
                json.dump({"deleted": sorted(self._dirty_dels),
                           "payloads": {str(i): self._payloads.get(i, {})
                                        for i in adds}}, f)
            os.replace(meta_tmp, path + ".meta.json")
            manifest["deltas"].append(name)

        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, manifest_path)
        self._dirty_adds.clear()
        self._dirty_dels.clear()
        return path

    @classmethod
    def restore_dir(cls, directory: str, capacity: Optional[int] = None,
                    device=None) -> "GalleryStore":
        """Rebuild from base + ordered deltas (snapshot_incremental)."""
        from ..runtime.native import snapshot_read

        with open(os.path.join(directory, "MANIFEST.json")) as f:
            manifest = json.load(f)
        store = cls.restore(os.path.join(directory, manifest["base"]),
                            capacity=capacity, device=device)
        for name in manifest["deltas"]:
            path = os.path.join(directory, name)
            vecs, ids = snapshot_read(path)
            meta = {"deleted": [], "payloads": {}}
            if os.path.exists(path + ".meta.json"):
                with open(path + ".meta.json") as f:
                    meta = json.load(f)
            if len(ids):
                store.add_batch(
                    ids, vecs,
                    [meta["payloads"].get(str(int(p)), {}) for p in ids])
            for pid in meta["deleted"]:
                store.delete_embedding(int(pid))
        store._dirty_adds.clear()
        store._dirty_dels.clear()
        return store

    @staticmethod
    def compact_snapshots(directory: str, device=None) -> None:
        """Fold all deltas into a fresh base (bounds restore time and
        reclaims space from deleted/overwritten rows)."""
        store = GalleryStore.restore_dir(directory, device=device)
        tmp_base = os.path.join(directory, "base.bin.compact")
        store.snapshot(tmp_base)
        manifest_path = os.path.join(directory, "MANIFEST.json")
        with open(manifest_path) as f:
            old_deltas = json.load(f)["deltas"]
        os.replace(tmp_base, os.path.join(directory, "base.bin"))
        os.replace(tmp_base + ".meta.json",
                   os.path.join(directory, "base.bin.meta.json"))
        # Crash-safety ordering: point the manifest at the compacted base
        # BEFORE removing delta files. Replaying the old deltas over the
        # compacted base is idempotent (same upserts, already-gone deletes),
        # but a manifest referencing deleted files would break restore_dir.
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"base": "base.bin", "deltas": []}, f)
        os.replace(tmp, manifest_path)
        for name in old_deltas:
            for suffix in ("", ".meta.json"):
                try:
                    os.remove(os.path.join(directory, name + suffix))
                except OSError:
                    pass

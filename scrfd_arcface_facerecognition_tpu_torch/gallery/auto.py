"""Auto-tier gallery: one facade, capacity-driven dense -> PQ policy.

Counterpart of the JAX package's ``gallery/auto.py``. AutoGallery exposes
the GalleryStore API and picks the tier by size:

- DENSE below the threshold: exact [G, D] matmul search (GalleryStore).
- PQ above it: rows migrate into a product-quantized code matrix (codec
  trained on the resident rows at migration time), searched by kernel K2
  with EXACT host-side reranking (keep_exact), so the scores returned are
  true cosines and every caller's threshold keeps its meaning.

The threshold defaults to the row count whose f32 matrix fills
`hbm_budget_gb`, and `tier="pq"` migrates as soon as enough rows exist to
train a codec. Both tiers work on the gallery's device: the CUDA card
unless the caller passes ``device="cpu"``. With a ``mesh``, the PQ tier's
codes are row-sharded over its ``axis`` (``PQGallery(mesh=)``).
"""
from __future__ import annotations

import functools
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stages import stage
from .store import GalleryStore, SearchHit
from .pq import PQCodec, PQGallery


def _locked(fn):
    """Serialize a public method on the instance's _api_lock (RLock:
    public methods call each other). The async migration swap makes
    lock-free cross-thread access to _dense/_pq unsafe."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._api_lock:
            return fn(self, *args, **kwargs)
    return wrapper


class AutoGallery:
    """GalleryStore-API facade with a size-driven dense->PQ tier policy."""

    def __init__(self, vector_size: int = 512, capacity: int = 1024,
                 tier: str = "auto", pq_threshold: Optional[int] = None,
                 hbm_budget_gb: float = 4.0, pq_m: int = 64,
                 pq_rerank: int = 32, min_train_rows: int = 4096,
                 pq_train_rows: int = 50_000, pq_train_iters: int = 10,
                 migrate_async: bool = False,
                 mesh=None, axis: str = "model", device=None):
        if tier not in ("auto", "dense", "pq"):
            raise ValueError(f"unknown tier {tier!r}")
        if tier != "dense" and vector_size % pq_m:
            # fail at construction, not at the migration threshold; a
            # forced-dense gallery never reaches the PQ tier, so an odd
            # vector_size is legal there
            raise ValueError(
                f"vector_size {vector_size} not divisible by pq_m={pq_m}: "
                f"the PQ tier cannot encode it")
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.tier_policy = tier
        self.pq_m = pq_m
        self.pq_rerank = pq_rerank
        self.mesh = mesh
        self.axis = axis
        if pq_threshold is None:
            pq_threshold = int(hbm_budget_gb * 1e9 / (vector_size * 4))
        self.pq_threshold = pq_threshold
        # a codec cannot train on a handful of rows; tier="pq" migrates at
        # min_train_rows instead of the capacity threshold
        self.min_train_rows = max(min_train_rows, 2)
        # codec train budget at migration: the tier-crossing stall is
        # train + full re-encode, and the exact rerank re-orders with true
        # cosines regardless of the codec's quality
        self.pq_train_rows = pq_train_rows
        self.pq_train_iters = pq_train_iters
        self._dense: Optional[GalleryStore] = GalleryStore(
            vector_size=vector_size, capacity=capacity, device=self.device)
        self._pq: Optional[PQGallery] = None
        self._payloads: Dict[int, Dict[str, Any]] = {}
        self._row_of: Dict[int, int] = {}        # pq tier: id -> slot
        # migrate_async=True: the tier crossing trains + encodes in a
        # background thread (serving continues from the dense tier; the
        # swap happens at the first call after the build completes, with
        # interim mutations reconciled). Synchronous migration stays the
        # default for deterministic tier state.
        self.migrate_async = migrate_async
        self._bg_thread = None
        self._bg_result = None
        self._bg_mutations: Optional[set] = None
        self._bg_gen = 0
        self._bg_failed = False
        # serializes every public method: the async swap means a reader
        # could otherwise observe _dense mid-teardown from another thread
        self._api_lock = threading.RLock()

    # ---------------------------------------------------------- tier state

    @property
    def tier(self) -> str:
        return "pq" if self._pq is not None else "dense"

    def _migration_due(self) -> bool:
        if self._pq is not None or self.tier_policy == "dense":
            return False
        n = self._dense.get_embedding_count()
        if self.tier_policy == "pq":
            return n >= self.min_train_rows
        return n >= self.pq_threshold

    def _build_pq(self, mat: np.ndarray, ids: List[int]):
        """Train a codec on the first pq_train_rows rows, encode all rows
        into a PQGallery at twice their count; returns (pq, slot rows)."""
        with stage("pq_train"):
            codec = PQCodec.train(mat[:self.pq_train_rows], m=self.pq_m,
                                  k=min(256, max(2, len(mat))),
                                  iters=self.pq_train_iters,
                                  device=self.device)
        cap = max(2 * len(ids), self.min_train_rows * 4, 1024)
        pq = PQGallery(codec, capacity=cap, keep_exact=True,
                       device=self.device, mesh=self.mesh, axis=self.axis)
        return pq, pq.add(np.asarray(ids, np.int64), mat)

    def _migrate(self) -> None:
        """Dense -> PQ: train the codec on the resident rows, re-encode
        everything, keep exact rows host-side for reranking."""
        with stage("pq_migrate"):
            mat, ids = self._dense.dense_matrix()
            pq, rows = self._build_pq(mat, ids)
            self._row_of = {int(pid): int(r) for pid, r in zip(ids, rows)}
            self._payloads = {pid: self._dense.get_payload(pid) or {}
                              for pid in ids}
            self._pq = pq
            self._dense = None

    # ------------------------------------------------- async migration

    def _start_async_migration(self) -> None:
        """Kick off the codec train + full re-encode on a background thread
        over a SNAPSHOT of the resident rows; serving continues from the
        dense tier. The worker touches no shared state: it builds a private
        PQGallery on the gallery's device, waits for the device to finish
        writing it, and parks it in _bg_result (only if its generation is
        still current); the swap (plus reconciliation of rows mutated
        meanwhile) happens on a caller thread in _maybe_finalize() under
        the API lock."""
        mat, ids = self._dense.dense_matrix()
        # store mutations replace payload dicts, never mutate them in
        # place, so a shallow copy is a consistent snapshot
        payload_snap = dict(self._dense._payloads)
        self._bg_mutations = set()
        self._bg_result = None
        gen = self._bg_gen

        def work():
            try:
                pq, rows = self._build_pq(mat, ids)
                row_of = {int(p): int(r) for p, r in zip(ids, rows)}
                payloads = {int(p): payload_snap.get(int(p)) or {}
                            for p in ids}
                if self.device.type == "cuda":
                    # the codes must be written before a reader sees them
                    torch.cuda.synchronize(self.device)
            except Exception:
                # log loudly and flag the failure: the next trigger falls
                # back to SYNCHRONOUS migration, whose exception reaches
                # the caller
                logging.getLogger(__name__).exception(
                    "background PQ migration failed; next trigger will "
                    "migrate synchronously (error surfaces to the caller)")
                self._bg_failed = True
                return
            if gen == self._bg_gen:   # abandoned builds must not clobber
                self._bg_result = (gen, pq, row_of, payloads)

        self._bg_thread = threading.Thread(target=work, daemon=True,
                                           name="pq-migration")
        self._bg_thread.start()

    def _maybe_finalize(self) -> None:
        """Swap to the background-built PQ tier once the build is done.
        Rows added/updated/deleted since the snapshot are re-applied from
        the dense store's current state before the swap, as one delete
        pass + one stacked add. Caller holds _api_lock."""
        t = self._bg_thread
        if t is None or t.is_alive():
            return
        self._bg_thread = None
        result, self._bg_result = self._bg_result, None
        mutations, self._bg_mutations = self._bg_mutations, None
        if (result is None or result[0] != self._bg_gen
                or self._dense is None):
            return   # abandoned (clear_all), stale generation, or failed
        _, pq, row_of, payloads = result
        readd_pids, readd_vecs = [], []
        for pid in sorted(mutations or ()):
            if pid in row_of:
                pq.delete(pid)
                del row_of[pid]
                payloads.pop(pid, None)
            vec = self._dense.get_embedding(pid)
            if vec is not None:       # still present: re-add current value
                readd_pids.append(pid)
                readd_vecs.append(np.asarray(vec, np.float32))
        if readd_pids:
            if len(readd_pids) > len(pq._free):
                # interim ingest outgrew the pre-sized build: rebuild at the
                # needed capacity from the build's exact rows (codec reused)
                pq, row_of = self._rebuild_pq(pq, row_of, len(readd_pids))
            r = pq.add(np.asarray(readd_pids, np.int64),
                       np.stack(readd_vecs))
            for pid, row in zip(readd_pids, r):
                row_of[pid] = int(row)
                payloads[pid] = self._dense.get_payload(pid) or {}
        # the PQ-side state is complete before _pq is set; _dense dies last
        self._row_of = row_of
        self._payloads = payloads
        self._pq = pq
        self._dense = None

    @staticmethod
    def _pq_capacity_for(pq, row_of, need: int) -> int:
        cap = pq.capacity
        while cap - len(row_of) < need:
            cap *= 2
        return cap

    def _rebuild_pq(self, pq, row_of, need: int):
        """Copy a PQGallery into one with capacity for `need` more rows
        (codec reused; rows re-added from the exact mirror)."""
        cap = self._pq_capacity_for(pq, row_of, need)
        new = PQGallery(pq.codec, capacity=cap, keep_exact=True,
                        device=self.device, mesh=self.mesh, axis=self.axis)
        ids = sorted(row_of)
        if ids:
            rows_src = [row_of[p] for p in ids]
            rows = new.add(np.asarray(ids, np.int64), pq._exact[rows_src])
            row_of = {int(p): int(r) for p, r in zip(ids, rows)}
        return new, row_of

    def _abandon_bg(self) -> None:
        """Invalidate any in-flight background build (clear_all)."""
        self._bg_gen += 1
        self._bg_thread = None
        self._bg_result = None
        self._bg_mutations = None

    def _note_mutation(self, pids) -> None:
        if self._bg_mutations is not None:
            self._bg_mutations.update(int(p) for p in pids)

    def _kick_migration(self) -> None:
        if not self.migrate_async or self._bg_failed:
            # after a failed background build, fail in the caller's face
            self._migrate()
        elif self._bg_thread is None:
            self._start_async_migration()

    def _grow_pq(self, need: int) -> None:
        self._pq, self._row_of = self._rebuild_pq(self._pq, self._row_of,
                                                  need)

    # ------------------------------------------------------------- mutate

    @staticmethod
    def _normalize(mat: np.ndarray) -> np.ndarray:
        return mat / np.maximum(
            np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)

    @_locked
    def add_embedding(self, person_id: int, embedding,
                      payload: Optional[Dict[str, Any]] = None) -> bool:
        if person_id < 0:
            # -1 is the PQ tier's empty-slot sentinel
            raise ValueError("person ids must be >= 0")
        vec = np.asarray(embedding, np.float32).reshape(-1)
        if vec.shape[0] != self.vector_size:
            return False
        if not np.all(np.isfinite(vec)):
            return False   # store.add_embedding semantics on both tiers
        self._maybe_finalize()
        if self._pq is None:
            ok = self._dense.add_embedding(person_id, vec, payload)
            if ok:
                self._note_mutation([person_id])
                if self._migration_due():
                    self._kick_migration()
            return ok
        return self.add_batch([person_id], vec[None],
                              [payload or {}]) == 1

    @_locked
    def add_batch(self, ids, embeddings,
                  payloads: Optional[List[Dict[str, Any]]] = None) -> int:
        if np.any(np.atleast_1d(np.asarray(ids, np.int64)) < 0):
            # validate BEFORE any mutation: the PQ upsert below deletes
            # existing rows first
            raise ValueError("person ids must be >= 0")
        self._maybe_finalize()
        if self._pq is None:
            n = self._dense.add_batch(ids, embeddings, payloads)
            if n:
                self._note_mutation(np.atleast_1d(
                    np.asarray(ids, np.int64)).tolist())
                if self._migration_due():
                    self._kick_migration()
            return n
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        mat = np.atleast_2d(np.asarray(embeddings, np.float32))
        if mat.shape[0] != len(ids) or mat.shape[1] != self.vector_size:
            return 0
        if payloads is not None and len(payloads) != len(ids):
            raise ValueError("payloads length must match ids")
        if len(ids) == 0:
            return 0
        last = {int(pid): i for i, pid in enumerate(ids)}
        order = sorted(last.values())
        for i in order:                      # upsert: drop existing rows
            pid = int(ids[i])
            if pid in self._row_of:
                self._pq.delete(pid)
                del self._row_of[pid]
        if len(order) > len(self._pq._free):
            self._grow_pq(len(order))
        vecs = self._normalize(mat[order])
        rows = self._pq.add(ids[order], vecs)
        for j, i in enumerate(order):
            pid = int(ids[i])
            self._row_of[pid] = int(rows[j])
            self._payloads[pid] = dict(payloads[i]) if payloads else {}
        return len(order)

    @_locked
    def update_embedding(self, person_id: int, embedding,
                         payload: Optional[Dict[str, Any]] = None) -> bool:
        self._maybe_finalize()
        if self._pq is None:
            ok = self._dense.update_embedding(person_id, embedding,
                                              payload)
            if ok:
                self._note_mutation([person_id])
            return ok
        if person_id not in self._row_of:
            return False
        keep = (payload if payload is not None
                else self._payloads.get(person_id))
        return self.add_batch([person_id],
                              np.asarray(embedding,
                                         np.float32).reshape(1, -1),
                              [keep or {}]) == 1

    @_locked
    def delete_embedding(self, person_id: int) -> bool:
        self._maybe_finalize()
        if self._pq is None:
            ok = self._dense.delete_embedding(person_id)
            if ok:
                self._note_mutation([person_id])
            return ok
        if person_id not in self._row_of:
            return False
        self._pq.delete(person_id)
        del self._row_of[person_id]
        self._payloads.pop(person_id, None)
        return True

    @_locked
    def clear_all(self) -> bool:
        # an in-flight background build reflects the old population
        self._abandon_bg()
        if self._pq is None:
            return self._dense.clear_all()
        # an emptied gallery restarts at the dense tier
        self._pq = None
        self._row_of.clear()
        self._payloads.clear()
        self._dense = GalleryStore(vector_size=self.vector_size,
                                   device=self.device)
        return True

    # -------------------------------------------------------------- query

    @_locked
    def search_similar(self, query, k: int = 5,
                       threshold: Optional[float] = None) -> List[SearchHit]:
        return self.search_batch(
            np.asarray(query, np.float32).reshape(1, -1), k=k,
            threshold=threshold)[0]

    @_locked
    def search_batch(self, queries, k: int = 5,
                     threshold: Optional[float] = None
                     ) -> List[List[SearchHit]]:
        self._maybe_finalize()
        if self._pq is None:
            return self._dense.search_batch(queries, k=k,
                                            threshold=threshold)
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if not self._row_of:
            return [[] for _ in range(len(q))]
        q = self._normalize(q)
        # exact rerank of the ADC shortlist: returned scores are true
        # cosines, so thresholds keep their dense-tier meaning
        scores, ids = self._pq.search(q, k=min(k, len(self._row_of)),
                                      rerank=max(k, self.pq_rerank))
        out: List[List[SearchHit]] = []
        for qi in range(len(q)):
            hits = []
            for score, pid in zip(scores[qi], ids[qi]):
                if pid < 0:
                    continue
                if threshold is not None and score < threshold:
                    continue
                hits.append(SearchHit(int(pid), float(score),
                                      self._payloads.get(int(pid), {})))
            out.append(hits)
        return out

    @_locked
    def get_embedding(self, person_id: int) -> Optional[np.ndarray]:
        self._maybe_finalize()
        if self._pq is None:
            return self._dense.get_embedding(person_id)
        row = self._row_of.get(person_id)
        if row is None:
            return None
        return self._pq._exact[row].copy()

    @_locked
    def get_payload(self, person_id: int) -> Optional[Dict[str, Any]]:
        self._maybe_finalize()
        if self._pq is None:
            return self._dense.get_payload(person_id)
        return self._payloads.get(person_id)

    @_locked
    def get_embedding_count(self) -> int:
        self._maybe_finalize()
        if self._pq is None:
            return self._dense.get_embedding_count()
        return len(self._row_of)

    @_locked
    def ids(self) -> List[int]:
        self._maybe_finalize()
        if self._pq is None:
            return self._dense.ids()
        return list(self._row_of.keys())

    @_locked
    def dense_matrix(self):
        """(G, D) exact rows + aligned ids (host memory on both tiers)."""
        self._maybe_finalize()
        if self._pq is None:
            return self._dense.dense_matrix()
        ids = sorted(self._row_of)
        if not ids:
            return np.zeros((0, self.vector_size), np.float32), []
        rows = [self._row_of[p] for p in ids]
        return self._pq._exact[rows].copy(), ids

    @_locked
    def duplicate_groups(self, threshold: float) -> List[List[int]]:
        """Merge worklist (groups of ids to fold into their lowest id),
        tier-blind: exact rows, blocked pair scan past 8k rows."""
        from .dedup import duplicate_groups

        mat, ids = self.dense_matrix()
        return duplicate_groups(mat, threshold, ids, device=self.device)

    # ------------------------------------------------------- persistence

    @_locked
    def snapshot(self, path: str) -> None:
        self._maybe_finalize()
        if self._pq is None:
            self._dense.snapshot(path)
            return
        self._pq.snapshot(path)
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump({str(i): self._payloads.get(i, {})
                       for i in self._row_of}, f)
        os.replace(tmp, path + ".meta.json")

    @staticmethod
    def _snapshot_tier(path: str) -> str:
        """Classify a snapshot file by FORMAT, not by whether a restore
        succeeds, so a corrupt snapshot surfaces an error naming its real
        tier. Formats:

        - dense native: starts with the gs_write magic ``SAFRGAL1``
          (native/src/gallery_snapshot.cpp)
        - PQ: npz (zip) with ``codes``/``centroids`` members
        - dense npz fallback (no native lib): zip with ``embeddings``
        """
        import zipfile

        with open(path, "rb") as f:
            head = f.read(8)
        if head == b"SAFRGAL1":
            return "dense"
        if not head.startswith(b"PK"):
            raise ValueError(
                f"{path}: not a gallery snapshot (neither the native "
                f"SAFRGAL1 format nor an npz container)")
        if not zipfile.is_zipfile(path):
            raise ValueError(
                f"{path}: zip container damaged (truncated snapshot? "
                f"could be either tier — restore from a good copy)")
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        if "codes.npy" in names and "centroids.npy" in names:
            return "pq"
        if "embeddings.npy" in names:
            return "dense"
        raise ValueError(
            f"{path}: npz lacks both PQ (codes/centroids) and dense "
            f"(embeddings) members: {sorted(names)[:6]}")

    @classmethod
    def _is_pq_snapshot(cls, path: str) -> bool:
        return cls._snapshot_tier(path) == "pq"

    @classmethod
    def restore(cls, path: str, **kwargs) -> "AutoGallery":
        """Rebuild from either tier's snapshot (sniffed by content)."""
        g = cls(**kwargs)
        if g._snapshot_tier(path) == "pq":
            if g.tier_policy == "dense":
                # the forced-dense policy promises the PQ tier is
                # unreachable
                raise ValueError(
                    f"{path} is a PQ-tier snapshot but tier='dense' was "
                    f"requested; restore with tier='auto'/'pq', or "
                    f"restore the snapshot that matches the policy")
            pq = PQGallery.restore(path, device=g.device, mesh=g.mesh,
                                   axis=g.axis)
        else:
            g._dense = GalleryStore.restore(path, device=g.device)
            if g._migration_due():
                # honors migrate_async
                g._kick_migration()
            return g
        payloads = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                payloads = {int(k): v for k, v in json.load(f).items()}
        if pq._exact is None:
            raise ValueError(
                "PQ snapshot lacks exact rows (keep_exact=False): "
                "AutoGallery needs them for reranked search")
        g._pq = pq
        g._dense = None
        g._row_of = {int(pid): int(r)
                     for r, pid in enumerate(pq._ids) if pid >= 0}
        g._payloads = {pid: payloads.get(pid, {}) for pid in g._row_of}
        return g

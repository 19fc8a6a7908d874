"""The visit-clustering engine (the reference's SmartFaceRecognition).

Behavioral mirror of the reference's smart_face_recognition.py workload 2:
ingest visit records with face-image URLs, embed each face, incrementally
cluster into persons by nearest-neighbor search, persist to SQLite +
clustering_results JSON. The JAX package's ``apps/clustering.py`` is the
reference for this port: the same visit order, gates, decisions, merges
and JSON results, on the port's ``AutoGallery`` and ``FaceAnalysis``.

The hot path, batched:
- the reference downloads + embeds inside a 4-thread pool, one ONNX
  round-trip per image (:1953-1977). Here ingestion is two phases:
  (1) concurrent image loading (ThreadPool, network/disk bound), then
  (2) ONE batched detect+align+embed device call over all loaded images
  (FaceAnalysis.get_batch groups by shape);
- clustering decisions then run in deterministic visit order against the
  device-resident gallery (k-NN = matmul + top-k), removing the
  reference's thread-order nondeterminism;
- duplicate-person merging is the G x G dedup matmul (gallery/dedup.py)
  instead of O(G) sequential Qdrant queries (:2726-2792).

Image acquisition is injectable (`image_loader`) so the engine is testable
offline and a machine without network or cv2 can feed it images.
"""
from __future__ import annotations

import hashlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..device import resolve_device
from ..gallery import AutoGallery
from ..utils.config import load_config
from .face_analysis import FaceAnalysis
from .metadata_db import MetadataDB
from .json_storage import JSONStorageManager
from . import quality as Q

logger = logging.getLogger(__name__)


def default_image_loader(source: str, save_path: Optional[str] = None,
                         timeout: int = 30):
    """Load a BGR image from a local path or http(s) URL (urllib, gated)."""
    import cv2

    if source.startswith("http"):
        try:
            import urllib.request

            req = urllib.request.Request(source, headers={"User-Agent": "Mozilla/5.0"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = resp.read()
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        except Exception as e:
            logger.warning("download failed for %s: %s", source, e)
            return None
    else:
        img = cv2.imread(source)
    if img is not None and save_path:
        cv2.imwrite(save_path, img)
    return img


class SmartFaceEngine:
    """Config/DB/gallery/model wiring mirroring SmartFaceRecognition.__init__
    (smart_face_recognition.py:100-151)."""

    def __init__(self, database_path: Optional[str] = None,
                 confidence_thresh: Optional[float] = None,
                 similarity_thresh: Optional[float] = None,
                 quality_thresh: Optional[float] = None,
                 config_file: str = "config.json",
                 config: Optional[Dict[str, Any]] = None,
                 app: Optional[FaceAnalysis] = None,
                 image_loader: Callable = default_image_loader,
                 results_dir: str = "clustering_results", device=None):
        # the gallery and the facade the engine builds live on ``device``:
        # the CUDA card unless device="cpu" is passed
        self.device = resolve_device(device)
        self.config = config if config is not None else load_config(config_file)
        self.database_path = database_path or self.config["system"]["database_path"]
        self.confidence_thresh = (confidence_thresh if confidence_thresh is not None
                                  else self.config["face_detection"]["confidence_threshold"])
        self.similarity_thresh = (similarity_thresh if similarity_thresh is not None
                                  else self.config["face_recognition"]["similarity_threshold"])
        self.quality_thresh = (quality_thresh if quality_thresh is not None
                               else self.config["face_detection"]["quality_threshold"])
        self.image_cache_dir = self.config["system"]["image_cache_dir"]
        os.makedirs(self.image_cache_dir, exist_ok=True)

        self.db = MetadataDB(self.database_path)
        vdb_cfg = self.config["vector_database"]
        # tier policy (gallery/auto.py): dense matmul search until the
        # gallery would crowd device memory, then the PQ tier (kernel K2)
        # — the reference workloads run unchanged at 1M+ identities
        self._gallery_kwargs = dict(
            vector_size=vdb_cfg["vector_size"],
            tier=vdb_cfg.get("tier", "auto"),
            hbm_budget_gb=vdb_cfg.get("hbm_budget_gb", 4.0),
            min_train_rows=vdb_cfg.get("pq_min_train_rows", 4096),
            # zero-stall tier crossing: train+encode in the background,
            # serve from dense meanwhile
            migrate_async=vdb_cfg.get("migrate_async", False),
            device=self.device)
        self.vector_db = AutoGallery(**self._gallery_kwargs)
        # Gallery persistence: the reference loses
        # its in-memory Qdrant on every restart while SQLite keeps the
        # persons (load_embeddings is a no-op health check,
        # smart_face_recognition.py:1604-1617) — after a restart every
        # returning visitor becomes a NEW person and the tables desync
        # permanently. With snapshot_path set, the engine snapshots after
        # each mutating batch and restores on construction iff the
        # snapshot's person-id generation matches SQLite's.
        self.snapshot_path = vdb_cfg.get("snapshot_path") or None
        self.snapshot_stale_policy = vdb_cfg.get("snapshot_stale_policy",
                                                 "error")
        if self.snapshot_stale_policy not in ("error", "ignore"):
            raise ValueError("vector_database.snapshot_stale_policy must "
                             "be 'error' or 'ignore'")
        if self.snapshot_path:
            self._restore_gallery_if_current()
        self.image_loader = image_loader
        self.json_storage = JSONStorageManager(results_dir)
        if app is None:
            det_size = tuple(self.config["face_detection"]["detection_size"])
            app = FaceAnalysis(det_variant=self.config["system"]["det_variant"],
                               rec_variant=self.config["system"]["rec_variant"],
                               device=self.device)
            app.prepare(ctx_id=0, det_size=det_size)
        self.app = app
        # serving.microbatch: coalesce concurrent single-image requests
        # (webapp threads) into shared device batches, behind a config
        # key. FaceAnalysis.get/get_batch route through
        # the collector automatically once enabled.
        srv = self.config.get("serving", {})
        if srv.get("microbatch"):
            self.app.enable_microbatch(
                max_batch=srv.get("microbatch_max_batch", 32),
                max_wait_ms=srv.get("microbatch_max_wait_ms", 4.0))
        # Live job progress for the web UI (GET /api/job-progress): updated
        # by _cluster_visits as the batch advances; dict writes are atomic
        # under the GIL so the polling reader never needs the lock.
        self.progress: Dict[str, Any] = {
            "status": "idle", "stage": "", "total": 0, "done": 0}

    def _set_progress(self, status: str, stage: str = "",
                      total: int = 0, done: int = 0) -> None:
        self.progress = {"status": status, "stage": stage,
                         "total": total, "done": done}

    # ------------------------------------------- gallery persistence

    def _db_generation(self) -> Dict[str, Any]:
        """Signature of the SQLite persons table: a gallery snapshot is
        current iff it was taken at exactly this person-id set (merges
        delete rows from BOTH stores, so id-set equality is exact)."""
        ids = [int(pid) for pid, _ in self.db.list_persons()]
        return {"n_persons": len(ids),
                "ids_md5": hashlib.md5(
                    ",".join(map(str, ids)).encode()).hexdigest()}

    def save_gallery_snapshot(self, path: Optional[str] = None
                              ) -> Optional[str]:
        """Snapshot the vector store + a generation sidecar recording the
        SQLite person-id set it corresponds to. No-op when persistence is
        disabled and no explicit path is given."""
        import json as _json

        path = path or self.snapshot_path
        if not path:
            return None
        self.vector_db.snapshot(path)
        gen = self._db_generation()
        gen["saved_at"] = datetime.now().isoformat()
        tmp = path + ".gen.json.tmp"
        with open(tmp, "w") as f:
            _json.dump(gen, f)
        os.replace(tmp, path + ".gen.json")
        return path

    def _autosnapshot(self) -> None:
        """Post-mutation snapshot hook. A failure here must not fail the
        batch whose results are already committed to SQLite — and it is
        not silently lost either: the next engine construction sees a
        generation mismatch and degrades by snapshot_stale_policy."""
        if not self.snapshot_path:
            return
        try:
            self.save_gallery_snapshot()
        except Exception:
            logger.exception(
                "gallery snapshot to %s failed; SQLite already holds this "
                "batch, so the NEXT engine start will flag the snapshot "
                "as stale (policy=%s)", self.snapshot_path,
                self.snapshot_stale_policy)

    def _gallery_unrecoverable(self, why: str) -> None:
        """Stale/missing/corrupt snapshot while SQLite has persons:
        starting with a silently empty gallery is exactly the reference's
        restart desync — refuse (policy 'error') or log loudly and start
        empty (policy 'ignore')."""
        msg = (f"gallery snapshot cannot be restored: {why}. SQLite "
               f"({self.database_path}) holds persons whose embeddings "
               f"would be silently absent — every returning visitor would "
               f"become a new person. Re-run clustering from source data "
               f"to rebuild, restore a good snapshot copy, or set "
               f"vector_database.snapshot_stale_policy='ignore' to start "
               f"with an empty gallery anyway.")
        if self.snapshot_stale_policy == "error":
            raise RuntimeError(msg)
        logger.error("%s (continuing with an empty gallery: "
                     "snapshot_stale_policy='ignore')", msg)

    def _restore_gallery_if_current(self) -> None:
        import json as _json

        expected = self._db_generation()
        path = self.snapshot_path
        if not os.path.exists(path):
            if expected["n_persons"] > 0:
                self._gallery_unrecoverable(
                    f"{path} does not exist (snapshotting newly enabled "
                    f"on a populated database, or the file was removed)")
            return   # fresh deployment: empty gallery is correct
        gen_path = path + ".gen.json"
        if not os.path.exists(gen_path):
            self._gallery_unrecoverable(
                f"{gen_path} (generation sidecar) is missing, so the "
                f"snapshot cannot be matched to the database state")
            return
        try:
            with open(gen_path) as f:
                recorded = _json.load(f)
        except Exception as e:
            self._gallery_unrecoverable(f"{gen_path} is unreadable ({e})")
            return
        if (recorded.get("ids_md5") != expected["ids_md5"]
                or recorded.get("n_persons") != expected["n_persons"]):
            self._gallery_unrecoverable(
                f"snapshot generation is stale: it records "
                f"{recorded.get('n_persons')} persons "
                f"(ids_md5={recorded.get('ids_md5')!r:.14}...) but the "
                f"database now has {expected['n_persons']} "
                f"(ids_md5={expected['ids_md5']!r:.14}...) — mutations "
                f"happened after the last snapshot")
            return
        try:
            self.vector_db = AutoGallery.restore(path,
                                                 **self._gallery_kwargs)
        except Exception as e:
            self._gallery_unrecoverable(f"{path} failed to restore "
                                        f"({type(e).__name__}: {e})")
            return
        logger.info("gallery restored from %s (%d persons, tier=%s)",
                    path, self.vector_db.get_embedding_count(),
                    self.vector_db.tier)

    def close(self) -> None:
        """Persist the gallery on shutdown (when persistence is enabled).
        Idempotent; safe to call from a webapp's shutdown path."""
        self._autosnapshot()

    # ------------------------------------------------------------ helpers

    @staticmethod
    def compute_face_hash(embedding: np.ndarray) -> str:
        """md5 of the embedding bytes (smart_face_recognition.py:361-363)."""
        return hashlib.md5(np.asarray(embedding).tobytes()).hexdigest()

    def get_cached_image_path(self, image_url: str) -> Optional[str]:
        url_hash = hashlib.md5(image_url.encode()).hexdigest()
        cached = os.path.join(self.image_cache_dir, f"{url_hash}.jpg")
        if not os.path.exists(cached):
            img = self.image_loader(image_url, save_path=cached)
            if img is None:
                return None
        return cached

    # --------------------------------------------------- face extraction

    def _best_face(self, faces):
        return max(faces, key=lambda f: getattr(f, "det_score", 0.0)) if faces else None

    def _gate_face(self, face, source: str):
        """Confidence -> side-face -> min-quality gates
        (smart_face_recognition.py:1479-1509).

        Returns (embedding_data, reason): reason is None on success, else
        one of "no_face" (no face / low confidence / side face) or
        "low_quality" (quality gate). The reference folds every failure
        into a None return (and so counts them all as no_faces, :2117);
        the split reason is what lets the batch counters distinguish
        low_quality — the counter the reference initializes (:1754-1763)
        but never increments.
        """
        if face is None:
            return None, "no_face"
        if float(face.det_score) < self.confidence_thresh:
            logger.info("face confidence too low in: %s", source)
            return None, "no_face"
        if Q.is_side_face(face, self.config):
            logger.info("side face rejected in: %s", source)
            return None, "no_face"
        embedding = face.normed_embedding
        if not np.all(np.isfinite(np.asarray(embedding))):
            # a non-finite embedding is an upstream numerics bug, never a
            # property of the image — reject loudly instead of ingesting
            # a vector whose identical NaN md5 hash would alias every
            # later failure into one person
            logger.error("non-finite embedding for %s — rejecting", source)
            return None, "no_face"
        scores = Q.assess_face_quality(face, self.config)
        if scores["overall"] < self.config["face_detection"]["min_quality_threshold"]:
            logger.info("face quality extremely low in: %s", source)
            return None, "low_quality"
        return {
            "embedding": np.asarray(embedding, np.float32),
            "quality": scores,
            "bbox": face.bbox,
            "det_score": float(face.det_score),
            "face_confidence": float(face.det_score),
            "face_hash": self.compute_face_hash(embedding),
            "image_source": source,
        }, None

    def extract_face_embedding(self, image_source: str, save_image: bool = False,
                               output_dir: Optional[str] = None
                               ) -> Optional[Dict[str, Any]]:
        """Single-image path (API parity with :1434-1529)."""
        save_path = None
        if save_image and output_dir and image_source.startswith("http"):
            filename = image_source.split("/")[-1] or f"image_{int(time.time())}.jpg"
            if not any(filename.lower().endswith(e) for e in
                       (".jpg", ".jpeg", ".png", ".bmp")):
                filename += ".jpg"
            os.makedirs(output_dir, exist_ok=True)
            save_path = os.path.join(output_dir, filename)
        image = self.image_loader(image_source, save_path=save_path)
        if image is None:
            return None
        faces = self.app.get(image)
        data, _ = self._gate_face(self._best_face(faces), image_source)
        if data is not None and save_path:
            data["saved_image_path"] = save_path
        return data

    def extract_batch(self, sources: List[str], save_image: bool = False,
                      output_dir: Optional[str] = None
                      ) -> List[Optional[Dict[str, Any]]]:
        """Batched path: concurrent load, ONE device batch per image shape."""
        return [data for data, _ in self.extract_batch_detail(
            sources, save_image=save_image, output_dir=output_dir)]

    def extract_batch_detail(self, sources: List[str],
                             save_image: bool = False,
                             output_dir: Optional[str] = None):
        """extract_batch returning (embedding_data, failure_reason) pairs.

        reason is None on success, else "download_failed" / "no_face" /
        "low_quality" — the distinction the batch counters need."""
        max_workers = max(1, min(self.config["image_processing"]["max_workers"],
                                 len(sources) or 1))

        def load(src):
            save_path = None
            if save_image and output_dir and src.startswith("http"):
                filename = src.split("/")[-1] or "img.jpg"
                if not any(filename.lower().endswith(e) for e in
                           (".jpg", ".jpeg", ".png", ".bmp")):
                    filename += ".jpg"
                # distinct URLs can share a basename (cdn/a/face.jpg vs
                # cdn/b/face.jpg): prefix a short url-hash so concurrent
                # saves never overwrite each other
                tag = hashlib.md5(src.encode()).hexdigest()[:8]
                save_path = os.path.join(output_dir, f"{tag}_{filename}")
            return self.image_loader(src, save_path=save_path), save_path

        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            loaded = list(pool.map(load, sources))

        idxs = [i for i, (im, _) in enumerate(loaded) if im is not None]
        out = [(None, "download_failed")] * len(sources)
        if not idxs:
            return out
        # Shape bucketing happens inside FaceAnalysis.get_batch: web images
        # of arbitrary shapes merge into 256-multiple padded buckets served
        # by the dynamic-letterbox program, whose per-image geometry rides
        # in as data — results are numerically identical to exact-shape
        # processing (ops.letterbox_matrices; bucket-parity test).
        face_lists = self.app.get_batch([loaded[i][0] for i in idxs])
        for i, faces in zip(idxs, face_lists):
            data, reason = self._gate_face(self._best_face(faces), sources[i])
            if data is not None and loaded[i][1]:
                data["saved_image_path"] = loaded[i][1]
            out[i] = (data, reason)
        return out

    # ------------------------------------------------------- person CRUD

    def add_person(self, name: str, image_source: str,
                   embedding_data: Dict[str, Any]) -> int:
        """SQLite insert + gallery upsert with rollback (:1531-1602)."""
        if self.db.find_person_by_hash(embedding_data["face_hash"]) is not None:
            logger.info("duplicate face hash for: %s", name)
            return -1
        pid = self.db.insert_person(
            name, image_source, embedding_data["quality"]["overall"],
            embedding_data["face_hash"], embedding_data["quality"])
        ok = self.vector_db.add_embedding(
            pid, embedding_data["embedding"],
            payload={"name": name,
                     "quality": embedding_data["quality"]["overall"],
                     "image_path": image_source,
                     "face_hash": embedding_data["face_hash"]})
        if not ok:
            self.db.delete_person(pid)
            return -1
        return pid

    def search_person(self, query_embedding: np.ndarray, k: int = 5
                      ) -> List[Dict[str, Any]]:
        """k-NN with the reference's result dict shape (:1619-1643)."""
        hits = self.vector_db.search_similar(query_embedding, k=k,
                                             threshold=self.similarity_thresh)
        return [{"person_id": h.id, "similarity": h.score,
                 "name": h.payload.get("name", f"Person_{h.id}"),
                 **{k2: v for k2, v in h.payload.items() if k2 != "name"}}
                for h in hits]

    def is_duplicate_image(self, image_url: str, embedding: np.ndarray) -> bool:
        """URL-seen or >=dup-threshold embedding match (:2618-2652)."""
        if self.db.image_url_seen(image_url):
            return True
        if self.vector_db.get_embedding_count() > 0:
            thr = self.config["face_recognition"]["duplicate_similarity_threshold"]
            hits = self.vector_db.search_similar(embedding, k=1, threshold=thr)
            if hits:
                return True
        return False

    # --------------------------------------------------------- clustering

    def load_visit_data(self, json_file_path: str) -> List[Dict[str, Any]]:
        import json as _json

        with open(json_file_path, "r", encoding="utf-8") as f:
            data = _json.load(f)
        visits = data.get("visits", [])
        return [v for v in visits
                if v.get("image") and v.get("image").startswith("http")]

    def _empty_results(self) -> Dict[str, int]:
        return {"processed": 0, "recognized": 0, "new_persons": 0,
                "no_faces": 0, "low_quality": 0, "download_failed": 0,
                "duplicate_faces": 0, "low_similarity": 0}

    def _visit_record(self, visit, visit_id, customer_id, entry_time,
                      image_url, similarity):
        return {
            "visit_id": visit_id, "customer_id": customer_id,
            "customerId": visit.get("customerId", customer_id),
            "image_url": image_url, "image": visit.get("image", image_url),
            "entry_time": entry_time,
            "entryTime": visit.get("entryTime", entry_time),
            "similarity": similarity,
            "branchId": visit.get("branchId", ""),
            "camera": visit.get("camera", ""),
            "entryEventIds": visit.get("entryEventIds", []),
            "customer": visit.get("customer", {}),
            "results": visit.get("results", {}),
        }

    def _cluster_visits(self, visits: List[Dict[str, Any]],
                        grouping_threshold: float,
                        output_folder: Optional[str], save_images: bool,
                        pre_bbox_gate: bool = False):
        """Shared clustering loop for both entry points."""
        results = self._empty_results()
        batch_groups: List[Dict[str, Any]] = []

        # Optional pre-download side-face gate from the visit's own bbox
        # (process_visit_data_from_json only, :2101).
        active: List[Dict[str, Any]] = []
        for i, visit in enumerate(visits):
            if pre_bbox_gate:
                is_side, reason, _ = Q.check_side_face_from_json_bbox(
                    visit, self.config)
                if is_side:
                    visit_id = visit.get("id", f"visit_{i}")
                    self.db.store_low_similarity(
                        str(visit_id), visit.get("customerId", f"customer_{i}"),
                        visit.get("entryTime", ""), visit.get("image"), None,
                        0.0, None, f"Side face (bbox): {reason}")
                    results["low_quality"] += 1
                    continue
            active.append((i, visit))

        images_dir = (os.path.join(output_folder, "downloaded_images")
                      if (output_folder and save_images) else None)
        self._set_progress("running", "download+embed", len(active), 0)
        try:
            return self._cluster_active(active, embeddings_dir=images_dir,
                                        save_images=save_images,
                                        grouping_threshold=grouping_threshold,
                                        output_folder=output_folder,
                                        results=results,
                                        batch_groups=batch_groups)
        except Exception:
            # a batch-level failure (device OOM, DB error, ...) must not
            # leave /api/job-progress wedged at "running"
            self._set_progress("error", "failed", len(active), 0)
            raise

    def _cluster_active(self, active, *, embeddings_dir, save_images,
                        grouping_threshold, output_folder, results,
                        batch_groups):
        images_dir = embeddings_dir
        embeddings = self.extract_batch_detail(
            [v.get("image") for _, v in active], save_image=save_images,
            output_dir=images_dir)
        self._set_progress("running", "clustering", len(active), 0)

        # Per-visit fault isolation: one bad visit (DB error, malformed
        # record, ...) must not kill the batch — the reference wraps every
        # visit and counts unexpected failures as no_faces
        # (smart_face_recognition.py:1973-1977).
        # ONE batched device search against the pre-batch gallery
        # (batching turns N device round trips into 1). Persons added
        # DURING the batch are matched host-side in _decide_visit
        # (batch_added below) — together equivalent to the sequential
        # per-visit top-1 search.
        emb_idx = [j for j, (ed, _) in enumerate(embeddings)
                   if ed is not None]
        pre_hits = {}
        if emb_idx and self.vector_db.get_embedding_count() > 0:
            q = np.stack([embeddings[j][0]["embedding"] for j in emb_idx])
            hit_lists = self.vector_db.search_batch(q, k=5)
            pre_hits = dict(zip(emb_idx, hit_lists))
        batch_added: List[tuple] = []   # (pid, name, normed embedding)

        for n, ((i, visit), (embedding_data, reason)) in enumerate(
                zip(active, embeddings)):
            try:
                self._decide_visit(i, visit, embedding_data, reason,
                                   grouping_threshold, output_folder,
                                   results, batch_groups,
                                   pre_hits.get(n), batch_added)
            except Exception as e:
                logger.error("Error processing visit %s: %s", i, e)
                results["no_faces"] += 1
            self._set_progress("running", "clustering", len(active), n + 1)

        if batch_groups:
            self.json_storage.save_clustering_results(
                groups=batch_groups, total_processed=results["processed"],
                results=results)
        self._autosnapshot()   # persist the gallery the batch just built
        self._set_progress("idle", "done", len(active), len(active))
        return results, batch_groups

    @staticmethod
    def _best_candidate(embedding, pre_hits, batch_added):
        """Best (person_id, name, similarity) over the pre-batch gallery
        top-k (device, batched once per batch) and persons added during
        this batch (host dot products) — equivalent to a sequential
        per-visit top-1 search over the live gallery."""
        best_id, best_name, best_sim = None, None, -1.0
        if pre_hits:
            h = pre_hits[0]
            best_id, best_sim = h.id, h.score
            best_name = h.payload.get("name", f"Person_{h.id}")
        if batch_added:
            e = np.asarray(embedding, np.float32)
            e = e / max(float(np.linalg.norm(e)), 1e-12)
            for pid, name, vec in batch_added:
                s = float(vec @ e)
                if s > best_sim:
                    best_id, best_name, best_sim = pid, name, s
        return best_id, best_name, best_sim

    def _decide_visit(self, i, visit, embedding_data, reason,
                      grouping_threshold, output_folder, results,
                      batch_groups, pre_hits=None, batch_added=None) -> None:
        """One visit's clustering decision (reference :2086-2250 body).

        Counter split: the reference initializes download_failed /
        low_quality (:1754-1763) but folds every extraction failure into
        no_faces (:2117); here each failure is counted under its true
        cause so the counters carry signal.
        """
        visit_id = str(visit.get("id", f"visit_{i}"))
        image_url = visit.get("image")
        customer_id = visit.get("customerId", f"customer_{i}")
        entry_time = visit.get("entryTime", "")

        if embedding_data is None:
            msg, counter = {
                "download_failed": ("Image download failed",
                                    "download_failed"),
                "low_quality": ("Face quality extremely low",
                                "low_quality"),
            }.get(reason, ("No face detected, low confidence, or side "
                           "face", "no_faces"))
            self.db.store_low_similarity(
                visit_id, customer_id, entry_time, image_url, None, 0.0,
                None, msg)
            results[counter] += 1
            return

        if batch_added is None:
            batch_added = []
        best_id, best_name, best_sim = self._best_candidate(
            embedding_data["embedding"], pre_hits, batch_added)
        if pre_hits is None and batch_added == [] and (
                self.vector_db.get_embedding_count() > 0):
            # direct (non-batched) callers: fall back to a device search
            hits = self.vector_db.search_similar(
                embedding_data["embedding"], k=5)
            if hits:
                best_id, best_sim = hits[0].id, hits[0].score
                best_name = hits[0].payload.get("name",
                                                f"Person_{best_id}")

        dup_thr = self.config["face_recognition"][
            "duplicate_similarity_threshold"]
        if self.db.image_url_seen(image_url) or best_sim >= dup_thr:
            results["duplicate_faces"] += 1
            return

        results["processed"] += 1
        saved_path = embedding_data.get("saved_image_path")

        if best_id is None:
            person_name = f"Person_{customer_id}_{int(time.time())}"
            pid = self.add_person(person_name, image_url, embedding_data)
            if pid > 0:
                self._note_added(batch_added, pid, person_name,
                                 embedding_data["embedding"])
                self.db.store_visit(pid, visit_id, customer_id, entry_time,
                                    image_url, saved_path, 1.0)
                batch_groups.append({
                    "person_id": pid, "person_name": person_name,
                    "visits": [self._visit_record(
                        visit, visit_id, customer_id, entry_time,
                        image_url, 1.0)]})
                results["new_persons"] += 1
            else:
                results["duplicate_faces"] += 1
            return

        # threshold filter the sequential search applied (search_person
        # passes threshold=self.similarity_thresh)
        best = best_sim >= self.similarity_thresh
        similarity = best_sim if best else 0.0

        if best and similarity >= grouping_threshold:
            pid, person_name = best_id, best_name
            self.db.update_person_stats(pid)
            self.db.store_visit(pid, visit_id, customer_id, entry_time,
                                image_url, saved_path, similarity)
            batch_groups.append({
                "person_id": pid, "person_name": person_name,
                "visits": [self._visit_record(
                    visit, visit_id, customer_id, entry_time, image_url,
                    similarity)]})
            if output_folder:
                person_folder = os.path.join(
                    output_folder, f"{person_name}_{pid}")
                os.makedirs(person_folder, exist_ok=True)
                import json as _json

                with open(os.path.join(person_folder,
                                       f"visit_{visit_id}.json"), "w") as f:
                    _json.dump({
                        "visit_id": visit_id, "customer_id": customer_id,
                        "entry_time": entry_time, "image_url": image_url,
                        "saved_image_path": saved_path,
                        "similarity": similarity,
                        "processed_at": datetime.now().isoformat()}, f,
                        indent=2)
            results["recognized"] += 1
        else:
            person_name = f"Person_{customer_id}_{int(time.time())}"
            pid = self.add_person(person_name, image_url, embedding_data)
            if pid > 0:
                self._note_added(batch_added, pid, person_name,
                                 embedding_data["embedding"])
                self.db.store_visit(pid, visit_id, customer_id, entry_time,
                                    image_url, saved_path, similarity)
                batch_groups.append({
                    "person_id": pid, "person_name": person_name,
                    "visits": [self._visit_record(
                        visit, visit_id, customer_id, entry_time,
                        image_url, similarity)]})
                results["new_persons"] += 1
            else:
                results["duplicate_faces"] += 1

    @staticmethod
    def _note_added(batch_added, pid, name, embedding) -> None:
        e = np.asarray(embedding, np.float32)
        e = e / max(float(np.linalg.norm(e)), 1e-12)
        batch_added.append((pid, name, e))

    def process_visit_data(self, json_file_path: str,
                           output_folder: Optional[str] = None,
                           max_visits: Optional[int] = None,
                           save_images: bool = True) -> Dict[str, int]:
        """File entry point (:1721-2005), grouping_threshold_file."""
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)
        visits = self.load_visit_data(json_file_path)
        if max_visits and max_visits < len(visits):
            visits = visits[:max_visits]
        thr = self.config["face_recognition"]["grouping_threshold_file"]
        results, _ = self._cluster_visits(visits, thr, output_folder,
                                          save_images)
        return results

    def process_visit_data_from_json(self, json_data: Dict[str, Any],
                                     output_folder: Optional[str] = None,
                                     max_visits: Optional[int] = None,
                                     save_images: bool = True,
                                     clear_existing: bool = False
                                     ) -> Dict[str, int]:
        """In-memory entry point (:2007-2318): stricter
        grouping_threshold_json + pre-download bbox side-face gate."""
        if clear_existing:
            self.clear_all_data()
        visits = [v for v in json_data.get("visits", [])
                  if v.get("image") and v.get("image").startswith("http")]
        if max_visits and max_visits < len(visits):
            visits = visits[:max_visits]
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)
        thr = self.config["face_recognition"]["grouping_threshold_json"]
        results, _ = self._cluster_visits(visits, thr, output_folder,
                                          save_images, pre_bbox_gate=True)
        return results

    # -------------------------------------------------------- API ingest

    def fetch_visit_data_from_api(self, api_url: str, start_date=None,
                                  end_date=None, page: int = 0,
                                  limit: int = 100, start_time=None,
                                  end_time=None, all_branch: bool = True,
                                  api_key=None, auth_token=None):
        """Fetch + transform visit records from the analytics REST API.

        Parameter surface and field mapping mirror
        smart_face_recognition.py:695-876 (page/limit/allBranch/date/time
        query params, faceResponse image-url fallbacks, entry/exit mapping).
        Returns [] on any failure.
        """
        import json as _json
        import urllib.parse
        import urllib.request

        params = {"page": page, "limit": limit,
                  "allBranch": str(all_branch).lower(),
                  "nolimit": "false", "isZone": "false",
                  "BlackListed": "false", "Vip": "false", "Vendor": "false",
                  "isDeleted": "false"}
        if start_date:
            params["date"] = start_date
        if end_date:
            # the reference accepts end_date but silently drops it
            # (smart_face_recognition.py:725 "single date parameter");
            # we forward it so the UI's range filter actually filters
            params["endDate"] = end_date
        if start_time:
            params["startTime"] = start_time
        if end_time:
            params["endTime"] = end_time
        headers = {}
        if api_key:
            headers["X-API-Key"] = api_key
        if auth_token:
            headers["Authorization"] = f"Bearer {auth_token}"
        try:
            url = api_url + "?" + urllib.parse.urlencode(params)
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=30) as resp:
                data = _json.loads(resp.read())
        except Exception as e:
            logger.error("API request failed: %s", e)
            return []

        if isinstance(data, list):
            raw_visits = data
        elif isinstance(data, dict):
            raw_visits = data.get("list", data.get("data", data.get(
                "visits", data.get("results", []))))
        else:
            return []

        return self._transform_api_visits(raw_visits)

    @classmethod
    def _transform_api_visits(cls, raw_visits) -> List[Dict[str, Any]]:
        visits = []
        for visit in raw_visits:
            try:
                transformed = cls._transform_api_visit(visit)
            except Exception as e:
                # one malformed record (e.g. a scalar where a dict is
                # expected) must not abort the whole fetch
                logger.warning("skipping malformed API visit record: %s", e)
                continue
            if transformed is not None:
                visits.append(transformed)
        return visits

    @staticmethod
    def _transform_api_visit(visit: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Map one raw API record to the visit schema (reference :820-876);
        returns None when the record carries no usable http image URL."""
        image_url = None
        fr = visit.get("faceResponse")
        if fr and isinstance(fr, dict):
            # nested fields can be null / non-dict in real payloads
            image_url = ((fr.get("boxData") or {}).get("imageUrl")
                         or (fr.get("faceResponse") or {}).get("imageUrl")
                         or fr.get("imageUrl") or fr.get("image"))
        else:
            for key in ("imageUrl", "image", "faceImage", "face_image",
                        "photo", "photoUrl"):
                if visit.get(key):
                    image_url = visit[key]
                    break

        def _nested(field, key):
            # faceResponse.age/.gender arrive as {"low": n}/{"value": s}
            # dicts but real payloads also carry bare scalars
            v = (fr or {}).get(field) if isinstance(fr, dict) else None
            if isinstance(v, dict):
                return v.get(key)
            return v

        transformed = {
            "visit_id": visit.get("id", visit.get("visitId",
                                                  visit.get("visit_id"))),
            "id": visit.get("id", visit.get("visitId")),
            "customer_id": visit.get("customerId",
                                     visit.get("customer_id")),
            "customerId": visit.get("customerId",
                                    visit.get("customer_id")),
            "image": image_url,
            "entry_time": visit.get("timestamp", visit.get(
                "entryTime", visit.get("entry_time"))),
            "entryTime": visit.get("timestamp", visit.get(
                "entryTime", visit.get("entry_time"))),
            "event": "entry" if visit.get("isEntry", False) else "exit",
            "camera": visit.get("camera", visit.get("cameraName",
                                                    "Unknown")),
            "branchId": visit.get("branchId", visit.get("branch_id",
                                                        "Unknown")),
            "age": _nested("age", "low"),
            "gender": _nested("gender", "value"),
            "similarity": visit.get("confidence",
                                    visit.get("similarity", 1.0)),
            "entryEventIds": visit.get("entryEventIds", []),
        }
        if transformed["image"] and str(transformed["image"]).startswith("http"):
            return transformed
        return None

    # ----------------------------------------------------- dedup + merge

    def merge_duplicate_persons(self, person_id1: int, person_id2: int) -> None:
        """Repoint visits, add match counts, drop person2 (:2679-2724)."""
        self.db.repoint_visits(person_id2, person_id1)
        self.vector_db.delete_embedding(person_id2)

    def find_and_merge_duplicates(self, similarity_threshold: Optional[float]
                                  = None, return_pairs: bool = False):
        """ONE G x G cosine matmul + union-find, replacing the per-person
        Qdrant loop (:2726-2797). Groups merge into their lowest id.
        Returns the merge count, or (count, [{kept, merged, name}]) with
        return_pairs=True (the web UI's merge summary)."""
        if similarity_threshold is None:
            similarity_threshold = \
                self.config["face_recognition"]["merge_duplicate_threshold"]
        merged, pairs = 0, []
        if self.vector_db.get_embedding_count() >= 2:
            # tier-blind merge worklist: blocked pair scan past 8k rows,
            # so this works at the PQ tier's million-identity scale
            for group in self.vector_db.duplicate_groups(
                    similarity_threshold):
                keep = group[0]
                for other in group[1:]:
                    gone = self.db.get_person(other)
                    self.merge_duplicate_persons(keep, other)
                    merged += 1
                    pairs.append({"kept": keep, "merged": other,
                                  "name": (gone or {}).get("name", "")})
        if merged:
            self._autosnapshot()   # merges mutated both stores
        return (merged, pairs) if return_pairs else merged

    # ------------------------------------------------------- stats / web

    def get_database_stats(self) -> Dict[str, Any]:
        s = self.db.stats()
        return {"total_persons": s["total_persons"],
                "average_quality": s["average_quality"],
                "recent_activity": s["recent_activity"],
                "embeddings_loaded": self.vector_db.get_embedding_count()}

    def get_web_stats(self) -> Dict[str, Any]:
        s = self.db.stats()
        return {"total_persons": s["total_persons"],
                "total_visits": s["total_visits"],
                "total_images": s["total_images"],
                "low_similarity_count": s["low_similarity_count"],
                "recent_activity": s["recent_activity"]}

    def get_person_groups_for_web(self) -> List[Dict[str, Any]]:
        return self.db.person_groups()

    def get_low_similarity_images(self) -> List[Dict[str, Any]]:
        rows = self.db.low_similarity_rows()
        out = []
        for r in rows:
            display = r["saved_image_path"] or r["image_url"]
            sim = r["similarity"]
            out.append({"visit_id": r["visit_id"],
                        "customer_id": r["customer_id"],
                        "entry_time": r["entry_time"],
                        "image_url": r["image_url"], "image_path": display,
                        "similarity": max(0, min(100, sim * 100)) if sim else 0,
                        "best_match_name": r["best_match_name"],
                        "reason": r["reason"] or "Low similarity",
                        "processed_at": r["processed_at"]})
        return out

    def clear_all_data(self) -> None:
        self.db.clear_all()
        self.vector_db.clear_all()
        self._autosnapshot()   # an empty generation is still a generation

    # -------------------------------------------------------- comparison

    def compare_face_images(self, image1, image2) -> Dict[str, Any]:
        """Pairwise verification with the reference's rich result payload
        (smart_face_recognition.py:878-1144): same_person / confidence /
        threshold_used / image urls / error, PLUS per-face diagnostic
        detail (det confidence, bbox, the quality-gate component scores,
        side-face verdict) so callers can see WHY a comparison resolved
        the way it did. The condensed keys (similarity/threshold/
        face{1,2}_confidence) are kept for compatibility."""
        def failure(msg):
            return {"success": False, "same_person": False,
                    "confidence": 0.0, "error": msg,
                    "image1_url": image1 if isinstance(image1, str) else None,
                    "image2_url": image2 if isinstance(image2, str) else None}

        img1 = self.image_loader(image1) if isinstance(image1, str) else image1
        img2 = self.image_loader(image2) if isinstance(image2, str) else image2
        if img1 is None or img2 is None:
            return failure("Could not download one or both images")
        faces = self.app.get_batch([np.asarray(img1), np.asarray(img2)])
        f1, f2 = self._best_face(faces[0]), self._best_face(faces[1])
        if f1 is None or f2 is None:
            return failure("Could not detect faces in one or both images")

        def face_detail(face, n_candidates):
            q = Q.assess_face_quality(face, self.config)
            return {"det_score": float(face.det_score),
                    "bbox": [float(v) for v in np.asarray(face.bbox)],
                    "n_faces_in_image": int(n_candidates),
                    "is_side_face": bool(Q.is_side_face(face, self.config)),
                    "quality": {k: float(v) for k, v in q.items()}}

        e1, e2 = f1.normed_embedding, f2.normed_embedding
        sim = float(np.dot(e1, e2))
        thr = self.config["face_comparison"]["similarity_threshold"]
        return {"success": True, "error": None,
                "same_person": sim > thr,
                "confidence": sim, "similarity": sim,
                "threshold_used": thr, "threshold": thr,
                "image1_url": image1 if isinstance(image1, str) else None,
                "image2_url": image2 if isinstance(image2, str) else None,
                "face1": face_detail(f1, len(faces[0])),
                "face2": face_detail(f2, len(faces[1])),
                "face1_confidence": f1.det_score,
                "face2_confidence": f2.det_score}

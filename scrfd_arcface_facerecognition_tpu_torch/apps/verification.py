"""Pairwise face verification vs external-API verdicts.

Behavioral mirror of the reference's compare_face_from_api.py: fetch
(image, refImage) record pairs, embed both faces, compare cosine similarity
against the face_comparison threshold (0.2, config.json:28), and report
agreement with the API's own isConverted verdict (:401-521).

All 2N images of a wave embed through ONE device call
(FaceAnalysis.get_batch) instead of one ONNX round-trip per image.
Note the reference feeds RGB into FaceAnalysis here (:145, unlike the
clustering engine which feeds BGR) — preserved for behavioral parity, as
a channel flip (no cv2: loaders are injected). The JAX package's
``apps/verification.py`` is the reference for this port.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..device import resolve_device
from ..utils.config import load_config
from .face_analysis import FaceAnalysis
from .clustering import default_image_loader

logger = logging.getLogger(__name__)


_COMPARISON_HANDLER = "face_comparison_file"


def enable_comparison_log(path: str = "face_comparison.log") -> None:
    """Attach the dedicated comparison log file the reference writes
    (compare_face_from_api.py:58-61: FileHandler('face_comparison.log') +
    stream handler on the module logger). delay=True: the file is only
    created when a comparison actually logs. Exactly ONE comparison file
    handler lives on the module logger — re-enabling with a different path
    replaces it (instances with different log_file values would otherwise
    accumulate handlers and duplicate every line into stale files)."""
    for h in list(logger.handlers):
        if getattr(h, "name", None) != _COMPARISON_HANDLER:
            continue
        if getattr(h, "baseFilename", "").endswith(path):
            return                      # already logging to this file
        logger.removeHandler(h)
        h.close()
    handler = logging.FileHandler(path, delay=True)
    handler.name = _COMPARISON_HANDLER
    handler.setFormatter(logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)


def build_comparison_results_json(results: Dict[str, Any]) -> Dict[str, Any]:
    """The face_comparison_results_<ts>.json payload, field-for-field per
    smart_face_recognition.py:3164-3232: metadata {generated_at,
    total_comparisons, same_person, different_person, errors,
    accuracy_vs_api} + comparisons [{fileName, event, camera, eventId,
    approve, match_status, branch_id}] pulled from each comparison's
    raw_data.entryEventIds[0] (eventId falls back to the comparison's own
    event_id when no entry events exist and it is a string)."""
    from datetime import datetime

    payload = {
        "metadata": {
            "generated_at": datetime.now().isoformat(),
            "total_comparisons": results.get("total_comparisons", 0),
            "same_person": results.get("same_person", 0),
            "different_person": results.get("different_person", 0),
            "errors": results.get("errors", 0),
            "accuracy_vs_api": results.get("accuracy_vs_api", 0),
        },
        "comparisons": [],
    }
    for comparison in results.get("results", []):
        raw = comparison.get("raw_data", {}) or {}
        events = raw.get("entryEventIds", []) or []
        file_name = event = camera = event_id = ""
        if events and isinstance(events[0], dict):
            e0 = events[0]
            file_name = e0.get("fileName", "")
            event = e0.get("event", "")
            camera = e0.get("camera", "")
            event_id = e0.get("eventId", "")
        else:
            eid = comparison.get("event_id", "")
            if isinstance(eid, str):
                event_id = eid
        payload["comparisons"].append({
            "fileName": file_name,
            "event": event,
            "camera": camera,
            "eventId": event_id,
            "approve": comparison.get("api_approve", False),
            "match_status": comparison.get("match_status", "UNKNOWN"),
            "branch_id": comparison.get("branch_id", ""),
        })
    return payload


class FaceComparison:
    def __init__(self, config_file: str = "config.json",
                 config: Optional[Dict[str, Any]] = None,
                 app: Optional[FaceAnalysis] = None,
                 image_loader: Callable = default_image_loader,
                 log_file: Optional[str] = "face_comparison.log",
                 device=None):
        # the facade it builds lives on ``device``: the CUDA card unless
        # device="cpu" is passed
        self.device = resolve_device(device)
        if log_file:
            enable_comparison_log(log_file)
        self.config = config if config is not None else load_config(config_file)
        self.similarity_threshold = \
            self.config["face_comparison"]["similarity_threshold"]
        self.image_loader = image_loader
        if app is None:
            app = FaceAnalysis(det_variant=self.config["system"]["det_variant"],
                               rec_variant=self.config["system"]["rec_variant"],
                               device=self.device)
            app.prepare(ctx_id=0, det_size=tuple(
                self.config["face_detection"]["detection_size"]))
        self.app = app

    @staticmethod
    def calculate_face_similarity(e1: np.ndarray, e2: np.ndarray) -> float:
        denom = np.linalg.norm(e1) * np.linalg.norm(e2)
        return float(np.dot(e1, e2) / denom) if denom else 0.0

    def _to_rgb(self, image: np.ndarray) -> np.ndarray:
        if image.ndim == 3 and image.shape[2] == 3:
            return np.ascontiguousarray(image[..., ::-1])
        return image

    def compare_face_images(self, image1_url: str, image2_url: str) -> Dict:
        img1 = self.image_loader(image1_url)
        img2 = self.image_loader(image2_url)
        base = {"image1_url": image1_url, "image2_url": image2_url}
        if img1 is None or img2 is None:
            return {**base, "same_person": False, "confidence": 0.0,
                    "error": "Could not download one or both images"}
        faces = self.app.get_batch([self._to_rgb(img1), self._to_rgb(img2)])
        if not faces[0] or not faces[1]:
            return {**base, "same_person": False, "confidence": 0.0,
                    "error": "Could not detect faces in one or both images"}
        sim = self.calculate_face_similarity(faces[0][0].embedding,
                                             faces[1][0].embedding)
        return {**base, "same_person": sim > self.similarity_threshold,
                "confidence": float(sim),
                "threshold_used": self.similarity_threshold, "error": None}

    def _compare_batch(self, records: List[Dict],
                       wave: int = 64) -> List[Dict]:
        """Batched comparison in bounded waves: concurrent downloads + one
        get_batch per wave of `wave` records (the reference runs app.get
        twice per record sequentially, compare_face_from_api.py:204-205).
        Waves bound host memory: 2*wave decoded images resident, not 2*N.
        """
        out: List[Dict] = []
        for c in range(0, len(records), wave):
            out.extend(self._compare_wave(records[c:c + wave]))
        return out

    def _compare_wave(self, records: List[Dict]) -> List[Dict]:
        from concurrent.futures import ThreadPoolExecutor

        urls = []
        for r in records:
            urls.extend((r["image1_url"], r["image2_url"]))
        with ThreadPoolExecutor(max_workers=8) as pool:
            images = list(pool.map(self.image_loader, urls))

        present = [i for i, im in enumerate(images) if im is not None]
        face_lists: Dict[int, list] = {}
        if present:
            batch_faces = self.app.get_batch(
                [self._to_rgb(images[i]) for i in present])
            face_lists = dict(zip(present, batch_faces))

        out = []
        for ri, r in enumerate(records):
            base = {"image1_url": r["image1_url"],
                    "image2_url": r["image2_url"]}
            i1, i2 = 2 * ri, 2 * ri + 1
            if images[i1] is None or images[i2] is None:
                out.append({**base, "same_person": False, "confidence": 0.0,
                            "error": "Could not download one or both images"})
                continue
            f1 = face_lists.get(i1) or []
            f2 = face_lists.get(i2) or []
            if not f1 or not f2:
                out.append({**base, "same_person": False, "confidence": 0.0,
                            "error": "Could not detect faces in one or both "
                                     "images"})
                continue
            sim = self.calculate_face_similarity(f1[0].embedding,
                                                 f2[0].embedding)
            out.append({**base,
                        "same_person": sim > self.similarity_threshold,
                        "confidence": float(sim),
                        "threshold_used": self.similarity_threshold,
                        "error": None})
        return out

    def fetch_face_comparison_data_from_api(self, api_url: str,
                                            api_key: Optional[str] = None,
                                            **params) -> List[Dict]:
        """Fetch + transform visit records (:247-399). Uses urllib; returns
        [] on any network failure (zero-egress environments)."""
        import json as _json
        import urllib.parse
        import urllib.request

        try:
            query = urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
            url = api_url + ("?" + query if query else "")
            headers = {"User-Agent": "Mozilla/5.0"}
            if api_key:
                headers["Authorization"] = f"Bearer {api_key}"
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=30) as resp:
                data = _json.loads(resp.read())
        except Exception as e:
            logger.error("API request failed: %s", e)
            return []
        raw = data if isinstance(data, list) else data.get(
            "visits", data.get("data", []))
        return self.transform_records(raw)

    @staticmethod
    def transform_records(raw_visits: List[Dict]) -> List[Dict]:
        """API visit -> comparison-record mapping (:342-385)."""
        records = []
        for visit in raw_visits:
            image1 = visit.get("image")
            image2 = visit.get("refImage")
            if not image1 or not image2:
                continue
            events = visit.get("entryEventIds") or []
            event = events[0] if events and isinstance(events[0], dict) else None
            records.append({
                "comparison_id": visit.get("id", f"comparison_{len(records)}"),
                "event_id": event.get("eventId") if event else None,
                "approve": visit.get("isConverted", False),
                "image1_url": image1, "image2_url": image2,
                "branch_id": visit.get("branchId"),
                "created_at": visit.get("entryTime"),
                "customer_info": [visit["customerId"]] if visit.get("customerId") else [],
                "matched_info": [visit["refImage"]] if visit.get("refImage") else [],
                "message": f"Visit comparison for customer "
                           f"{visit.get('customerId', 'unknown')}",
                "is_first_visit": visit.get("isFirstVisit", False),
                "is_vip": visit.get("isVip", False),
                "is_blacklisted": visit.get("isBlackListed", False),
                "fileName": event.get("fileName", "") if event else "",
                "event": event.get("event", "") if event else "",
                "camera": event.get("camera", "") if event else "",
                "raw_data": visit,
            })
        return records

    def process_face_comparisons(self, comparison_records: List[Dict],
                                 max_comparisons: Optional[int] = None) -> Dict:
        """Sequential comparison loop + accuracy-vs-API summary (:401-521)."""
        if not comparison_records:
            return {"total_comparisons": 0, "processed": 0, "same_person": 0,
                    "different_person": 0, "errors": 0, "results": []}
        if max_comparisons and len(comparison_records) > max_comparisons:
            comparison_records = comparison_records[:max_comparisons]

        comparisons = self._compare_batch(comparison_records)

        results, same_n, diff_n, err_n = [], 0, 0, 0
        for record, cmp in zip(comparison_records, comparisons):
            results.append({
                "comparison_id": record["comparison_id"],
                "event_id": record["event_id"],
                "branch_id": record["branch_id"],
                "created_at": record["created_at"],
                "customer_info": record["customer_info"],
                "matched_info": record["matched_info"],
                "api_approve": record["approve"],
                "our_result": cmp.get("same_person", False),
                "confidence": cmp.get("confidence", 0.0),
                "threshold_used": cmp.get("threshold_used",
                                          self.similarity_threshold),
                "image1_url": cmp.get("image1_url", ""),
                "image2_url": cmp.get("image2_url", ""),
                "error": cmp.get("error"),
                "match_status": "SAME" if cmp.get("same_person") else "DIFFERENT",
                "api_vs_our_match": record["approve"] == cmp.get("same_person",
                                                                 False),
                "raw_data": record.get("raw_data", {}),
            })
            if cmp.get("error"):
                err_n += 1
            elif cmp.get("same_person"):
                same_n += 1
            else:
                diff_n += 1

        for r in results:
            logger.info(
                "Comparison %s: %s (confidence %.4f, api_approve=%s)",
                r["comparison_id"], r["match_status"], r["confidence"],
                r["api_approve"])
        api_matches = sum(1 for r in results if r.get("api_vs_our_match") is True)
        with_api = sum(1 for r in results
                       if r.get("api_vs_our_match") is not None)
        accuracy = (api_matches / with_api * 100) if with_api else 0
        logger.info("Processed %d comparisons: %d same, %d different, "
                    "%d errors", len(results), same_n, diff_n, err_n)
        return {"total_comparisons": len(comparison_records),
                "processed": len(results), "same_person": same_n,
                "different_person": diff_n, "errors": err_n,
                "accuracy_vs_api": accuracy, "api_matches": api_matches,
                "total_with_api_data": with_api, "results": results}

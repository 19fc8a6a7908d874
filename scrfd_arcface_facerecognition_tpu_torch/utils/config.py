"""Configuration system.

Replicates the reference's three config mechanisms:
1. config.json with defaults fallback (smart_face_recognition.py:153-191);
   the key set mirrors the reference's config.json:1-102.
2. api_config.txt KEY=VALUE parsing (smart_face_recognition.py:43-96).
3. argparse CLIs live with their apps.

A copy of the JAX package's ``utils/config.py`` (host code, no framework):
the same defaults, key for key, so a config file means the same to both.
"""
from __future__ import annotations

import copy
import json
import logging
import os
from typing import Any, Dict

logger = logging.getLogger(__name__)

# Mirrors the reference's config.json: every key the engine consumes.
DEFAULT_CONFIG: Dict[str, Any] = {
    "system": {
        "database_path": "face_database.db",
        "model_name": "buffalo_l",
        "det_variant": "det_10g",          # model selection (new)
        "rec_variant": "w600k_r50",
        "gpu_id": 0,
        "image_cache_dir": "image_cache",
    },
    "face_detection": {
        "detection_size": [640, 640],
        "confidence_threshold": 0.6,
        "quality_threshold": 0.25,
        "min_quality_threshold": 0.05,
        "pose_angle_threshold": 35.0,
        "yaw_threshold": 35.0,
        "pitch_threshold": 35.0,
    },
    "face_recognition": {
        "similarity_threshold": 0.35,
        "grouping_threshold_file": 0.45,
        "grouping_threshold_json": 0.55,
        "duplicate_similarity_threshold": 0.95,
        "merge_duplicate_threshold": 0.8,
    },
    "face_comparison": {
        "similarity_threshold": 0.2,
        "confidence_threshold": 0.3,
    },
    "face_quality": {
        "weights": {
            "detection_score": 0.4,
            "size_score": 0.2,
            "blur_score": 0.2,
            "pose_score": 0.1,
            "lighting_score": 0.1,
        },
        "size_normalization": 10000,
        "min_overall_score": 0.1,
    },
    "side_face_detection": {
        "aspect_ratio_thresholds": {
            "extreme_profile": 0.2,
            "very_strong_profile": 0.3,
            "strong_profile": 0.5,
            "very_wide": 2.5,
            "wide": 2.0,
            "moderately_wide": 1.6,
        },
        "area_thresholds": {
            "extremely_small": 1200,
            "very_small": 1800,
            "small": 2500,
            "very_large": 400000,
            "large": 300000,
        },
        "compactness_thresholds": {"very_low": 0.10, "low": 0.6},
        "confidence_thresholds": {"very_low": 0.15, "low": 0.7},
        "decision_threshold": 4,
        "edge_position_threshold": 30,
    },
    "image_processing": {
        "web_max_size": [300, 300],
        "jpeg_quality": 85,
        "download_timeout": 30,
        "max_workers": 4,
    },
    "web_interface": {
        "host": "0.0.0.0",
        "port": 8000,
        "cache_control_max_age": 3600,
    },
    "serving": {
        # request micro-batching (runtime/microbatch.py): coalesce
        # concurrent single-image web requests into shared device batches
        # (FaceAnalysis.enable_microbatch). Latency cost is bounded by
        # microbatch_max_wait_ms per request. Off by default: it only
        # helps when requests actually overlap.
        "microbatch": False,
        "microbatch_max_batch": 32,
        "microbatch_max_wait_ms": 4.0,
    },
    "processing": {
        "max_visits_fallback": 149,
        "max_visits_default": 500,
        "save_images_default": True,
        "clear_existing_default": False,
    },
    "http_headers": {
        "user_agent": "Mozilla/5.0",
        "accept": "image/webp,image/apng,image/*,*/*;q=0.8",
        "accept_language": "en-US,en;q=0.9",
        "cache_control": "no-cache",
    },
    "vector_database": {
        "type": "tpu_gallery",
        "mode": "memory",
        "collection_name": "face_embeddings",
        "vector_size": 512,
        "distance_metric": "Cosine",
        # capacity-tier policy (gallery/auto.py AutoGallery):
        # "auto" = dense matmul until the f32 matrix would fill
        # hbm_budget_gb, then migrate to the PQ tier (ADC scoring, kernel
        # K2, + exact rerank); "dense"/"pq" force a tier
        "tier": "auto",
        "hbm_budget_gb": 4.0,
        "pq_min_train_rows": 4096,
        # gallery persistence (apps/clustering.py): non-empty path =>
        # the engine snapshots the vector store after every clustering
        # batch / merge / clear and restores it on construction when the
        # snapshot's recorded person-id generation matches SQLite. The
        # reference silently loses its in-memory Qdrant on restart while
        # SQLite keeps the persons (its load_embeddings is a no-op health
        # check, smart_face_recognition.py:1604-1617) — every returning
        # visitor becomes a new person. Empty string disables (reference
        # parity default).
        "snapshot_path": "",
        # what to do when the snapshot is missing/stale/corrupt while the
        # DB has persons: "error" (refuse to start with a silently empty
        # gallery) or "ignore" (log loudly, start empty — the reference's
        # behavior)
        "snapshot_stale_policy": "error",
    },
}


def deep_update(base: Dict, overrides: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(config_file: str = "config.json") -> Dict[str, Any]:
    """Load config.json, merged over defaults (missing file -> defaults)."""
    if not os.path.exists(config_file):
        logger.info("Configuration file %s not found, using defaults", config_file)
        return copy.deepcopy(DEFAULT_CONFIG)
    with open(config_file, "r") as f:
        user = json.load(f)
    return deep_update(DEFAULT_CONFIG, user)


def load_api_config(path: str = "api_config.txt") -> Dict[str, str]:
    """KEY=VALUE file parser (smart_face_recognition.py:43-96 semantics):
    '#' comments and blank lines skipped, values may contain '='."""
    out: Dict[str, str] = {}
    if not os.path.exists(path):
        return out
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip()
    return out

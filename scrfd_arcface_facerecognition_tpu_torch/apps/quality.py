"""Face quality assessment + side-face gates.

Pure-function ports of the reference's acceptance gates so clustering
behavior matches visit-for-visit:
- assess_face_quality   (smart_face_recognition.py:1145-1216)
- analyze_bbox_for_side_face (:1299-1400, research-scored bbox analysis)
- is_side_face          (:1248-1297; pose branch falls through to bbox
  analysis since SCRFD provides no yaw/pitch, same as buffalo_l here)
- check_side_face_from_json_bbox (:1402-1432)

A copy of the JAX package's ``apps/quality.py`` (numpy only).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def assess_face_quality(face, config: Dict[str, Any]) -> Dict[str, float]:
    """Weighted quality score from detection confidence, size, blur proxy,
    keypoint spread, and lighting proxy."""
    qcfg = config["face_quality"]
    try:
        det_score = float(getattr(face, "det_score", 0.0))
        bbox = face.bbox
        face_area = float((bbox[2] - bbox[0]) * (bbox[3] - bbox[1]))
        size_score = min(1.0, face_area / qcfg["size_normalization"])
        blur_score = min(1.0, det_score * 1.2)
        pose_score = 1.0
        kps = getattr(face, "kps", None)
        if kps is not None and len(kps) >= 5:
            kps = np.asarray(kps)
            x_range = float(np.max(kps[:, 0]) - np.min(kps[:, 0]))
            y_range = float(np.max(kps[:, 1]) - np.min(kps[:, 1]))
            pose_score = min(1.0, (x_range + y_range) / 100)
        lighting_score = min(1.0, det_score * 1.1)
        w = qcfg["weights"]
        overall = (det_score * w["detection_score"] + size_score * w["size_score"]
                   + blur_score * w["blur_score"] + pose_score * w["pose_score"]
                   + lighting_score * w["lighting_score"])
        return {"overall": float(overall), "blur": float(blur_score),
                "pose": float(pose_score), "lighting": float(lighting_score),
                "size": float(size_score)}
    except Exception:
        return {"overall": qcfg["min_overall_score"], "blur": 0.0,
                "pose": 0.0, "lighting": 0.0, "size": 0.0}


def analyze_bbox_for_side_face(bbox_data: Optional[Dict[str, float]],
                               det_score: Optional[float],
                               config: Dict[str, Any]
                               ) -> Tuple[bool, str, int]:
    """Score-based side-face analysis of a width/height/top/left bbox."""
    if not bbox_data:
        return False, "No bbox data", 0
    width = bbox_data.get("width", 0)
    height = bbox_data.get("height", 0)
    top = bbox_data.get("top", 0)
    left = bbox_data.get("left", 0)
    if width <= 0 or height <= 0:
        return False, "Invalid bbox dimensions", 0

    aspect_ratio = width / height
    area = width * height
    perimeter = 2 * (width + height)
    compactness = (4 * 3.14159 * area) / (perimeter * perimeter) if perimeter else 0

    cfg = config["side_face_detection"]
    score = 0
    reasons = []

    ar = cfg["aspect_ratio_thresholds"]
    if aspect_ratio < ar["extreme_profile"]:
        score += 4; reasons.append(f"Extreme profile (ratio: {aspect_ratio:.2f})")
    elif aspect_ratio < ar["very_strong_profile"]:
        score += 3; reasons.append(f"Very strong profile (ratio: {aspect_ratio:.2f})")
    elif aspect_ratio < ar["strong_profile"]:
        score += 2; reasons.append(f"Strong profile (ratio: {aspect_ratio:.2f})")
    elif aspect_ratio > ar["very_wide"]:
        score += 3; reasons.append(f"Very wide face (ratio: {aspect_ratio:.2f})")
    elif aspect_ratio > ar["wide"]:
        score += 2; reasons.append(f"Wide face (ratio: {aspect_ratio:.2f})")
    elif aspect_ratio > ar["moderately_wide"]:
        score += 1; reasons.append(f"Moderately wide (ratio: {aspect_ratio:.2f})")

    at = cfg["area_thresholds"]
    if area < at["extremely_small"]:
        score += 3; reasons.append(f"Extremely small area: {area}")
    elif area < at["very_small"]:
        score += 2; reasons.append(f"Very small area: {area}")
    elif area < at["small"]:
        score += 1; reasons.append(f"Small area: {area}")
    elif area > at["very_large"]:
        score += 2; reasons.append(f"Very large area: {area}")
    elif area > at["large"]:
        score += 1; reasons.append(f"Large area: {area}")

    ct = cfg["compactness_thresholds"]
    if compactness < ct["very_low"]:
        score += 2; reasons.append(f"Very low compactness: {compactness:.2f}")
    elif compactness < ct["low"]:
        score += 1; reasons.append(f"Low compactness: {compactness:.2f}")

    cf = cfg["confidence_thresholds"]
    if det_score is not None and det_score < cf["very_low"]:
        score += 2; reasons.append(f"Very low confidence: {det_score:.3f}")
    elif det_score is not None and det_score < cf["low"]:
        score += 1; reasons.append(f"Low confidence: {det_score:.3f}")

    edge = cfg["edge_position_threshold"]
    if left < edge or top < edge:
        score += 1; reasons.append(f"Face very near edge (left: {left}, top: {top})")

    is_side = score >= cfg["decision_threshold"]
    return is_side, "; ".join(reasons) if reasons else "Normal face", score


def is_side_face(face, config: Dict[str, Any]) -> bool:
    """Reject side-facing faces. The pose-angle branch of the reference is
    dead with buffalo_l (no yaw/pitch attributes) and stays dead here; the
    decision comes from bbox analysis."""
    try:
        yaw = abs(float(getattr(face, "yaw", 0) or 0))
        pitch = abs(float(getattr(face, "pitch", 0) or 0))
        if yaw > 0 or pitch > 0:
            if yaw > config["face_detection"]["yaw_threshold"]:
                return True
            if pitch > config["face_detection"]["pitch_threshold"]:
                return True
            return False
        bbox = getattr(face, "bbox", None)
        if bbox is not None:
            x1, y1, x2, y2 = [float(v) for v in bbox]
            bbox_data = {"width": x2 - x1, "height": y2 - y1,
                         "top": y1, "left": x1}
            is_side, _, _ = analyze_bbox_for_side_face(
                bbox_data, float(getattr(face, "det_score", 0.0)), config)
            return is_side
        return False
    except Exception:
        return False


def check_side_face_from_json_bbox(visit_data: Dict[str, Any],
                                   config: Dict[str, Any]
                                   ) -> Tuple[bool, str, Optional[Dict]]:
    """Pre-download side-face gate using the visit's own bbox metadata."""
    try:
        entry_events = visit_data.get("entryEventIds", [])
        if not entry_events:
            return False, "No entry events", None
        bbox_data = entry_events[0].get("box", {})
        if not bbox_data:
            return False, "No bbox data in entry event", None
        is_side, reason, _ = analyze_bbox_for_side_face(bbox_data, None, config)
        return is_side, reason, bbox_data
    except Exception as e:  # pragma: no cover - defensive parity
        return False, f"Error: {e}", None

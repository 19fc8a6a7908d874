"""User surfaces on the port: the real-time CLI (``realtime``), the
FaceAnalysis facade, the clustering engine, the verification flow, result
export."""

from .face_analysis import Face, FaceAnalysis
from .quality import (
    assess_face_quality, analyze_bbox_for_side_face, is_side_face,
    check_side_face_from_json_bbox,
)
from .json_storage import JSONStorageManager, save_clustering_results
from .metadata_db import MetadataDB
from .clustering import SmartFaceEngine
from .verification import FaceComparison
from . import realtime

__all__ = [
    "Face", "FaceAnalysis",
    "assess_face_quality", "analyze_bbox_for_side_face", "is_side_face",
    "check_side_face_from_json_bbox",
    "JSONStorageManager", "save_clustering_results",
    "MetadataDB", "SmartFaceEngine", "FaceComparison", "realtime",
]

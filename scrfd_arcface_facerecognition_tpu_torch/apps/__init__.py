"""User surfaces on the port: the camera apps (``realtime``,
``dualstream``, ``multistream``), the FaceAnalysis facade, the clustering
engine, the verification flow, result export and the web API
(``webapp``)."""

from .face_analysis import Face, FaceAnalysis
from .quality import (
    assess_face_quality, analyze_bbox_for_side_face, is_side_face,
    check_side_face_from_json_bbox,
)
from .json_storage import JSONStorageManager, save_clustering_results
from .metadata_db import MetadataDB
from .clustering import SmartFaceEngine
from .verification import FaceComparison
from .webapp import WebApp, make_server, run_web_server
from . import dualstream, multistream, realtime, webapp

__all__ = [
    "Face", "FaceAnalysis",
    "assess_face_quality", "analyze_bbox_for_side_face", "is_side_face",
    "check_side_face_from_json_bbox",
    "JSONStorageManager", "save_clustering_results",
    "MetadataDB", "SmartFaceEngine", "FaceComparison", "WebApp",
    "make_server", "run_web_server", "dualstream", "multistream",
    "realtime", "webapp",
]

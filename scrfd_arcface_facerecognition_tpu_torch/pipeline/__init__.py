"""User-facing pipelines: Detector, Embedder and the end-to-end
FacePipeline."""

from .detector import (Detector, Detections, detect_batch,
                       detect_batch_dynamic, decode_outputs)
from .embedder import Embedder, embed_crops, embed_faces
from .face_pipeline import FacePipeline, PipelineOutput, embed_and_match

__all__ = ["Detector", "Detections", "detect_batch", "detect_batch_dynamic",
           "decode_outputs", "Embedder", "embed_crops", "embed_faces",
           "FacePipeline", "PipelineOutput", "embed_and_match"]

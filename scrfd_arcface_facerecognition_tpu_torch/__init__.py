"""PyTorch + CUDA port of the SCRFD + ArcFace face re-identification framework.

Mirrors the layout of ``scrfd_arcface_facerecognition_tpu`` (``ops/``,
``models/``, ``pipeline/``) module for module, so each module's counterpart
is easy to find. The JAX package stays the reference: this package imports
nothing of it (nor of JAX or Flax) and keeps its own copies of what it
needs.

Entry points (``FacePipeline``, ``Detector``, ``Embedder``) put their
weights and work on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU device they raise.

The face-crop warp, the pipeline's one hand-written kernel, lives in
``csrc/warp_align.cu`` (CUDA C++ for sm_90a), is built with nvcc at first
use and bound through ctypes (``ops/warp_align.py``).
"""

from .device import resolve_device
from .pipeline import Detector, Embedder, FacePipeline

__all__ = ["resolve_device", "FacePipeline", "Detector", "Embedder"]

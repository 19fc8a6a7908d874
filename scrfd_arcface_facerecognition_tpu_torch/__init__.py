"""PyTorch + CUDA port of the SCRFD + ArcFace face re-identification framework.

Mirrors the layout of ``scrfd_arcface_facerecognition_tpu`` (``ops/``,
``models/``, ``pipeline/``, ``gallery/``, ``runtime/``) module for module,
so each module's counterpart is easy to find. The JAX package stays the
reference: this package imports nothing of it (nor of JAX or Flax) and
keeps its own copies of what it needs.

Entry points (``FacePipeline``, ``Detector``, ``Embedder``, the galleries
``GalleryStore``, ``PQGallery`` and ``AutoGallery``, the ``FaceAnalysis``
facade and the engines under ``apps/``: ``SmartFaceEngine`` and
``FaceComparison``) put their weights,
rows and work on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU device they raise.

The port's hand-written kernels are CUDA C++ for sm_90a under ``csrc/``,
built with nvcc at first use and bound through ctypes: the face-crop warp
(``csrc/warp_align.cu``, ``ops/warp_align.py``), the PQ distance scorer
(``csrc/pq_adc.cu``, ``gallery/pq_adc.py``), and the two kernels of the
JAX repository's experiment scripts, ported with their scripts under
``tools/``: the band-mix warp (``csrc/warp_band.cu``) and the narrow 3x3
conv (``csrc/conv3x3.cu``). Released-format ``.onnx`` weights load through
``models/config_from_graph.variables_from_onnx``.
"""

from .device import resolve_device
from .pipeline import Detector, Embedder, FacePipeline
from .gallery import AutoGallery, GalleryStore
from .apps import FaceAnalysis, FaceComparison, SmartFaceEngine

__all__ = ["resolve_device", "FacePipeline", "Detector", "Embedder",
           "AutoGallery", "GalleryStore", "FaceAnalysis", "SmartFaceEngine",
           "FaceComparison"]

"""PyTorch model definitions: the SCRFD detector family and the ArcFace
embedders (NCHW; float32 parameters, a float32 or bfloat16 compute dtype),
seeded init and the Flax weights carrier; and the ONNX graph executor
(``onnx_exec``, ``graph_models``) with its release-file ``preflight``."""

from .layers import PReLU, ConvBN
from .arcface import (ArcFaceConfig, IResNet, MobileFaceNet, ARCFACE_CONFIGS,
                      arcface_from_config, build_arcface)
from .scrfd import (SCRFDConfig, SCRFDNet, SCRFD_CONFIGS, build_scrfd,
                    s2d_kernel_to_stem)
from .init_utils import seeded_init_
from .weights import (load_flax_variables, read_flax_msgpack,
                      state_dict_from_flax)
from .onnx_exec import SUPPORTED_OPS, OnnxModel, UnsupportedOp, onnx_model
from .graph_models import (ArcFaceGraphModule, SCRFDGraphModule,
                           arcface_from_onnx, scrfd_from_onnx)
from .preflight import ReleaseFileError, preflight_graph, preflight_parsed

__all__ = [
    "PReLU", "ConvBN",
    "ArcFaceConfig", "IResNet", "MobileFaceNet", "ARCFACE_CONFIGS",
    "arcface_from_config", "build_arcface",
    "SCRFDConfig", "SCRFDNet", "SCRFD_CONFIGS", "build_scrfd",
    "s2d_kernel_to_stem",
    "seeded_init_", "load_flax_variables", "read_flax_msgpack",
    "state_dict_from_flax",
    "SUPPORTED_OPS", "OnnxModel", "UnsupportedOp", "onnx_model",
    "ArcFaceGraphModule", "SCRFDGraphModule", "arcface_from_onnx",
    "scrfd_from_onnx",
    "ReleaseFileError", "preflight_graph", "preflight_parsed",
]

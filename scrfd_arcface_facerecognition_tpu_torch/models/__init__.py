"""PyTorch model definitions: the SCRFD detector family and the ArcFace
embedders (NCHW; float32 parameters, a float32 or bfloat16 compute dtype),
seeded init and the Flax weights carrier."""

from .layers import PReLU, ConvBN
from .arcface import (ArcFaceConfig, IResNet, MobileFaceNet, ARCFACE_CONFIGS,
                      arcface_from_config, build_arcface)
from .scrfd import (SCRFDConfig, SCRFDNet, SCRFD_CONFIGS, build_scrfd,
                    s2d_kernel_to_stem)
from .init_utils import seeded_init_
from .weights import (load_flax_variables, read_flax_msgpack,
                      state_dict_from_flax)

__all__ = [
    "PReLU", "ConvBN",
    "ArcFaceConfig", "IResNet", "MobileFaceNet", "ARCFACE_CONFIGS",
    "arcface_from_config", "build_arcface",
    "SCRFDConfig", "SCRFDNet", "SCRFD_CONFIGS", "build_scrfd",
    "s2d_kernel_to_stem",
    "seeded_init_", "load_flax_variables", "read_flax_msgpack",
    "state_dict_from_flax",
]

"""ArcFace embedding: umeyama-align -> warp (kernel K1) -> embed -> L2.

Faces are aligned out of the original frame by their 5 landmarks, warped
to 112x112, normalized (x-127.5)/127.5 with the BGR->RGB swap and embedded
to 512-d. The warp and the input prep are one kernel
(``ops/warp_align.py``). Invalid slots produce embedding * 0, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from .. import ops
from ..device import resolve_device
from ..models.arcface import ARCFACE_CONFIGS, ArcFaceConfig, arcface_from_config
from ..models.graph_models import arcface_from_onnx
from ..models.init_utils import seeded_init_
from ..models.weights import load_flax_variables
from ..stages import stage
from .detector import as_frames


def crop_matrices(kps_flat: torch.Tensor) -> torch.Tensor:
    """(F, 5, 2) landmarks -> (F, 2, 3) dst -> src warp matrices."""
    return ops.invert_affine(ops.estimate_norm(kps_flat, 112)).contiguous()


def embed_crops(model: nn.Module, frames: torch.Tensor,
                kps_flat: torch.Tensor, frame_idx: torch.Tensor,
                valid_flat: torch.Tensor, *, l2: bool = True) -> torch.Tensor:
    """Embed F face crops drawn from a frame batch.

    frames (B, H, W, 3) u8 BGR; kps_flat (F, 5, 2); frame_idx (F,);
    valid_flat (F,) -> (F, D) embeddings (invalid slots -> emb * 0).
    """
    with stage("align_warp"):
        crops = ops.warp_align_crops(
            frames, crop_matrices(kps_flat),
            frame_idx.to(torch.int32).contiguous())
    with stage("arcface"):
        emb = model(crops)
        if l2:
            emb = ops.l2_normalize(emb)
        return emb * valid_flat[:, None].to(emb.dtype)


def embed_faces(model: nn.Module, frames: torch.Tensor, kps: torch.Tensor,
                valid: torch.Tensor, *, l2: bool = True) -> torch.Tensor:
    """frames (B, H, W, 3) u8; kps (B, K, 5, 2); valid (B, K) ->
    (B, K, D) embeddings."""
    b, k = kps.shape[0], kps.shape[1]
    frame_idx = torch.arange(b, dtype=torch.int32,
                             device=frames.device).repeat_interleave(k)
    emb = embed_crops(model, frames, kps.reshape(b * k, 5, 2), frame_idx,
                      valid.reshape(b * k), l2=l2)
    return emb.reshape(b, k, -1)


class Embedder:
    """User-facing ArcFace embedder.

    ``variables`` is a Flax tree of numpy arrays; without it the weights
    are the seeded init. ``onnx_path`` runs a released ``.onnx`` graph
    through the executor instead (it takes no ``variables``; the embedding
    width is read from the graph). ``dtype`` is the compute dtype (float32 or
    bfloat16; the weights stay float32): K1 still writes float32 crops,
    the model casts them, and the embedding leaves it as float32. The
    model lives on ``device``: the CUDA card unless ``device="cpu"`` is
    passed.
    """

    def __init__(self, variant: str = "w600k_r50",
                 variables: Optional[Any] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 config: Optional[ArcFaceConfig] = None,
                 onnx_path: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.input_size = (112, 112)
        if onnx_path is not None:
            if variables is not None:
                raise ValueError(
                    "pass either variables or onnx_path, not both: the "
                    "graph path would silently discard the given weights")
            self.variant = variant
            self.model = arcface_from_onnx(onnx_path, dtype=dtype,
                                           device=self.device).eval()
            self.emb_dim = self.model.emb_dim(self.input_size)
            return
        if config is None:
            if variant not in ARCFACE_CONFIGS:
                raise ValueError(f"unknown ArcFace variant {variant!r}")
            config = ARCFACE_CONFIGS[variant]
        self.variant = config.name
        self.emb_dim = config.emb_dim
        model = arcface_from_config(config, dtype)
        if variables is None:
            seeded_init_(model, seed)
        else:
            load_flax_variables(model, variables)
        self.model = model.eval().requires_grad_(False).to(self.device)

    @torch.inference_mode()
    def embed_batched(self, frames, kps, valid, l2: bool = True
                      ) -> torch.Tensor:
        frames = as_frames(frames, self.device)
        kps = torch.as_tensor(kps, dtype=torch.float32, device=self.device)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=self.device)
        return embed_faces(self.model, frames, kps, valid, l2=l2)

    @torch.inference_mode()
    def get_feat(self, aligned_images) -> np.ndarray:
        """Embed pre-aligned 112x112 BGR crops; raw outputs, no L2."""
        imgs = as_frames(aligned_images, self.device)
        net_in = ops.normalize_image(imgs, ops.ARCFACE_MEAN, ops.ARCFACE_STD)
        return self.model(net_in.permute(0, 3, 1, 2).contiguous()).cpu().numpy()

    def __call__(self, image, kps) -> np.ndarray:
        """Align one face out of ``image`` by 5 landmarks and embed; the
        flat raw 512-d embedding."""
        kps_b = np.asarray(kps, dtype=np.float32)[None, None]
        emb = self.embed_batched(np.asarray(image)[None], kps_b,
                                 np.ones((1, 1), bool), l2=False)
        return emb[0, 0].cpu().numpy()

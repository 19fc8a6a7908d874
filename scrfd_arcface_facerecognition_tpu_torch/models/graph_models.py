"""The pipeline's models from ONNX graphs run by the executor.

``SCRFDGraphModule`` and ``ArcFaceGraphModule`` are ``nn.Module``s with
the native models' call signature, so ``Detector`` / ``Embedder`` (and the
stages under them) hold either kind alike:

- SCRFD: the graph's 9 outputs are classified by shape, not by declared
  order or name: N = num_anchors * (H / s) * (W / s) against the input's
  (H, W) picks the stride, C in {1, 4, 10} the kind; the forward returns
  the ``{"scores", "bboxes", "kps"}`` lists ``pipeline/detector.py``
  ``decode_outputs`` reads, stride 8 first, at any canvas size.
- ArcFace: the single (B, emb) output, float32.

Counterpart of the JAX package's ``models/graph_models.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from .onnx_exec import OnnxModel, onnx_model


class SCRFDGraphModule(nn.Module):
    """SCRFD from an ONNX graph; the forward returns the head dict."""

    def __init__(self, model: OnnxModel, strides=(8, 16, 32),
                 num_anchors: int = 2):
        super().__init__()
        self.model = model
        self.strides = tuple(strides)
        self.num_anchors = num_anchors

    def _classify(self, shapes: List[Tuple[int, ...]], hw: Tuple[int, int]):
        """output index -> (kind, stride index) from the outputs' shapes."""
        h, w = hw
        n_of_stride = {self.num_anchors * (h // s) * (w // s): si
                       for si, s in enumerate(self.strides)}
        kind_of_c = {1: "scores", 4: "bboxes", 10: "kps"}
        mapping = {}
        for i, shp in enumerate(shapes):
            if len(shp) != 3 or shp[1] not in n_of_stride \
                    or shp[2] not in kind_of_c:
                raise ValueError(
                    f"output {i} shape {shp} does not match the SCRFD "
                    f"9-output contract for input {hw}")
            mapping[i] = (kind_of_c[shp[2]], n_of_stride[shp[1]])
        if len(mapping) != 9:
            raise ValueError(f"expected 9 outputs, got {len(shapes)}")
        return mapping

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """x (B, 3, H, W) -> {"scores", "bboxes", "kps"}: three (B, N, C)
        float32 tensors each, stride 8 first."""
        outs = self.model(x)
        mapping = self._classify([tuple(o.shape) for o in outs],
                                 tuple(x.shape[2:4]))
        result = {"scores": [None] * 3, "bboxes": [None] * 3,
                  "kps": [None] * 3}
        for i, o in enumerate(outs):
            kind, si = mapping[i]
            result[kind][si] = o
        return result


class ArcFaceGraphModule(nn.Module):
    """ArcFace from an ONNX graph; the forward returns (B, emb) float32."""

    def __init__(self, model: OnnxModel):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        emb = self.model(x)[0]
        if emb.dim() != 2:
            raise ValueError(f"unexpected embedding shape {tuple(emb.shape)}")
        return emb

    def emb_dim(self, input_hw: Tuple[int, int] = (112, 112)) -> int:
        """The embedding width, from a forward on the "meta" device."""
        shapes = self.model.trace_shapes((1, 3, *input_hw))
        return int(shapes[self.model.graph.outputs[0]][-1])


def scrfd_from_onnx(path: str, dtype: torch.dtype = torch.float32,
                    device=None) -> SCRFDGraphModule:
    return SCRFDGraphModule(onnx_model(path, dtype=dtype, device=device))


def arcface_from_onnx(path: str, dtype: torch.dtype = torch.float32,
                      device=None) -> ArcFaceGraphModule:
    return ArcFaceGraphModule(onnx_model(path, dtype=dtype, device=device))

"""Load trained checkpoints into the inference stack (train -> serve).

The port's trainers write their checkpoints with ``torch.save``: a dict
of tensors, not the orbax directories of the JAX package.
``ArcFaceTrainer.save_checkpoint`` saves the whole train state
(``{"backbone": variables, "head_w", "trace", "step"}``, the variables in
Flax layout); ``SCRFDTrainer.save_checkpoint`` saves the detector's raw
``{"params", "batch_stats"}`` dict of tensors, as the JAX tool saves the
variables alone. This helper turns either into the ``variables`` the inference
wrappers take:

    emb = Embedder(config=cfg, variables=load_inference_variables(path))

The ArcFace class matrix ``head_w`` is a training-only object (inference
uses the embedding, never class logits), so it is dropped here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def numpy_tree(tree: Mapping) -> Dict[str, Any]:
    """A nested dict of tensors -> the same dict of numpy f32 arrays."""
    return {k: (numpy_tree(v) if isinstance(v, Mapping)
                else np.asarray(v.detach().cpu(), np.float32))
            for k, v in tree.items()}


def tensor_tree(tree: Mapping) -> Dict[str, Any]:
    """A nested dict of numpy arrays -> the same dict of tensors (the form a
    checkpoint file holds; the inverse of ``numpy_tree``)."""
    return {k: (tensor_tree(v) if isinstance(v, Mapping)
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in tree.items()}


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint file's dict, read as tensors only (``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_inference_variables(path: str) -> Dict[str, Any]:
    """A trainer checkpoint (raw variables, or an ArcFace train state) ->
    ``{"params", "batch_stats"}`` of numpy f32 arrays, the tree
    ``Embedder(config=, variables=)`` and ``Detector`` take."""
    data = read_checkpoint(path)
    if "backbone" in data:                        # an ArcFace train state
        data = data["backbone"]
    if not isinstance(data, Mapping) or "params" not in data:
        raise ValueError(f"{path} is not a variables checkpoint "
                         f"(keys: {list(data)})")
    out = {"params": numpy_tree(data["params"])}
    if data.get("batch_stats"):
        out["batch_stats"] = numpy_tree(data["batch_stats"])
    return out

"""Carry Flax weight trees into the port's modules.

A Flax variables tree ``{"params": ..., "batch_stats": ...}`` of numpy
arrays (a seeded Flax init, or a checkpoint read with
``flax.serialization.msgpack_restore``) becomes a PyTorch state dict. The
port's submodules carry the Flax names, so a leaf's path maps directly:

- conv ``kernel`` (kh, kw, I/groups, O) -> ``weight`` (O, I/groups, kh, kw),
  plain, grouped and depthwise alike;
- dense ``kernel`` (in, out) -> ``weight`` (out, in);
- BatchNorm / GroupNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- batch stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- PReLU ``alpha`` and the SCRFD head's ``scale{li}`` keep their names;
- a space-to-depth detector stem kernel (2, 2, 12, C) becomes the plain
  (3, 3, 3, C) stem first (``s2d_kernel_to_stem``, exact).

``variables_from_module`` is the inverse: a module's weights as such a
tree (the ONNX importer's template). This module reads numpy only; it needs
neither JAX nor Flax.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .scrfd import s2d_kernel_to_stem

_STEM_PATH = ("backbone", "stem1", "conv", "kernel")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree -> PyTorch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel":
            if path[-4:] == _STEM_PATH and arr.shape[:3] == (2, 2, 12):
                arr = s2d_kernel_to_stem(arr)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        out[".".join(path[:-1] + (name,))] = torch.tensor(arr)
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        arr = np.asarray(leaf, dtype=np.float32)
        out[".".join(path[:-1] + (stats[path[-1]],))] = torch.tensor(arr)
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load a Flax tree into ``module`` (strict: every weight of the module
    must be in the tree and nothing else); returns the module."""
    state = state_dict_from_flax(variables)
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in state:
            state[key] = value   # a training counter Flax does not keep
    module.load_state_dict(state, strict=True)
    return module


def _put(tree: Dict[str, Any], path: Sequence[str], leaf: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def variables_from_module(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """``module``'s weights as a Flax ``{"params", "batch_stats"}`` tree of
    numpy f32 (the inverse of ``state_dict_from_flax``): 4-D ``weight`` ->
    conv ``kernel`` (kh, kw, I/groups, O), 2-D -> dense ``kernel`` (in,
    out), 1-D -> norm ``scale``; running stats -> ``mean`` / ``var``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        path = key.split(".")
        name = path[-1]
        if name == "num_batches_tracked":
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name in ("running_mean", "running_var"):
            _put(stats, path[:-1] + [name[len("running_"):]], arr)
            continue
        if name == "weight":
            if arr.ndim == 4:
                arr, name = arr.transpose(2, 3, 1, 0), "kernel"
            elif arr.ndim == 2:
                arr, name = arr.T, "kernel"
            else:
                name = "scale"
        _put(params, path[:-1] + [name], np.ascontiguousarray(arr))
    return {"params": params, "batch_stats": stats} if stats else {
        "params": params}

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
tree (the ONNX importer's template). ``read_flax_msgpack`` reads a
checkpoint that ``flax.serialization.msgpack_serialize`` wrote. This
module reads numpy only; it needs neither JAX nor Flax.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import set_compute_dtype
from .scrfd import s2d_kernel_to_stem

_STEM_PATH = ("backbone", "stem1", "conv", "kernel")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


# ------------------------------------------------------------ checkpoints
#
# msgpack as Flax writes it: maps, arrays, strings, numbers, bin, and two
# extension types whose payload is itself msgpack (shape, dtype name, raw
# bytes): 1 an ndarray, 3 a numpy scalar. Leaves past 2^30 bytes arrive
# as chunk maps (``__msgpack_chunked_array__``).

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _unpack(buf: bytes, i: int, raw: bool = False) -> Tuple[Any, int]:
    """The msgpack object at ``buf[i:]`` and the offset past it."""
    b = buf[i]
    i += 1
    if b <= 0x7f or b >= 0xe0:
        return (b if b <= 0x7f else b - 0x100), i
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], i
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif 0xd4 <= b <= 0xd8:
        kind, n = "ext", 1 << (b - 0xd4)
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")
    if kind == "map":
        out = {}
        for _ in range(n):
            k, i = _unpack(buf, i, raw)
            out[k], i = _unpack(buf, i, raw)
        return out, i
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i, raw)
            out.append(v)
        return out, i
    if kind == "ext":
        code = struct.unpack_from(">b", buf, i)[0]
        data = buf[i + 1:i + 1 + n]
        if code not in (1, 3):
            raise ValueError(f"msgpack: extension type {code} not read")
        (shape, name, raw_bytes), _ = _unpack(data, 0, raw=True)
        arr = np.frombuffer(raw_bytes, dtype=np.dtype(name.decode())
                            ).reshape(shape)
        return (arr if code == 1 else arr[()]), i + 1 + n
    data = bytes(buf[i:i + n])
    return (data if kind == "bin" or raw else data.decode()), i + n


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        part = lambda d: [d[str(k)] for k in range(len(d))]
        return np.concatenate(part(tree["chunks"])).reshape(
            part(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(data: bytes) -> Dict[str, Any]:
    """A checkpoint's bytes (``flax.serialization.msgpack_serialize``) ->
    the tree of numpy arrays ``msgpack_restore`` gives."""
    tree, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} bytes past the tree")
    return _unchunk(tree)


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
    must be in the tree and nothing else); returns the module, its
    compute-dtype copies of the weights rounded from the new ones."""
    state = state_dict_from_flax(variables)
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in state:
            state[key] = value   # a training counter Flax does not keep
    module.load_state_dict(state, strict=True)
    return set_compute_dtype(module)


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

"""Minimal ONNX protobuf encoder (no ``onnx`` package): the port's own
copy of the JAX package's ``models/onnx_write.py``, numpy only.

It builds ModelProto bytes (nodes, initializers, graph IO with type info)
with protobuf wire encoding, the mirror of ``onnx_proto.py``'s parser.
The exporter (``onnx_export.py``) writes trained models with it, in the
format the reference application serves through onnxruntime.

Field numbers follow onnx/onnx.proto3: ModelProto{ir_version=1,
opset_import=8, graph=7}, GraphProto{node=1, initializer=5, input=11,
output=12}, NodeProto{input=1, output=2, name=3, op_type=4, attribute=5},
TensorProto{dims=1, data_type=2, name=8, raw_data=9},
AttributeProto{name=1, f=2, i=3, s=4, floats=7, ints=8, type=20}.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

_DTYPE_CODE = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
               np.dtype(np.float16): 10, np.dtype(np.int32): 6,
               np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
               np.dtype(np.bool_): 9, np.dtype(np.float64): 11}


def _varint(v: int) -> bytes:
    if v < 0:
        # protobuf int64: negatives encode as 64-bit two's complement
        # (10-byte varint) — Python's arithmetic shift would loop forever
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _varint_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    parts = bytearray()
    for d in arr.shape:
        parts += _varint_field(1, d)
    parts += _varint_field(2, _DTYPE_CODE[arr.dtype])
    parts += _len_field(8, name.encode())
    parts += _len_field(9, arr.tobytes())
    return bytes(parts)


def encode_attr_int(name: str, v: int) -> bytes:
    return (_len_field(1, name.encode()) + _varint_field(3, int(v))
            + _varint_field(20, 2))


def encode_attr_float(name: str, v: float) -> bytes:
    return (_len_field(1, name.encode()) + _float_field(2, v)
            + _varint_field(20, 1))


def encode_attr_ints(name: str, vals: Sequence[int]) -> bytes:
    p = bytearray(_len_field(1, name.encode()))
    for v in vals:
        p += _varint_field(8, int(v))
    p += _varint_field(20, 7)
    return bytes(p)


def encode_attr_string(name: str, s: str) -> bytes:
    return (_len_field(1, name.encode()) + _len_field(4, s.encode())
            + _varint_field(20, 3))


def encode_node(op_type: str, inputs: List[str], outputs: List[str],
                name: str = "", attrs: Optional[List[bytes]] = None) -> bytes:
    parts = bytearray()
    for i in inputs:
        parts += _len_field(1, i.encode())
    for o in outputs:
        parts += _len_field(2, o.encode())
    parts += _len_field(3, name.encode())
    parts += _len_field(4, op_type.encode())
    for a in attrs or []:
        parts += _len_field(5, a)
    return bytes(parts)


def _dim(d) -> bytes:
    """TensorShapeProto.Dimension: int -> dim_value, str -> dim_param
    (symbolic, e.g. a free batch axis)."""
    if isinstance(d, str):
        return _len_field(2, d.encode())
    return _varint_field(1, int(d))


def encode_tensor_type(elem_type: int, dims: Sequence) -> bytes:
    """TypeProto{tensor_type=1: Tensor{elem_type=1, shape=2}}."""
    shape = b"".join(_len_field(1, _dim(d)) for d in dims)
    tensor = _varint_field(1, elem_type) + _len_field(2, shape)
    return _len_field(1, tensor)


def _value_info(name: str, spec=None) -> bytes:
    """ValueInfoProto. `spec` = (elem_type_code, dims) — REQUIRED for graph
    inputs/outputs consumed by onnxruntime (it rejects models whose IO
    carries no TypeProto); this repo's own parser reads only the name."""
    p = bytearray(_len_field(1, name.encode()))
    if spec is not None:
        elem, dims = spec
        p += _len_field(2, encode_tensor_type(elem, dims))
    return bytes(p)


def encode_model(nodes: List[bytes], initializers: Dict[str, np.ndarray],
                 inputs: List[str], outputs: List[str],
                 opset: int = 11, io_types: Optional[Dict] = None,
                 graph_name: str = "graph") -> bytes:
    """io_types: {tensor_name: (elem_type_code, dims)} type annotations
    for graph inputs/outputs; dims entries are ints (fixed) or strings
    (symbolic dim_param). Names without an entry emit name-only
    ValueInfoProto (fine for this repo's parser, not for onnxruntime)."""
    io_types = io_types or {}
    graph = bytearray()
    for n in nodes:
        graph += _len_field(1, n)
    graph += _len_field(2, graph_name.encode())
    for name, arr in initializers.items():
        graph += _len_field(5, encode_tensor(name, arr))
    for i in inputs:
        graph += _len_field(11, _value_info(i, io_types.get(i)))
    for o in outputs:
        graph += _len_field(12, _value_info(o, io_types.get(o)))
    # OperatorSetIdProto{domain=1(default ""), version=2}
    opset_entry = _varint_field(2, opset)
    model = (_varint_field(1, 8) + _len_field(7, bytes(graph))
             + _len_field(8, opset_entry))  # ir_version + graph + opset
    return model

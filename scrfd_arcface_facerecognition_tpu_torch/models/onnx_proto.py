"""Minimal self-contained ONNX protobuf reader (the port's own copy).

A copy of the JAX package's ``models/onnx_proto.py``, which imports no JAX
either; the port keeps its own so that it imports nothing of that package
(``tests/test_torch_onnx.py`` holds the two parsers to the same result).

No ``onnx`` package is needed: this module implements just enough of the
protobuf wire format to read ONNX ModelProto files: nodes (op_type,
inputs, outputs, attributes) and initializers (weight tensors). Field
numbers follow the public onnx.proto3 schema. Unknown fields are skipped
per standard protobuf rules, so files from any ONNX version parse.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType values (onnx.proto3)
TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    wire 0 -> varint int; wire 1 -> 8 raw bytes; wire 2 -> bytes;
    wire 5 -> 4 raw bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _varints_packed(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_signed(v: int, bits: int = 64) -> int:
    # ONNX uses plain int64 varints (two's complement for negatives)
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


@dataclasses.dataclass
class OnnxAttribute:
    name: str
    value: Any


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int64_data: List[int] = []
    int32_data: List[int] = []
    external = False
    for field, wire, val in iter_fields(buf):
        if field == 1:       # dims (repeated int64)
            if wire == 0:
                dims.append(_zigzag_signed(val))
            else:
                dims.extend(_zigzag_signed(v) for v in _varints_packed(val))
        elif field == 2 and wire == 0:   # data_type
            dtype_code = val
        elif field == 4:     # float_data
            if wire == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 5:     # int32_data
            if wire == 0:
                int32_data.append(_zigzag_signed(val, 32))
            else:
                # packed varints need the same signedness fixup as the
                # unpacked branch (negative int32 rides as a 64-bit varint)
                int32_data.extend(_zigzag_signed(v, 32)
                                  for v in _varints_packed(val))
        elif field == 7:     # int64_data
            if wire == 0:
                int64_data.append(_zigzag_signed(val))
            else:
                int64_data.extend(_zigzag_signed(v) for v in _varints_packed(val))
        elif field == 8 and wire == 2:   # name
            name = val.decode()
        elif field == 9 and wire == 2:   # raw_data
            raw = val
        elif field in (13, 14):          # external_data / data_location
            external = True
    dtype = TENSOR_DTYPES.get(dtype_code, np.float32)
    shape = tuple(dims)
    if external and raw is None and not (float_data or int64_data
                                         or int32_data):
        # silently decoding as zeros would corrupt every weight; fail loud
        raise ValueError(
            f"tensor {name!r} uses ONNX external data, which this "
            "self-contained parser does not load")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(shape)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).reshape(shape)
    elif int32_data:
        arr = np.asarray(int32_data, dtype).reshape(shape)
    else:
        arr = np.zeros(shape, dtype)
    return name, arr


def _parse_attribute(buf: bytes) -> OnnxAttribute:
    name = ""
    f = i = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in iter_fields(buf):
        if field == 1 and wire == 2:
            name = val.decode()
        elif field == 2 and wire == 5:     # f
            f = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:     # i
            i = _zigzag_signed(val)
        elif field == 4 and wire == 2:     # s
            s = val.decode(errors="replace")
        elif field == 5 and wire == 2:     # t (tensor)
            t = _parse_tensor(val)[1]
        elif field == 7:                   # floats
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 8:                   # ints
            if wire == 0:
                ints.append(_zigzag_signed(val))
            else:
                ints.extend(_zigzag_signed(v) for v in _varints_packed(val))
    for candidate in (t, f, i, s):
        if candidate is not None:
            return OnnxAttribute(name, candidate)
    if floats:
        return OnnxAttribute(name, floats)
    return OnnxAttribute(name, ints)


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, Any] = {}
    for field, wire, val in iter_fields(buf):
        if field == 1 and wire == 2:
            inputs.append(val.decode())
        elif field == 2 and wire == 2:
            outputs.append(val.decode())
        elif field == 3 and wire == 2:
            name = val.decode()
        elif field == 4 and wire == 2:
            op_type = val.decode()
        elif field == 5 and wire == 2:
            attr = _parse_attribute(val)
            attrs[attr.name] = attr.value
    return OnnxNode(op_type, name, inputs, outputs, attrs)


def _value_info_name(buf: bytes) -> str:
    for field, wire, val in iter_fields(buf):
        if field == 1 and wire == 2:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List[str] = []
    outputs: List[str] = []
    for field, wire, val in iter_fields(buf):
        if field == 1 and wire == 2:       # node
            nodes.append(_parse_node(val))
        elif field == 5 and wire == 2:     # initializer
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 11 and wire == 2:    # input
            inputs.append(_value_info_name(val))
        elif field == 12 and wire == 2:    # output
            outputs.append(_value_info_name(val))
    return OnnxGraph(nodes, initializers, inputs, outputs)


def load_onnx(path: str) -> OnnxGraph:
    """Parse an ONNX ModelProto file into an OnnxGraph."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        for field, wire, val in iter_fields(buf):
            if field == 7 and wire == 2:   # ModelProto.graph
                return _parse_graph(val)
    except Exception as e:
        raise ValueError(
            f"{path}: not a parseable ONNX ModelProto ({e})") from e
    raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")

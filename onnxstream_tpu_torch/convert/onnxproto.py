"""Minimal ONNX protobuf reader/writer (no `onnx` dependency).

Counterpart of ``onnxstream_tpu/convert/onnxproto.py``, the same code: a
hand-rolled protobuf wire-format codec covering the ModelProto subset the
converter needs (nodes, initializers, value_info shapes, attributes). Field
numbers follow onnx.proto3, which is stable across ONNX releases. The writer
exists for tests and for programmatic graph authoring. numpy only.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType
TP_FLOAT, TP_UINT8, TP_INT8, TP_INT32, TP_INT64, TP_FLOAT16, TP_DOUBLE = 1, 2, 3, 6, 7, 10, 11
TP_BOOL = 9

DTYPE_OF = {
    TP_FLOAT: np.dtype(np.float32),
    TP_UINT8: np.dtype(np.uint8),
    TP_INT8: np.dtype(np.int8),
    TP_INT32: np.dtype(np.int32),
    TP_INT64: np.dtype(np.int64),
    TP_FLOAT16: np.dtype(np.float16),
    TP_DOUBLE: np.dtype(np.float64),
    TP_BOOL: np.dtype(np.bool_),
}
CODE_OF = {v: k for k, v in DTYPE_OF.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_FLOATS, AT_INTS, AT_STRINGS = 1, 2, 3, 4, 6, 7, 8


# --------------------------------------------------------------------- decode
def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _zigzag_signed(v: int) -> int:
    """int64 fields are two's-complement varints in proto3."""
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclasses.dataclass
class TensorInfo:
    name: str
    dims: Tuple[int, ...]
    data: Optional[np.ndarray] = None  # None for value_info entries
    elem_type: int = TP_FLOAT


@dataclasses.dataclass
class NodeInfo:
    name: str
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]  # int | float | str | list | TensorInfo


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[NodeInfo]
    initializers: Dict[str, TensorInfo]
    inputs: List[TensorInfo]
    outputs: List[TensorInfo]
    value_info: Dict[str, TensorInfo]


def _decode_tensor(buf: memoryview) -> TensorInfo:
    dims: List[int] = []
    name = ""
    elem = TP_FLOAT
    raw = b""
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wt, val in _fields(buf):
        if field == 1:  # dims
            if wt == 0:
                dims.append(_zigzag_signed(val))
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(_zigzag_signed(v))
        elif field == 2:
            elem = val
        elif field == 8:
            name = bytes(val).decode()
        elif field == 9:
            raw = bytes(val)
        elif field == 4:  # float_data
            if wt == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 5:  # int32_data (also fp16 payloads)
            if wt == 0:
                int32_data.append(_zigzag_signed(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int32_data.append(_zigzag_signed(v))
        elif field == 7:  # int64_data
            if wt == 0:
                int64_data.append(_zigzag_signed(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64_data.append(_zigzag_signed(v))
        elif field == 10:  # double_data
            if wt == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(np.frombuffer(bytes(val), "<f8").tolist())
    dt = DTYPE_OF.get(elem, np.dtype(np.float32))
    shape = tuple(dims)
    if raw:
        arr = np.frombuffer(raw, dt).reshape(shape).copy()
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(shape)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).reshape(shape)
    elif int32_data and elem == TP_FLOAT16:
        arr = np.asarray(int32_data, np.uint16).view(np.float16).reshape(shape)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32).astype(dt).reshape(shape)
    elif double_data:
        arr = np.asarray(double_data, np.float64).reshape(shape)
    else:
        arr = np.zeros(shape, dt)
    return TensorInfo(name=name, dims=shape, data=arr, elem_type=elem)


def _decode_value_info(buf: memoryview) -> TensorInfo:
    name = ""
    dims: List[int] = []
    elem = TP_FLOAT
    for field, wt, val in _fields(buf):
        if field == 1:
            name = bytes(val).decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dv = 0
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = _zigzag_signed(v5)
                                        elif f5 == 2:  # dim_param: symbolic
                                            dv = -1
                                    dims.append(dv)
    return TensorInfo(name=name, dims=tuple(dims), elem_type=elem)


def _decode_attr(buf: memoryview):
    name = ""
    atype = 0
    f_val = 0.0
    i_val = 0
    s_val = b""
    t_val: Optional[TensorInfo] = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            name = bytes(val).decode()
        elif field == 20:
            atype = val
        elif field == 2:
            f_val = struct.unpack("<f", val)[0]
        elif field == 3:
            i_val = _zigzag_signed(val)
        elif field == 4:
            s_val = bytes(val)
        elif field == 5:
            t_val = _decode_tensor(val)
        elif field == 7:
            if wt == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 8:
            if wt == 0:
                ints.append(_zigzag_signed(val))
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(_zigzag_signed(v))
        elif field == 9:
            strings.append(bytes(val))
    if atype == AT_FLOAT:
        return name, f_val
    if atype == AT_INT:
        return name, i_val
    if atype == AT_STRING:
        return name, s_val.decode("utf-8", errors="ignore")
    if atype == AT_TENSOR:
        return name, t_val
    if atype == AT_FLOATS:
        return name, list(floats)
    if atype == AT_INTS:
        return name, list(ints)
    if atype == AT_STRINGS:
        return name, [s.decode("utf-8", errors="ignore") for s in strings]
    # best-effort when type tag is absent
    if t_val is not None:
        return name, t_val
    if ints:
        return name, list(ints)
    if floats:
        return name, list(floats)
    if s_val:
        return name, s_val.decode("utf-8", errors="ignore")
    return name, i_val if i_val else f_val


def _decode_node(buf: memoryview) -> NodeInfo:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, object] = {}
    for field, _, val in _fields(buf):
        if field == 1:
            inputs.append(bytes(val).decode())
        elif field == 2:
            outputs.append(bytes(val).decode())
        elif field == 3:
            name = bytes(val).decode()
        elif field == 4:
            op_type = bytes(val).decode()
        elif field == 5:
            k, v = _decode_attr(val)
            attrs[k] = v
    return NodeInfo(name=name, op_type=op_type, inputs=inputs, outputs=outputs, attrs=attrs)


def _decode_graph(buf: memoryview) -> OnnxGraph:
    nodes: List[NodeInfo] = []
    inits: Dict[str, TensorInfo] = {}
    inputs: List[TensorInfo] = []
    outputs: List[TensorInfo] = []
    vinfo: Dict[str, TensorInfo] = {}
    for field, _, val in _fields(buf):
        if field == 1:
            nodes.append(_decode_node(val))
        elif field == 5:
            t = _decode_tensor(val)
            inits[t.name] = t
        elif field == 11:
            inputs.append(_decode_value_info(val))
        elif field == 12:
            outputs.append(_decode_value_info(val))
        elif field == 13:
            t = _decode_value_info(val)
            vinfo[t.name] = t
    return OnnxGraph(nodes=nodes, initializers=inits, inputs=inputs, outputs=outputs, value_info=vinfo)


def load_onnx(data: bytes) -> OnnxGraph:
    """Parse ModelProto bytes -> OnnxGraph."""
    graph = None
    for field, _, val in _fields(memoryview(data)):
        if field == 7:  # ModelProto.graph
            graph = _decode_graph(val)
    if graph is None:
        raise ValueError("no GraphProto found (is this an ONNX file?)")
    return graph


# --------------------------------------------------------------------- encode
def _varint(v: int) -> bytes:
    if v < 0:
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


def _key(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _key(1, 0) + _varint(d)
    out += _key(2, 0) + _varint(CODE_OF[arr.dtype])
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def _encode_value_info(name: str, shape, elem_type: int = TP_FLOAT) -> bytes:
    dims = b"".join(_ld(1, _key(1, 0) + _varint(d)) for d in shape)
    ttype = _key(1, 0) + _varint(elem_type) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, ttype))


def encode_attr(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        out += _key(3, 0) + _varint(value) + _key(20, 0) + _varint(AT_INT)
    elif isinstance(value, float):
        out += _key(2, 5) + struct.pack("<f", value) + _key(20, 0) + _varint(AT_FLOAT)
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _key(20, 0) + _varint(AT_STRING)
    elif isinstance(value, np.ndarray):
        out += _ld(5, encode_tensor("", value)) + _key(20, 0) + _varint(AT_TENSOR)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        out += b"".join(_key(8, 0) + _varint(v) for v in value) + _key(20, 0) + _varint(AT_INTS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_key(7, 5) + struct.pack("<f", v) for v in value) + _key(20, 0) + _varint(AT_FLOATS)
    else:
        raise TypeError(f"unsupported attr {name}={value!r}")
    return out


def encode_node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += _ld(1, i.encode())
    for o in outputs:
        out += _ld(2, o.encode())
    out += _ld(3, (name or op_type).encode())
    out += _ld(4, op_type.encode())
    for k, v in attrs.items():
        out += _ld(5, encode_attr(k, v))
    return out


def encode_model(nodes: List[bytes], inputs: List[Tuple[str, tuple]],
                 outputs: List[Tuple[str, tuple]],
                 initializers: Dict[str, np.ndarray],
                 input_types: Optional[Dict[str, int]] = None) -> bytes:
    """Build ModelProto bytes from encoded nodes + I/O specs (for tests)."""
    g = b""
    for n in nodes:
        g += _ld(1, n)
    for name, arr in initializers.items():
        g += _ld(5, encode_tensor(name, arr))
    for name, shape in inputs:
        g += _ld(11, _encode_value_info(name, shape, (input_types or {}).get(name, TP_FLOAT)))
    for name, shape in outputs:
        g += _ld(12, _encode_value_info(name, shape))
    model = _key(1, 0) + _varint(8)  # ir_version
    model += _ld(8, _key(2, 0) + _varint(17))  # opset_import {version: 17}
    model += _ld(7, g)
    return model

"""Typed graph IR and the model.txt text-format parser/serializer.

Same parser as ``onnxstream_tpu/ir.py``, carried into the port because any
import of the JAX package imports JAX (``onnxstream_tpu/__init__.py``).

Grammar (one op per line; reference README.md:210-216, parser
src/onnxstream.cpp:2445-2616):

    <op_name>:<OpType>*input:<tensors>*output:<tensors>[*<attr>:<val>;...]

    tensors := tensor[;tensor...]
    tensor  := <name>(<shape>) | <name>(<dtype>:<shape>)
    dtype   := float32 | float16 | int64 | uint8[<scale>,<zero_point>]
    shape   := d0,d1,...   (a dim of 0 is a dynamic dim, allowed only when the
                            session enables dynamic shapes)

Tensors carrying an explicit dtype are *weights*, resolved through a
WeightsProvider by name (conventionally `<param-name>.bin`); tensors with a bare
shape are graph inputs/intermediates (reference get_tensor_data,
src/onnxstream.cpp:2662 decides weight-ness by `m_type != none`).

Unlike the reference — which re-parses one line at a time inside the run loop —
we parse the whole program into an immutable Graph once, then compile it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from onnxstream_tpu_torch.dtypes import DType


@dataclasses.dataclass
class TensorSpec:
    """One tensor reference inside an op line."""

    name: str
    shape: Tuple[int, ...] = ()
    dtype: DType = DType.none  # none => activation/intermediate (runtime dtype)
    scale: float = 0.0  # uint8 quantization params (asymmetric)
    zero_point: int = 0
    # host-side upload relayout for weights consumed by fused kernels (set by
    # fusion recognizers, never by the text-IR parser): `transform` names an
    # entry in runtime.planner.WEIGHT_TRANSFORMS, `file_shape` is the shape
    # the provider stores; `shape` above is the transformed device shape.
    transform: Optional[str] = None
    file_shape: Optional[Tuple[int, ...]] = None
    # this rank's slice of a weight placed on a mesh, ((axis, start, stop),
    # ...) of ``file_shape`` (set by parallel/spmd.py, never by the parser);
    # ``shape`` is then the local shape
    shard: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @property
    def is_weight(self) -> bool:
        return self.dtype != DType.none

    @property
    def has_dynamic_dims(self) -> bool:
        return any(d == 0 for d in self.shape)

    @property
    def nelem(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.nelem * (self.dtype.itemsize if self.is_weight else 4)

    def to_string(self) -> str:
        if not self.name:
            return ""  # absent optional input
        shape = ",".join(str(d) for d in self.shape)
        if self.dtype == DType.none:
            return f"{self.name}({shape})"
        if self.dtype == DType.uint8:
            scale = f"{self.scale:.17g}"
            return f"{self.name}(uint8[{scale},{self.zero_point}]:{shape})"
        return f"{self.name}({self.dtype.value}:{shape})"


@dataclasses.dataclass
class OpNode:
    """One operation (one model.txt line)."""

    name: str
    op_type: str
    inputs: List[TensorSpec]
    outputs: List[TensorSpec]
    attrs: Dict[str, str]

    def attr(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.attrs.get(key, default)

    def attr_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.attrs.get(key)
        return default if v is None else int(v)

    def attr_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        v = self.attrs.get(key)
        return default if v is None else float(v)

    def attr_ints(self, key: str, default: Optional[Sequence[int]] = None) -> Optional[Tuple[int, ...]]:
        v = self.attrs.get(key)
        if v is None:
            return tuple(default) if default is not None else None
        if v == "":
            return ()
        return tuple(int(x) for x in v.split(","))

    def attr_floats(self, key: str, default: Optional[Sequence[float]] = None) -> Optional[Tuple[float, ...]]:
        v = self.attrs.get(key)
        if v is None:
            return tuple(default) if default is not None else None
        if v == "":
            return ()
        return tuple(float(x) for x in v.split(","))

    def to_line(self) -> str:
        parts = [
            f"{self.name}:{self.op_type}",
            "input:" + ";".join(t.to_string() for t in self.inputs),
            "output:" + ";".join(t.to_string() for t in self.outputs),
        ]
        if self.attrs:
            parts.append(";".join(f"{k}:{v}" for k, v in self.attrs.items()))
        return "*".join(parts)


@dataclasses.dataclass
class Graph:
    """A parsed program: a straight-line sequence of ops.

    `inputs` are tensor names consumed before they are produced and not
    weights; `weights` are every distinct weight reference in first-use order
    (the stream order the reference announces via WeightsProvider::on_init,
    src/onnxstream.cpp:3499-3548).
    """

    ops: List[OpNode]

    def __post_init__(self) -> None:
        produced: Dict[str, TensorSpec] = {}
        inputs: Dict[str, TensorSpec] = {}
        weights: Dict[str, TensorSpec] = {}
        consumers: Dict[str, int] = {}
        for op in self.ops:
            for t in op.inputs:
                if not t.name:
                    continue
                if t.is_weight:
                    weights.setdefault(t.name, t)
                elif t.name not in produced:
                    inputs.setdefault(t.name, t)
                if not t.is_weight:
                    consumers[t.name] = consumers.get(t.name, 0) + 1
            for t in op.outputs:
                if t.name:
                    produced[t.name] = t
        self.inputs: Dict[str, TensorSpec] = inputs
        self.weights: Dict[str, TensorSpec] = weights
        self.produced: Dict[str, TensorSpec] = produced
        # consumer refcounts for intermediates — the reference's
        # m_intermediate_refs free-after-last-use plan (onnxstream.cpp:3511).
        self.refcounts: Dict[str, int] = consumers

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def weight_bytes(self) -> int:
        return sum(t.nbytes for t in self.weights.values())

    def to_text(self) -> str:
        return "\n".join(op.to_line() for op in self.ops) + "\n"

    def output_names(self) -> List[str]:
        """Graph outputs = produced tensors never consumed afterwards."""
        consumed = set()
        for op in self.ops:
            for t in op.inputs:
                consumed.add(t.name)
        outs: List[str] = []
        for op in self.ops:
            for t in op.outputs:
                if t.name and t.name not in consumed and t.name not in outs:
                    outs.append(t.name)
        return outs


def _split_outside(s: str, sep: str) -> List[str]:
    """Split on sep — the grammar never nests separators, so plain split works
    (the reference uses the same flat split, onnxstream.cpp:2154-2175)."""
    return s.split(sep)


def parse_tensor_string(s: str, allow_dynamic: bool = False) -> TensorSpec:
    """Parse `name(shape)` / `name(dtype:shape)` / `name(uint8[sc,zp]:shape)`.

    Mirrors reference Model::parse_tensor_string (onnxstream.cpp:2540-2616).
    """
    if not s:
        return TensorSpec(name="")
    lp = s.find("(")
    if lp <= 0 or not s.endswith(")"):
        raise ValueError(f"invalid tensor format: {s!r}")
    name = s[:lp]
    body = s[lp + 1 : -1]

    dtype = DType.none
    scale = 0.0
    zero_point = 0
    shape_str = body
    colon = body.find(":")
    if colon != -1:
        type_str, shape_str = body[:colon], body[colon + 1 :]
        if type_str.startswith("uint8[") and type_str.endswith("]"):
            rng = type_str[6:-1].split(",")
            if len(rng) != 2:
                raise ValueError(f"invalid uint8 range in {s!r}")
            dtype = DType.uint8
            scale = float(rng[0])
            zero_point = int(rng[1])
        elif type_str in ("float16", "float32", "int64", "bfloat16", "int8", "int32", "bool"):
            dtype = DType(type_str if type_str != "bool" else "bool")
        else:
            raise ValueError(f"unsupported tensor dtype in {s!r}")

    shape: List[int] = []
    if shape_str:
        for dim in shape_str.split(","):
            d = int(dim)
            if d < 0:
                raise ValueError(f"invalid negative dim in {s!r}")
            if d == 0 and not allow_dynamic:
                raise ValueError(
                    f"dynamic dim in {s!r} but dynamic shapes not enabled "
                    "(set support_dynamic_shapes)"
                )
            shape.append(d)
    return TensorSpec(name=name, shape=tuple(shape), dtype=dtype, scale=scale, zero_point=zero_point)


def parse_op_line(line: str, lineno: int = 0, allow_dynamic: bool = False) -> OpNode:
    """Parse one op line (mirrors reference Model::next_op_impl, onnxstream.cpp:2445)."""
    vec = _split_outside(line, "*")
    if len(vec) not in (3, 4):
        raise ValueError(f"line {lineno}: invalid op line (need 3 or 4 '*' fields): {line[:120]!r}")

    colon = vec[0].rfind(":")
    if colon == -1:
        raise ValueError(f"line {lineno}: missing ':' in op name field")
    name, op_type = vec[0][:colon], vec[0][colon + 1 :]
    if not name:
        name = f"onnxstream_fallback_name_{lineno}"

    if not vec[1].startswith("input:"):
        raise ValueError(f"line {lineno}: second field must start with 'input:'")
    inputs = [parse_tensor_string(t, allow_dynamic) for t in _split_outside(vec[1][6:], ";")]
    if not vec[2].startswith("output:"):
        raise ValueError(f"line {lineno}: third field must start with 'output:'")
    outputs = [parse_tensor_string(t, allow_dynamic) for t in _split_outside(vec[2][7:], ";")]

    attrs: Dict[str, str] = {}
    if len(vec) == 4 and vec[3]:
        for pair in _split_outside(vec[3], ";"):
            if not pair:
                continue
            k, sep, v = pair.partition(":")
            if not sep:
                raise ValueError(f"line {lineno}: invalid attribute {pair!r}")
            attrs[k] = v
    return OpNode(name=name, op_type=op_type, inputs=inputs, outputs=outputs, attrs=attrs)


def parse_model_txt(text: str, allow_dynamic: bool = False) -> Graph:
    """Parse a whole model.txt program into a Graph."""
    ops: List[OpNode] = []
    for lineno, raw in enumerate(text.splitlines()):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        ops.append(parse_op_line(line, lineno, allow_dynamic))
    return Graph(ops=ops)


def parse_model_file(path: str, allow_dynamic: bool = False) -> Graph:
    with open(path, "r") as f:
        return parse_model_txt(f.read(), allow_dynamic)

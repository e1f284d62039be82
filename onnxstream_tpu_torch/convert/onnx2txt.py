"""onnx2txt: convert an ONNX model to the model.txt + .bin format.

Counterpart of ``onnxstream_tpu/convert/onnx2txt.py`` (a functional re-host
of the reference converter notebook, reference onnx2txt/onnx2txt.ipynb),
with the same signature, options and output: for the same ONNX bytes the
``model.txt`` and every ``.bin`` file are byte-identical to the JAX
converter's (``tests/test_torch_convert.py``). Two deliberate differences
from the notebook, both the JAX converter's:

  * no `onnx` dependency: the protobuf is decoded by
    ``onnxstream_tpu_torch/convert/onnxproto.py``;
  * shape inference runs through the port's own op implementations instead
    of onnx.shape_inference, so any op the runtime executes the converter
    can also infer: nodes whose inputs are all known run on CPU tensors on
    the host context (as ``runtime/planner.py`` folds them), the rest on
    ``meta`` tensors (as the planner checks device ops), where the JAX
    converter uses ``jax.eval_shape``.

Behaviors preserved from the notebook:

  * name mangling: non-alphanumeric chars -> _HEX_ (also src/bindings.py:310);
  * Constant nodes inlined as weights;
  * Gemm transA/transB folded by pre-transposing the weight, renamed
    `*_transposed`, attribute dropped;
  * Conv weights written twice: `*_nhwc.bin` (0,2,3,1 transpose) and
    `*_nchw.bin` (the line references _nchw); Conv1D weights promoted to 4-D;
  * int64 weights feeding Mul input 1 cast to float32;
  * optional fp32->fp16 weight conversion;
  * optional uint8 percentile quantization (0.1% tails, scale/zero folded into
    the `uint8[scale,zp]:` dtype prefix) with the notebook's exclusions:
    Conv bias, InstanceNormalization scale/bias, Resize scales.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from onnxstream_tpu_torch.convert.onnxproto import DTYPE_OF, NodeInfo, OnnxGraph, TensorInfo, load_onnx
from onnxstream_tpu_torch.dtypes import mangle_name, to_numpy, to_torch, torch_dtype
from onnxstream_tpu_torch.ir import OpNode, TensorSpec
from onnxstream_tpu_torch.ops import Ctx, StaticRequired, get_impl
from onnxstream_tpu_torch.runtime.config import SessionConfig

_META = torch.device("meta")


def quantize_uint8(a: np.ndarray, from_left: float = 0.001, from_right: float = 0.001):
    """Notebook quantize(): percentile range -> (uint8 array, scale, zero) or
    None when not quantizable."""
    flat = np.asarray(a, np.float64).ravel()
    s = np.sort(flat[np.isfinite(flat)])
    if len(s) == 1 and flat.size == 1:
        scale = float(abs(flat[0]))
        zero = 0 if flat[0] >= 0 else 2
        return np.array([1], np.uint8), scale, zero
    if len(s) >= 2:
        left = float(s[int(len(s) * from_left)])
        right = float(s[int(len(s) * from_right * -1 - 1)])
        if left > 0 and right > 0:
            left = 0
        elif left < 0 and right < 0:
            right = 0
        if right > left:
            scale = (right - left) / 255.0
            zero = min(int(abs(left) / scale), 255)
            q = np.clip(a / scale + zero, 0, 255).astype(np.uint8)
            return q, scale, zero
    return None


_QUANT_EXCLUDED = {
    # (op_type, input_index) combinations never quantized (notebook quantize())
    ("Conv", 2),
    ("InstanceNormalization", 1),
    ("InstanceNormalization", 2),
    ("Resize", 2),
}


class _ShapeInference:
    """Per-node shape propagation through the port's op impls."""

    def __init__(self, graph: OnnxGraph):
        self.config = SessionConfig(compute_dtype="float32", device=torch.device("cpu"))
        # name -> ('static', np array) | ('sym', meta tensor)
        self.env: Dict[str, tuple] = {}
        for t in graph.inputs:
            if t.name in graph.initializers:
                continue
            dt = torch_dtype(DTYPE_OF.get(t.elem_type, np.dtype(np.float32)))
            if dt == torch.int64:
                dt = torch.int32  # device integers are 32-bit, as jax.eval_shape makes them
            self.env[t.name] = ("sym", torch.empty(t.dims, dtype=dt, device=_META))
        for name, t in graph.initializers.items():
            self.env[name] = ("static", t.data)

    def add_constant(self, name: str, arr: np.ndarray) -> None:
        self.env[name] = ("static", arr)

    def _attr_str(self, v) -> str:
        if isinstance(v, (list, tuple)):
            return ",".join(str(x) for x in v)
        if isinstance(v, TensorInfo):
            # keep the source dtype: a bare scalar would be materialized as
            # float32 by ConstantOfShape (reference std::stof semantics)
            vals = v.data.flatten().tolist()
            return f"{np.dtype(v.data.dtype).name}:{vals[0]}"
        if isinstance(v, float):
            return str(v)
        return str(v)

    def infer(self, node: NodeInfo) -> List[Tuple[Tuple[int, ...], object]]:
        """Output (shape, dtype) list; also folds static ops so downstream
        shape math keeps concrete values."""
        attrs = {k: self._attr_str(v) for k, v in node.attrs.items()}
        in_specs = [TensorSpec(name=mangle_name(n) if n else "") for n in node.inputs]
        out_specs = [TensorSpec(name=mangle_name(n)) for n in node.outputs]
        op = OpNode(name=node.name or node.op_type, op_type=node.op_type,
                    inputs=in_specs, outputs=out_specs, attrs=attrs)
        impl = get_impl(node.op_type)

        resolved = []
        for n in node.inputs:
            if not n:
                resolved.append(("none", None))
            elif n in self.env:
                resolved.append(self.env[n])
            else:
                raise ValueError(f"{node.op_type} {node.name}: unknown input {n!r}")

        # Shape of a symbolic tensor is fully determined by its inferred
        # shape: emit a STATIC value so downstream shape math (the torch
        # GroupNorm Reshape(x, Shape(x)) pattern and friends) keeps folding
        if node.op_type == "Shape" and resolved and resolved[0][0] == "sym":
            dims = np.asarray(resolved[0][1].shape, np.int64)
            start = int(attrs.get("start", "0") or 0)
            end = attrs.get("end")
            dims = dims[start : int(end) if end not in (None, "") else None]
            self.env[node.outputs[0]] = ("static", dims)
            return [(tuple(dims.shape), dims.dtype)]

        if all(k in ("static", "none") for k, _ in resolved):
            ctx = Ctx("host", self.config, op.name)
            outs = impl.fn(ctx, op, [None if v is None else to_torch(np.asarray(v)) for _, v in resolved])
            outs = [to_numpy(o) if isinstance(o, torch.Tensor) else np.asarray(o) for o in outs]
            for name, o in zip(node.outputs, outs):
                self.env[name] = ("static", o)
            return [(tuple(o.shape), o.dtype) for o in outs]

        ins = [None if kind == "none" else val for kind, val in resolved]
        try:
            outs = impl.fn(Ctx("device", self.config, op.name, device=_META), op, ins)
        except StaticRequired as e:
            raise ValueError(f"{node.op_type} {node.name}: input {e.index} must be a constant") from e
        res = []
        for name, o in zip(node.outputs, outs):
            self.env[name] = ("sym", torch.empty(tuple(o.shape), dtype=o.dtype, device=_META))
            res.append((tuple(int(d) for d in o.shape), o.dtype))
        return res


def _is_int64(dt) -> bool:
    return dt == torch.int64 or (not isinstance(dt, torch.dtype) and np.dtype(dt) == np.int64)


def convert(
    onnx_bytes_or_path,
    dest_folder: str,
    fp16: bool = False,
    quantize: bool = False,
    mangle: bool = True,
    input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
) -> str:
    """Convert ONNX -> dest_folder/model.txt (+ .bin weights). Returns the
    model.txt contents."""
    if isinstance(onnx_bytes_or_path, (bytes, bytearray, memoryview)):
        data = bytes(onnx_bytes_or_path)
    else:
        data = open(onnx_bytes_or_path, "rb").read()
    graph = load_onnx(data)
    # symbolic/unknown input dims (decoded as -1/0) cannot become model.txt
    # shapes; the caller pins them via input_shapes
    for t in graph.inputs:
        if t.name in graph.initializers:
            continue
        if input_shapes and t.name in input_shapes:
            t.dims = tuple(input_shapes[t.name])
        if any(d <= 0 for d in t.dims):
            raise ValueError(
                f"graph input {t.name!r} has dynamic/unknown dims {t.dims}; "
                f"re-export with static shapes or pass input_shapes={{{t.name!r}: (...)}}"
            )
    os.makedirs(dest_folder, exist_ok=True)

    def final_name(n: str) -> str:
        return mangle_name(n) if mangle else n

    inference = _ShapeInference(graph)
    # Constant nodes become weights (notebook op_constants)
    nodes: List[NodeInfo] = []
    constants: Dict[str, TensorInfo] = {}
    for node in graph.nodes:
        if node.op_type == "Constant" and len(node.outputs) == 1 and not node.inputs:
            t = node.attrs.get("value")
            if not isinstance(t, TensorInfo):
                raise ValueError(f"Constant {node.name}: unsupported attribute set")
            constants[node.outputs[0]] = t
            inference.add_constant(node.outputs[0], t.data)
            continue
        nodes.append(node)

    weights = dict(graph.initializers)
    for n, t in constants.items():
        weights[n] = t
    graph_io_shapes = {t.name: t.dims for t in list(graph.inputs) + list(graph.outputs)}

    # a weight consumed by several nodes is re-saved per consumer; when
    # consumers apply DIFFERENT transforms (quantize exclusions, int64->f32
    # Mul cast, Gemm transpose), last-writer-wins would corrupt the shared
    # .bin while model.txt still references both forms — detect the conflict
    # by content and fork the name (reference quantize.py applies an
    # every-consumer rule; this is the general converter-side guard)
    import hashlib

    _written: Dict[str, str] = {}

    def save_bin(name: str, arr: np.ndarray) -> None:
        arr.tofile(os.path.join(dest_folder, name))

    def dedup_name(name: str, blob: np.ndarray) -> str:
        digest = hashlib.sha1(blob.tobytes()).hexdigest()
        # fork BEFORE a trailing _nchw so the forked name keeps the
        # `X_nchw.bin` <-> `X_nhwc.bin` companion convention
        # (utils/download.py:102, reference sd.cpp:3156-3183)
        base, suffix = name, ""
        if base.endswith("_nchw"):
            base, suffix = base[: -len("_nchw")], "_nchw"
        cand = base + suffix
        k = 2
        while cand in _written and _written[cand] != digest:
            cand = f"{base}__v{k}{suffix}"
            k += 1
        _written[cand] = digest
        return cand

    lines: List[str] = []
    for node in nodes:
        out_shapes = inference.infer(node)

        def weight_ref(wname: str, input_index: int) -> str:
            t = weights[wname]
            a = np.asarray(t.data)
            name = final_name(wname)
            # int64 feeding Mul input 1 is numeric when the product is float
            # (notebook rule: the reference Mul is float-only) — but when the
            # Mul's inferred OUTPUT is int64, it is shape math (torch chunk()
            # exports Shape->Div->Mul->Slice index chains) and the cast would
            # break the static-index fold downstream
            if (
                node.op_type == "Mul"
                and input_index == 1
                and a.dtype == np.int64
                and (not out_shapes or not _is_int64(out_shapes[0][1]))
            ):
                a = a.astype(np.float32)
            if fp16 and a.dtype == np.float32:
                a = a.astype(np.float16)
            tstr = str(a.dtype)
            if tstr not in ("float32", "float16", "int64"):
                raise ValueError(f"weight {wname}: unsupported dtype {tstr}")
            if quantize and a.dtype == np.float32 and (node.op_type, input_index) not in _QUANT_EXCLUDED:
                q = quantize_uint8(a)
                if q is not None:
                    a, scale, zero = q
                    tstr = f"uint8[{scale},{zero}]"
            if node.op_type == "Gemm":
                trans_attr = "transA" if input_index == 0 else "transB" if input_index == 1 else None
                if trans_attr and int(node.attrs.get(trans_attr, 0) or 0):
                    a = np.ascontiguousarray(a.T)
                    name += "_transposed"
                    node.attrs.pop(trans_attr, None)
            elif node.op_type == "Conv" and input_index == 1:
                if a.ndim == 3:  # Conv1D promote
                    a = a[..., np.newaxis]
                if a.ndim != 4:
                    raise ValueError(f"Conv weight {wname}: rank {a.ndim}")
                name += "_nchw"
            shape = ",".join(str(d) for d in a.shape)
            blob = np.ascontiguousarray(a)
            name = dedup_name(name, blob)
            if name.endswith("_nchw"):
                save_bin(name[: -len("_nchw")] + "_nhwc.bin",
                         np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1))))
            save_bin(name + ".bin", blob)
            return f"{name}.bin({tstr}:{shape})"

        parts = [f"{final_name(node.name) if node.name else node.op_type}:{node.op_type}"]
        ins = []
        for i, n in enumerate(node.inputs):
            if not n:
                ins.append("")
            elif n in weights:
                ins.append(weight_ref(n, i))
            else:
                kind, val = inference.env[n]
                shape = val.shape if kind == "sym" else np.asarray(val).shape
                if n in graph_io_shapes and not shape:
                    shape = graph_io_shapes[n]
                ins.append(f"{final_name(n)}({','.join(str(d) for d in shape)})")
        parts.append("input:" + ";".join(ins))

        outs = []
        for (shape, _dt), n in zip(out_shapes, node.outputs):
            outs.append(f"{final_name(n)}({','.join(str(d) for d in shape)})")
        parts.append("output:" + ";".join(outs))

        attrs = []
        for k, v in node.attrs.items():
            attrs.append(f"{k}:{inference._attr_str(v)}")
        if attrs:
            parts.append(";".join(attrs))

        lines.append("*".join(parts))

    text = "\n".join(lines) + "\n"
    with open(os.path.join(dest_folder, "model.txt"), "w") as f:
        f.write(text)
    return text

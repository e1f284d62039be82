"""GraphBuilder: author model.txt programs directly.

The reference ecosystem produces model.txt by converting ONNX files
(onnx2txt/onnx2txt.ipynb); the YOLO browser example also *prepends/appends op
lines as text* (reference examples/YOLOv8n_wasm/index.html:413-421) — the text
IR is an authoring surface. This builder makes that surface first-class: it
emits ops with declared shapes (so the runtime's check_output_shape works),
collects weight arrays, and mirrors the converter's decompositions
(GroupNorm -> Reshape+InstanceNormalization+Reshape+Mul+Add, LayerNorm ->
ReduceMean/Sub/Pow/..., GELU -> Div/Erf/Add/Mul, attention -> MatMul/Mul/
Softmax/MatMul so the runtime's fusion recognizers fire on built models
exactly as they do on converted ones).

Counterpart of ``onnxstream_tpu/convert/builder.py``: the same builder, so the
port can build the SD UNet graph on a machine without JAX. Both produce the
same text and the same numpy weight arrays for the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec


@dataclasses.dataclass(frozen=True)
class T:
    """A tensor handle inside the builder."""

    name: str
    shape: Tuple[int, ...]

    @property
    def rank(self) -> int:
        return len(self.shape)


class LazyArray:
    """Shape/dtype-known weight placeholder whose data generates on demand.

    Built by GraphBuilder(lazy_weights=True) + gen_weight(shape=...): the
    multi-GB synthetic LLM weights never materialize on the host when the
    executor device-synthesizes them (SessionConfig.synthetic_device_weights)
    — `make()` only runs if someone actually reads the array (e.g. a
    CPU-oracle test or the static-weight planner)."""

    def __init__(self, shape, dtype, make):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self._make = make
        self._arr: Optional[np.ndarray] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def materialize(self) -> np.ndarray:
        if self._arr is None:
            arr = np.ascontiguousarray(self._make())
            assert tuple(arr.shape) == self.shape and arr.dtype == self.dtype, (
                f"lazy weight declared {self.shape}/{self.dtype}, "
                f"make() produced {arr.shape}/{arr.dtype}"
            )
            self._arr = arr
        return self._arr

    def __array__(self, dtype=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class GraphBuilder:
    def __init__(self, seed: int = 0, weight_bank: Optional[Dict[str, np.ndarray]] = None,
                 lazy_weights: bool = False):
        self.ops: List[OpNode] = []
        self.weights: Dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)
        # cross-build weight reuse: pipelines that build one graph per shape
        # bucket (LLM (L, P) buckets, SDXL tiled decode) pass a persistent
        # dict here so the multi-GB synthetic weights are generated ONCE —
        # rebuilding the TinyLlama graph drops from ~140 s to ~2 s
        self.weight_bank = weight_bank
        # lazy_weights: gen_weight(shape=...) stores LazyArray placeholders
        # instead of materialized arrays, for device-side synthesis
        self.lazy_weights = lazy_weights
        self._n = 0

    # ------------------------------------------------------------- plumbing
    def _name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def input(self, name: str, shape: Sequence[int]) -> T:
        return T(name, tuple(shape))

    def weight(self, name: str, arr) -> TensorSpec:
        if not isinstance(arr, LazyArray):
            arr = np.ascontiguousarray(arr)
        if not name.endswith(".bin"):
            name = name + ".bin"
        if name in self.weights:
            if self.weights[name] is not arr and tuple(self.weights[name].shape) != tuple(arr.shape):
                raise ValueError(f"conflicting weight {name}")
        else:
            self.weights[name] = arr
        return TensorSpec(name=name, shape=tuple(arr.shape), dtype=DType.from_np(arr.dtype))

    def gen_weight(self, name: str, make, shape=None, dtype=np.float32) -> TensorSpec:
        """weight() with bank-aware lazy generation: `make()` only runs when
        the array is not already in the weight_bank. With lazy_weights and a
        declared `shape`, a LazyArray placeholder is stored instead — the
        data only materializes if something host-reads it."""
        full = name if name.endswith(".bin") else name + ".bin"
        if self.weight_bank is not None:
            arr = self.weight_bank.get(full)
            if arr is None:
                if self.lazy_weights and shape is not None:
                    arr = LazyArray(shape, dtype, make)
                else:
                    arr = np.ascontiguousarray(make())
                self.weight_bank[full] = arr
        elif self.lazy_weights and shape is not None:
            arr = LazyArray(shape, dtype, make)
        else:
            arr = make()
        return self.weight(name, arr)

    def randn(self, *shape, scale: Optional[float] = None) -> np.ndarray:
        if scale is None:
            fan_in = shape[-1] if len(shape) >= 2 else shape[0]
            if len(shape) == 4:
                fan_in = shape[1] * shape[2] * shape[3]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        # in-place scale: `* scale` + `.astype` would write the multi-GB
        # synthetic LLM weights three times instead of once
        arr = self.rng.standard_normal(shape, dtype=np.float32)
        arr *= np.float32(scale)
        return arr

    def emit(
        self,
        op_type: str,
        inputs: Sequence[Union[T, TensorSpec, None]],
        out_shapes: Sequence[Sequence[int]],
        attrs: Optional[Dict[str, str]] = None,
        name: Optional[str] = None,
        out_names: Optional[Sequence[str]] = None,
    ) -> Union[T, List[T]]:
        name = name or self._name(op_type)
        in_specs = []
        for x in inputs:
            if x is None:
                in_specs.append(TensorSpec(name=""))
            elif isinstance(x, TensorSpec):
                in_specs.append(x)
            else:
                in_specs.append(TensorSpec(name=x.name, shape=x.shape))
        outs = []
        out_specs = []
        for i, sh in enumerate(out_shapes):
            oname = out_names[i] if out_names else f"{name}_out{i}" if len(out_shapes) > 1 else f"{name}_out"
            outs.append(T(oname, tuple(int(d) for d in sh)))
            out_specs.append(TensorSpec(name=oname, shape=tuple(int(d) for d in sh)))
        self.ops.append(
            OpNode(
                name=name,
                op_type=op_type,
                inputs=list(in_specs),
                outputs=out_specs,
                attrs={k: str(v) for k, v in (attrs or {}).items()},
            )
        )
        return outs[0] if len(outs) == 1 else outs

    def graph(self) -> Graph:
        return Graph(ops=list(self.ops))

    def to_text(self) -> str:
        return self.graph().to_text()

    def save(self, directory: str, float16: bool = False) -> None:
        """Write model.txt + .bin weight files (the converter's disk layout).
        A weight name that holds '/' lands in subfolders, as the reference's
        converted folders have them. With ``float16`` the float32 weights
        are written as float16 and model.txt declares them so (the
        reference's ``*_fp16`` folders, e.g. ``unet_fp16``). LazyArray
        placeholders are materialized."""
        import os

        os.makedirs(directory, exist_ok=True)
        for name, arr in self.weights.items():
            a = np.asarray(arr)
            if float16 and a.dtype == np.float32:
                a = a.astype(np.float16)
            path = os.path.join(directory, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            a.tofile(path)
        graph = self.graph()
        if float16:
            half = lambda t: dataclasses.replace(t, dtype=DType.float16) if t.dtype == DType.float32 else t
            graph = Graph(ops=[dataclasses.replace(op, inputs=[half(t) for t in op.inputs]) for op in graph.ops])
        with open(os.path.join(directory, "model.txt"), "w") as f:
            f.write(graph.to_text())

    # ---------------------------------------------------------- primitives
    def conv(
        self,
        x: T,
        cout: int,
        k: int = 3,
        stride: int = 1,
        pad: Optional[int] = None,
        groups: int = 1,
        name: Optional[str] = None,
        bias: bool = True,
    ) -> T:
        n, cin, h, w_ = x.shape
        if pad is None:
            pad = k // 2
        nm = name or self._name("conv")
        wshape = (cout, cin // groups, k, k)
        wspec = self.gen_weight(f"{nm}.weight_nchw",
                                lambda: self.randn(*wshape), shape=wshape)
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w_ + 2 * pad - k) // stride + 1
        ins = [x, wspec]
        if bias:
            ins.append(self.gen_weight(f"{nm}.bias",
                                       lambda: self.randn(cout, scale=0.01),
                                       shape=(cout,)))
        return self.emit(
            "Conv",
            ins,
            [(n, cout, ho, wo)],
            {
                "dilations": "1,1",
                "group": groups,
                "kernel_shape": f"{k},{k}",
                "pads": f"{pad},{pad},{pad},{pad}",
                "strides": f"{stride},{stride}",
            },
            name=nm,
        )

    def matmul_w(self, x: T, dout: int, name: Optional[str] = None, bias: bool = True) -> T:
        """x (..., din) @ W(din, dout) [+ b] — the converted-linear shape."""
        din = x.shape[-1]
        nm = name or self._name("linear")
        w = self.gen_weight(f"{nm}.weight", lambda: self.randn(din, dout), shape=(din, dout))
        y = self.emit("MatMul", [x, w], [x.shape[:-1] + (dout,)], name=nm + "/MatMul")
        if bias:
            b = self.gen_weight(f"{nm}.bias", lambda: self.randn(dout, scale=0.01), shape=(dout,))
            y = self.emit("Add", [y, b], [y.shape], name=nm + "/Add")
        return y

    def binary(self, op: str, a: T, b: Union[T, TensorSpec], out_shape=None, name=None) -> T:
        if out_shape is None:
            sa = a.shape
            sb = b.shape if isinstance(b, (T, TensorSpec)) else ()
            rank = max(len(sa), len(sb))
            sa = (1,) * (rank - len(sa)) + tuple(sa)
            sb = (1,) * (rank - len(sb)) + tuple(sb)
            out_shape = tuple(max(x, y) for x, y in zip(sa, sb))
        return self.emit(op, [a, b], [out_shape], name=name)

    def add(self, a, b, **kw):
        return self.binary("Add", a, b, **kw)

    def mul(self, a, b, **kw):
        return self.binary("Mul", a, b, **kw)

    def scalar(self, value: float, name: Optional[str] = None) -> TensorSpec:
        nm = name or self._name("const")
        return self.weight(nm, np.array([value], np.float32))

    def sigmoid(self, x: T) -> T:
        return self.emit("Sigmoid", [x], [x.shape])

    def silu(self, x: T) -> T:
        return self.mul(x, self.sigmoid(x))

    def gelu(self, x: T) -> T:
        """erf-GELU decomposition as ONNX exports emit it."""
        h = self.binary("Div", x, self.scalar(math.sqrt(2.0)))
        h = self.emit("Erf", [h], [x.shape])
        h = self.add(h, self.scalar(1.0))
        h = self.mul(x, h)
        return self.mul(h, self.scalar(0.5))

    def quick_gelu(self, x: T) -> T:
        """x * sigmoid(1.702 x) (CLIP)."""
        return self.mul(x, self.sigmoid(self.mul(x, self.scalar(1.702))))

    def reshape(self, x: T, shape: Sequence[int], name=None) -> T:
        shape = tuple(int(s) for s in shape)
        total = int(np.prod(x.shape))
        if -1 in shape:
            known = -int(np.prod(shape))
            shape = tuple(total // known if s == -1 else s for s in shape)
        assert int(np.prod(shape)) == total, (x.shape, shape)
        spec = self.weight(self._name("shape"), np.asarray(shape, np.int64))
        return self.emit("Reshape", [x, spec], [shape], name=name)

    def transpose(self, x: T, perm: Sequence[int], name=None) -> T:
        out = tuple(x.shape[p] for p in perm)
        return self.emit("Transpose", [x], [out], {"perm": ",".join(map(str, perm))}, name=name)

    def softmax(self, x: T, axis: int = -1) -> T:
        return self.emit("Softmax", [x], [x.shape], {"axis": axis})

    def concat(self, xs: Sequence[T], axis: int, name=None) -> T:
        ax = axis % len(xs[0].shape)
        out = list(xs[0].shape)
        out[ax] = sum(x.shape[ax] for x in xs)
        return self.emit("Concat", list(xs), [tuple(out)], {"axis": axis}, name=name)

    def split(self, x: T, sizes: Sequence[int], axis: int) -> List[T]:
        ax = axis % x.rank
        spec = self.weight(self._name("split"), np.asarray(sizes, np.int64))
        shapes = []
        for s in sizes:
            sh = list(x.shape)
            sh[ax] = s
            shapes.append(tuple(sh))
        out = self.emit("Split", [x, spec], shapes, {"axis": axis})
        return out if isinstance(out, list) else [out]

    def group_norm(self, x: T, groups: int = 32, name: Optional[str] = None, affine: bool = True) -> T:
        """GroupNorm as the converter decomposes it:
        Reshape(N,G,-1) -> InstanceNormalization -> Reshape back -> Mul -> Add."""
        n, c, h, w_ = x.shape
        nm = name or self._name("gn")
        r = self.reshape(x, (n, groups, c // groups * h * w_), name=nm + "/pre")
        ones = self.weight(f"{nm}.inorm_scale", np.ones(groups, np.float32))
        zeros = self.weight(f"{nm}.inorm_bias", np.zeros(groups, np.float32))
        r = self.emit("InstanceNormalization", [r, ones, zeros], [r.shape], {"epsilon": 1e-5}, name=nm + "/inorm")
        r = self.reshape(r, (n, c, h, w_), name=nm + "/post")
        if affine:
            g = self.weight(f"{nm}.weight", np.ones((c, 1, 1), np.float32))
            b = self.weight(f"{nm}.bias", np.zeros((c, 1, 1), np.float32))
            r = self.mul(r, g, name=nm + "/mul")
            r = self.add(r, b, name=nm + "/add")
        return r

    def layer_norm(self, x: T, name: Optional[str] = None, affine: bool = True) -> T:
        """LayerNorm decomposition (opset<17 export): ReduceMean/Sub/Pow/
        ReduceMean/Add/Sqrt/Div (+ Mul/Add affine)."""
        nm = name or self._name("ln")
        d = x.shape[-1]
        mean = self.emit("ReduceMean", [x], [x.shape[:-1] + (1,)], {"axes": "-1", "keepdims": 1}, name=nm + "/mean")
        centered = self.binary("Sub", x, mean, out_shape=x.shape, name=nm + "/sub")
        sq = self.binary("Pow", centered, self.scalar(2.0), out_shape=x.shape, name=nm + "/pow")
        var = self.emit("ReduceMean", [sq], [x.shape[:-1] + (1,)], {"axes": "-1", "keepdims": 1}, name=nm + "/var")
        var = self.add(var, self.scalar(1e-5), name=nm + "/eps")
        std = self.emit("Sqrt", [var], [var.shape], name=nm + "/sqrt")
        y = self.binary("Div", centered, std, out_shape=x.shape, name=nm + "/div")
        if affine:
            g = self.weight(f"{nm}.weight", np.ones(d, np.float32))
            b = self.weight(f"{nm}.bias", np.zeros(d, np.float32))
            y = self.mul(y, g, name=nm + "/mul")
            y = self.add(y, b, name=nm + "/bias")
        return y

    def attention(
        self,
        x: T,
        context: Optional[T] = None,
        heads: int = 8,
        name: Optional[str] = None,
        causal_mask: Optional[TensorSpec] = None,
        dim_head: Optional[int] = None,
        qkv_bias: bool = False,
    ) -> T:
        """Multi-head attention in the converted-model decomposition:
        projections + reshape/transpose + MatMul/Mul(scale)/Softmax/MatMul.
        The runtime fuses the core into ostpu.sdpa (flash attention)."""
        nm = name or self._name("attn")
        b, l, d = x.shape
        ctx = context if context is not None else x
        lk = ctx.shape[1]
        dh = dim_head or d // heads
        inner = heads * dh

        q = self.matmul_w(x, inner, name=nm + "/to_q", bias=qkv_bias)
        k = self.matmul_w(ctx, inner, name=nm + "/to_k", bias=qkv_bias)
        v = self.matmul_w(ctx, inner, name=nm + "/to_v", bias=qkv_bias)

        def split_heads(t, ln, tag):
            t = self.reshape(t, (b, ln, heads, dh), name=f"{nm}/{tag}_r1")
            return self.transpose(t, (0, 2, 1, 3), name=f"{nm}/{tag}_t")

        qh = split_heads(q, l, "q")
        kh = split_heads(k, lk, "k")
        vh = split_heads(v, lk, "v")
        kt = self.transpose(kh, (0, 1, 3, 2), name=f"{nm}/kT")
        logits = self.emit("MatMul", [qh, kt], [(b, heads, l, lk)], name=f"{nm}/qk")
        logits = self.mul(logits, self.scalar(1.0 / math.sqrt(dh), name=f"{nm}.scale"), name=f"{nm}/scale")
        if causal_mask is not None:
            logits = self.emit("Add", [logits, causal_mask], [(b, heads, l, lk)], name=f"{nm}/mask")
        probs = self.softmax(logits, -1)
        o = self.emit("MatMul", [probs, vh], [(b, heads, l, dh)], name=f"{nm}/pv")
        o = self.transpose(o, (0, 2, 1, 3), name=f"{nm}/o_t")
        o = self.reshape(o, (b, l, inner), name=f"{nm}/o_r")
        return self.matmul_w(o, d, name=nm + "/to_out")

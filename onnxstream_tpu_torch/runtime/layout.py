"""NHWC layout rewrite: the channel-last graph pass.

Counterpart of ``onnxstream_tpu/runtime/layout.py``, the same rewrite op for
op (``tests/test_torch_layout.py`` holds its output to the JAX pass's).
Converted ONNX graphs and the builder's model zoo express convolutional
models in NCHW. This pass rewrites the graph once so that 4-D activations
flow channel-last from the first Conv to the last:

  * Conv / MaxPool / AveragePool / GlobalAveragePool / Resize run directly
    on (N, H, W, C) (op attr ``layout:NHWC``). In the port a ``layout:NHWC``
    Conv reads its input as a ``torch.channels_last`` view and its weight
    channels-last, so cuDNN takes NHWC with no layout conversion of its own
    (``ops/standard.py``);
  * the GroupNorm decomposition Reshape(N,G,-1) > InstanceNormalization >
    Reshape (the converter's canonical form) becomes one channel-last
    ``ostpu.groupnorm`` op;
  * transformer boundaries collapse: Reshape(B,C,H*W) + Transpose(0,2,1)
    on an NHWC tensor is a single reshape to (B,H*W,C) (``ostpu.reshape``),
    and the inverse pattern likewise;
  * elementwise ops pass the layout through; NCHW-broadcast weight vectors
    ((C,1,1) / (1,C,1,1)) are re-declared as (C,) through an inserted
    ``ostpu.reshape``;
  * anything the pass does not understand falls back: tagged tensors are
    transposed back to NCHW in front of it, the fused ``ostpu.*`` ops of
    ``runtime/fusion.py`` included (correctness never depends on a pattern
    matching).

Graph inputs and outputs keep their NCHW contract (one transpose at each
end), and so does a tensor named in ``extra_outputs``. The pass is a no-op
for graphs with no eligible Conv (LLMs, encoders) and is off unless
``use_nhwc_layout`` is set, and under ``use_nchw_convs`` (read with getattr:
the port's config has no such field) and the uint8 modes
(``use_uint8_arithmetic``, ``use_uint8_qdq``, ``range_data_calibrate``),
whose calibration data is keyed to the NCHW op stream. It runs after the
attention and GroupNorm fusions (``runtime/session.py _rebuild_graph``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec

UNARY = {
    "Sigmoid", "Relu", "LeakyRelu", "Elu", "Tanh", "Sqrt", "Exp", "Log",
    "Neg", "Abs", "Cos", "Sin", "Gelu", "Erf", "HardSigmoid", "HardSwish",
    "Softplus", "Identity", "Cast", "Clip",
}
BINARY = {"Add", "Sub", "Mul", "Div", "Pow", "Min", "Max"}


def _nhwc(shape: Sequence[int]) -> Tuple[int, ...]:
    return (shape[0], shape[2], shape[3], shape[1])


def _is_static_4d(t: TensorSpec) -> bool:
    return (not t.is_weight) and len(t.shape) == 4 and all(d > 0 for d in t.shape)


class _Pass:
    def __init__(self, graph: Graph, keep: Set[str]):
        self.ops = graph.ops
        self.keep = keep
        self.producer: Dict[str, int] = {}
        self.consumers: Dict[str, List[int]] = {}
        for i, op in enumerate(self.ops):
            for t in op.outputs:
                if t.name:
                    self.producer[t.name] = i
            for t in op.inputs:
                if t.name and not t.is_weight:
                    self.consumers.setdefault(t.name, []).append(i)
        self.new_ops: List[OpNode] = []
        self.skip: Set[int] = set()
        self.tag: Dict[str, TensorSpec] = {}  # orig name -> nhwc-stored spec
        self.nchw_cache: Dict[str, TensorSpec] = {}  # orig name -> nchw spec
        self.nhwc_cache: Dict[str, TensorSpec] = {}  # untagged orig -> nhwc spec
        self.cvec_cache: Dict[str, TensorSpec] = {}  # channel-vector views
        self.changed = False

    # ------------------------------------------------------------- conversions
    def spec_nchw(self, t: TensorSpec) -> TensorSpec:
        """Spec for a consumer that needs the original NCHW tensor."""
        if t.name not in self.tag:
            return t
        if t.name in self.nchw_cache:
            return self.nchw_cache[t.name]
        src = self.tag[t.name]
        # keep names re-materialize under the ORIGINAL name (fetchable)
        out_name = t.name if t.name in self.keep else t.name + "__nchw"
        out = TensorSpec(name=out_name, shape=tuple(t.shape))
        self.new_ops.append(
            OpNode(name=t.name + "_tonchw", op_type="Transpose",
                   inputs=[src], outputs=[out], attrs={"perm": "0,3,1,2"})
        )
        self.nchw_cache[t.name] = out
        return out

    def spec_nhwc(self, t: TensorSpec) -> TensorSpec:
        """NHWC-stored spec for an activation (converting if needed)."""
        if t.name in self.tag:
            return self.tag[t.name]
        if t.name in self.nhwc_cache:
            return self.nhwc_cache[t.name]
        out = TensorSpec(name=t.name + "__nhwc", shape=_nhwc(t.shape))
        self.new_ops.append(
            OpNode(name=t.name + "_tonhwc", op_type="Transpose",
                   inputs=[t], outputs=[out], attrs={"perm": "0,2,3,1"})
        )
        self.nhwc_cache[t.name] = out
        return out

    def tag_output(self, t: TensorSpec) -> TensorSpec:
        out = TensorSpec(name=t.name + "__nhwc", shape=_nhwc(t.shape))
        self.tag[t.name] = out
        self.changed = True
        return out

    def emit(self, op: OpNode) -> None:
        self.new_ops.append(op)

    def keep_back(self, orig: TensorSpec) -> None:
        """Re-materialize a tagged keep-name tensor under its original name."""
        if orig.name in self.keep:
            self.spec_nchw(orig)

    # ------------------------------------------------------------------ rules
    def sole_consumer(self, name: str) -> Optional[int]:
        c = self.consumers.get(name, [])
        return c[0] if len(c) == 1 and name not in self.keep else None

    def channel_vector(self, t: TensorSpec, channels: int) -> Optional[TensorSpec]:
        """(C,1,1)/(1,C,1,1) NCHW-broadcast operand -> a (C,) view via an
        inserted ostpu.reshape (same bytes, channel-last broadcast). Keeps the
        original spec untouched so a weight shared by several consumers (e.g.
        torch's Identity-shared GroupNorm affines) is announced with ONE shape."""
        if t.nelem == 1:
            return t
        if tuple(t.shape) not in ((channels, 1, 1), (1, channels, 1, 1)):
            return None
        key = t.name + "__cvec"
        if key in self.cvec_cache:
            return self.cvec_cache[key]
        out = TensorSpec(name=key, shape=(channels,))
        self.new_ops.append(OpNode(name=key, op_type="ostpu.reshape",
                                   inputs=[t], outputs=[out],
                                   attrs={"shape": str(channels)}))
        self.cvec_cache[key] = out
        return out

    def run(self) -> List[OpNode]:
        for i, op in enumerate(self.ops):
            if i in self.skip:
                continue
            handler = getattr(self, "op_" + op.op_type.replace(".", "_"), None)
            if handler is None or not handler(i, op):
                self.fallback(op)
        return self.new_ops

    def fallback(self, op: OpNode) -> None:
        ins = [self.spec_nchw(t) if (t.name and not t.is_weight) else t for t in op.inputs]
        self.emit(OpNode(op.name, op.op_type, ins, list(op.outputs), dict(op.attrs)))

    # --- convs / pools / resize ------------------------------------------------
    def op_Conv(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        if not _is_static_4d(x) or not _is_static_4d(op.outputs[0]):
            return False
        xs = self.spec_nhwc(x)
        out = self.tag_output(op.outputs[0])
        self.emit(OpNode(op.name, "Conv", [xs] + list(op.inputs[1:]), [out],
                         {**op.attrs, "layout": "NHWC"}))
        self.keep_back(op.outputs[0])
        return True

    def _pool(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        if not _is_static_4d(x) or x.name not in self.tag:
            return False
        out = self.tag_output(op.outputs[0])
        self.emit(OpNode(op.name, op.op_type, [self.tag[x.name]], [out],
                         {**op.attrs, "layout": "NHWC"}))
        self.keep_back(op.outputs[0])
        return True

    op_MaxPool = _pool
    op_AveragePool = _pool

    def op_GlobalAveragePool(self, i: int, op: OpNode) -> bool:
        return self._pool(i, op)

    def op_Resize(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        if not _is_static_4d(x) or x.name not in self.tag:
            return False
        out = self.tag_output(op.outputs[0])
        self.emit(OpNode(op.name, "Resize", [self.tag[x.name]] + list(op.inputs[1:]),
                         [out], {**op.attrs, "layout": "NHWC"}))
        self.keep_back(op.outputs[0])
        return True

    def op_Upsample(self, i: int, op: OpNode) -> bool:
        return self.op_Resize(i, op)

    # --- elementwise ----------------------------------------------------------
    def _unary(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        if x.name not in self.tag:
            return False
        out = self.tag_output(op.outputs[0])
        extra = list(op.inputs[1:])  # Clip min/max scalars pass through
        self.emit(OpNode(op.name, op.op_type, [self.tag[x.name]] + extra, [out], dict(op.attrs)))
        self.keep_back(op.outputs[0])
        return True

    def _binary(self, i: int, op: OpNode) -> bool:
        a, b = op.inputs[0], op.inputs[1]
        ta = (not a.is_weight) and a.name in self.tag
        tb = (not b.is_weight) and b.name in self.tag
        if not (ta or tb):
            return False
        o = op.outputs[0]
        if not _is_static_4d(o):
            return False
        channels = o.shape[1]

        def side(t: TensorSpec, tagged: bool) -> Optional[TensorSpec]:
            if tagged:
                return self.tag[t.name]
            if t.is_weight:
                return self.channel_vector(t, channels)
            if not t.name:
                return None
            cv = self.channel_vector(t, channels)  # Identity-copied affines
            if cv is not None and cv is not t:
                return cv
            if _is_static_4d(t):
                return self.spec_nhwc(t)
            if len(t.shape) == 0 or t.shape == (1,):
                return t
            return None

        sa, sb = side(a, ta), side(b, tb)
        if sa is None or sb is None:
            return False
        out = self.tag_output(o)
        self.emit(OpNode(op.name, op.op_type, [sa, sb], [out], dict(op.attrs)))
        self.keep_back(o)
        return True

    # --- concat / split -------------------------------------------------------
    def op_Concat(self, i: int, op: OpNode) -> bool:
        o = op.outputs[0]
        axis = op.attr_int("axis", 0)
        if axis < 0:
            axis += len(o.shape)
        acts = [t for t in op.inputs if t.name]
        if (
            axis != 1
            or not _is_static_4d(o)
            or any(t.is_weight for t in acts)
            or not all(_is_static_4d(t) for t in acts)
            or not any(t.name in self.tag for t in acts)
        ):
            return False
        ins = [self.spec_nhwc(t) for t in acts]
        out = self.tag_output(o)
        self.emit(OpNode(op.name, "Concat", ins, [out], {**op.attrs, "axis": "3"}))
        self.keep_back(o)
        return True

    def op_Split(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        axis = op.attr_int("axis", 0)
        if axis < 0 and len(x.shape) == 4:
            axis += 4
        if x.name not in self.tag or axis != 1 or not all(_is_static_4d(o) for o in op.outputs):
            return False
        outs = [self.tag_output(o) for o in op.outputs]
        self.emit(OpNode(op.name, "Split", [self.tag[x.name]] + list(op.inputs[1:]),
                         outs, {**op.attrs, "axis": "3"}))
        for o in op.outputs:
            self.keep_back(o)
        return True

    # --- reshape / transpose boundary patterns --------------------------------
    def op_Reshape(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        o = op.outputs[0]
        # pattern: GroupNorm cluster Reshape(N,G,-1) > InstanceNorm > Reshape
        if self._try_groupnorm(i, op):
            return True
        if x.name in self.tag:
            xs = self.tag[x.name]
            b, c, h, w = x.shape
            # to_seq: Reshape(B,C,H*W) whose sole consumer is Transpose(0,2,1)
            if tuple(o.shape) == (b, c, h * w):
                j = self.sole_consumer(o.name)
                if j is not None and j not in self.skip:
                    nxt = self.ops[j]
                    if (
                        nxt.op_type == "Transpose"
                        and nxt.attr_ints("perm") == (0, 2, 1)
                        and nxt.inputs[0].name == o.name
                    ):
                        self.skip.add(j)
                        self.emit(OpNode(op.name, "ostpu.reshape", [xs],
                                         [nxt.outputs[0]],
                                         {"shape": f"{b},{h * w},{c}"}))
                        self.keep_back_plain(o)
                        return True
            # plain reshape from a tagged tensor: fall back (transpose first)
            return False
        # time-embedding style: rank<=2 input reshaped to (B,C,1,1) — the
        # channel-last form (B,1,1,C) is the same bytes, so re-target
        if (
            len(x.shape) <= 2
            and len(o.shape) == 4
            and o.shape[2] == 1
            and o.shape[3] == 1
            and not x.is_weight
        ):
            out = self.tag_output(o)
            self.emit(OpNode(op.name, "ostpu.reshape", [x], [out],
                             {"shape": f"{o.shape[0]},1,1,{o.shape[1]}"}))
            self.keep_back(o)
            return True
        return False

    def keep_back_plain(self, orig: TensorSpec) -> None:
        """A pattern consumed an intermediate; if it is a keep name it must
        still exist — rebuild it from the pattern's replacement output. (Rare:
        only when extra_outputs point inside a fused boundary; the rewrite is
        skipped instead.)"""
        # handled by eligibility: sole_consumer() returns None for keep names
        return None

    def op_Transpose(self, i: int, op: OpNode) -> bool:
        x = op.inputs[0]
        o = op.outputs[0]
        # to_sp: Transpose(0,2,1) on (B,HW,C) whose sole consumer reshapes to
        # (B,C,H,W) — becomes a single reshape to (B,H,W,C), tagged
        if (
            x.name not in self.tag
            and not x.is_weight
            and len(x.shape) == 3
            and op.attr_ints("perm") == (0, 2, 1)
        ):
            j = self.sole_consumer(o.name)
            if j is not None and j not in self.skip:
                nxt = self.ops[j]
                if nxt.op_type == "Reshape" and nxt.inputs[0].name == o.name:
                    t = nxt.outputs[0]
                    if (
                        _is_static_4d(t)
                        and t.shape[0] == x.shape[0]
                        and t.shape[1] == x.shape[2]
                        and t.shape[2] * t.shape[3] == x.shape[1]
                    ):
                        self.skip.add(j)
                        out = self.tag_output(t)
                        self.emit(OpNode(op.name, "ostpu.reshape", [x], [out],
                                         {"shape": f"{t.shape[0]},{t.shape[2]},{t.shape[3]},{t.shape[1]}"}))
                        self.keep_back(t)
                        return True
        return False

    def _try_groupnorm(self, i: int, op: OpNode) -> bool:
        """Reshape(N,G,-1) > InstanceNormalization > Reshape(N,C,H,W) —
        the converter's GroupNorm decomposition (onnx2txt; builder.group_norm)
        — fused to one channel-last ostpu.groupnorm."""
        x = op.inputs[0]
        mid = op.outputs[0]
        if not _is_static_4d(x) or len(mid.shape) != 3:
            return False
        n, c, h, w = x.shape
        g = mid.shape[1]
        if mid.shape[0] != n or g <= 0 or c % g != 0 or mid.shape[2] != (c // g) * h * w:
            return False
        j = self.sole_consumer(mid.name)
        if j is None or j in self.skip:
            return False
        inorm = self.ops[j]
        if inorm.op_type != "InstanceNormalization" or inorm.inputs[0].name != mid.name:
            return False
        k = self.sole_consumer(inorm.outputs[0].name)
        if k is None or k in self.skip:
            return False
        back = self.ops[k]
        if (
            back.op_type != "Reshape"
            or back.inputs[0].name != inorm.outputs[0].name
            or tuple(back.outputs[0].shape) != (n, c, h, w)
        ):
            return False
        xs = self.spec_nhwc(x)
        out = self.tag_output(back.outputs[0])
        eps = inorm.attr("epsilon", "1e-05")
        self.skip.update((j, k))
        self.emit(OpNode(inorm.name, "ostpu.groupnorm",
                         [xs, inorm.inputs[1], inorm.inputs[2]], [out],
                         {"groups": str(g), "epsilon": eps, "layout": "NHWC"}))
        self.keep_back(back.outputs[0])
        return True


# bind elementwise handlers
for _t in UNARY:
    setattr(_Pass, "op_" + _t, _Pass._unary)
for _t in BINARY:
    setattr(_Pass, "op_" + _t, _Pass._binary)


def rewrite_nhwc(graph: Graph, config, keep_names: Sequence[str] = ()) -> Graph:
    """Apply the channel-last layout pass. Returns a new Graph (or the input
    graph unchanged when disabled/no-op)."""
    if config is not None and (
        getattr(config, "use_nchw_convs", False)
        or not getattr(config, "use_nhwc_layout", True)
        or getattr(config, "use_uint8_arithmetic", False)
        or getattr(config, "use_uint8_qdq", False)
        or getattr(config, "range_data_calibrate", False)
    ):
        return graph
    if not any(op.op_type == "Conv" and _is_static_4d(op.inputs[0]) for op in graph.ops):
        return graph
    p = _Pass(graph, set(keep_names) | set(graph.output_names()))
    new_ops = p.run()
    if not p.changed:
        return graph
    return Graph(ops=new_ops)

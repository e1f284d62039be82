"""Graph-level pattern recognizers: attention and GroupNorm fusion.

Counterpart of ``onnxstream_tpu/runtime/fusion.py``. ``fuse_attention``, with
the packed-heads extension (``fuse_attention_heads``), rewrites the
reference's fused-attention patterns into the internal ``ostpu.sdpa`` op
(see onnxstream_tpu_torch/ops/attention.py):

  * AttentionFusedOps — MatMul [+ Mul(scale)] + Softmax(last axis) + MatMul
    (reference recognizer src/onnxstream.cpp:3576-3633), enabled by
    ``fuse_ops_in_attention``;
  * ScaledDotProductAttention — Transpose + MatMul + Div + Add + Softmax +
    MatMul and Transpose + Mul + Mul + MatMul + Add + Softmax + MatMul
    (src/onnxstream.cpp:3643-3755), enabled by ``use_scaled_dp_attn_op``.

``fuse_gn_conv`` and ``fuse_groupnorm`` collapse the converter's GroupNorm
decomposition (Reshape -> InstanceNormalization -> Reshape -> Mul -> Add
[-> Sigmoid + Mul]) into ``ostpu.gn_silu_conv`` (with the 3x3 convolution
that consumes it) and ``ostpu.gn_silu`` (ops/standard.py; the CUDA kernels of
kernels/gn_conv.py and kernels/gn_silu.py). Both are off by default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec
from onnxstream_tpu_torch.kernels.gn_conv import gn_conv_problem
from onnxstream_tpu_torch.runtime.config import SessionConfig


class _Rewriter:
    def __init__(self, graph: Graph, config: SessionConfig, weight_loader=None):
        self.graph = graph
        self.config = config
        self.load = weight_loader
        # tensors the runtime must still materialize (config.extra_outputs):
        # an interior tensor in this set must not be fused away, exactly as
        # in fuse_groupnorm/fuse_gn_conv's keep handling
        self.keep = set(getattr(config, "extra_outputs", ()) or ())
        self.producer: Dict[str, int] = {}
        self.consumers: Dict[str, List[int]] = {}
        for i, op in enumerate(graph.ops):
            for t in op.outputs:
                if t.name:
                    self.producer[t.name] = i
            for t in op.inputs:
                if t.name and not t.is_weight:
                    self.consumers.setdefault(t.name, []).append(i)

    def _only_consumer(self, name: str) -> Optional[int]:
        if name in self.keep:
            return None
        c = self.consumers.get(name, [])
        return c[0] if len(c) == 1 else None

    def _scalar(self, spec: TensorSpec) -> Optional[float]:
        if spec.is_weight and spec.nelem == 1 and self.load is not None:
            try:
                arr = self.load(spec.name, spec.dtype, spec.shape)
            except (KeyError, OSError, ValueError):  # weight not loadable: no fusion
                return None
            value = float(torch.as_tensor(arr).reshape(-1)[0].float())
            if spec.dtype.value == "uint8":
                value = (value - spec.zero_point) * spec.scale
            return value
        return None

    def try_fuse_at(self, si: int) -> Optional[Tuple[List[int], OpNode]]:
        ops = self.graph.ops
        softmax = ops[si]
        if softmax.op_type != "Softmax":
            return None
        axis = softmax.attr_int("axis", -1)
        rank = len(softmax.inputs[0].shape) or len(softmax.outputs[0].shape)
        if axis not in (-1, rank - 1):
            return None

        removed = [si]
        # forward: single consuming MatMul(probs, V)
        ci = self._only_consumer(softmax.outputs[0].name)
        if ci is None:
            return None
        consumer = ops[ci]
        if consumer.op_type != "MatMul" or consumer.inputs[0].name != softmax.outputs[0].name:
            return None
        v_spec = consumer.inputs[1]
        removed.append(ci)

        # backward: peel mask add and scalar scalings down to the QK MatMul
        scale = 1.0
        mask_spec: Optional[TensorSpec] = None
        cur = softmax.inputs[0]

        def prod(spec):
            i = self.producer.get(spec.name)
            return ops[i] if i is not None else None

        node = prod(cur)
        for _ in range(4):
            if node is None:
                return None
            # `cur`'s producer is about to be deleted: `cur` must feed ONLY
            # this chain and must not be a demanded extra output
            if self._only_consumer(cur.name) is None:
                return None
            if node.op_type == "Add" and mask_spec is None:
                a, b = node.inputs
                # the logits side is the one produced by a MatMul/Div/Mul chain
                side = None
                for cand, other in ((a, b), (b, a)):
                    p = prod(cand)
                    if p is not None and p.op_type in ("MatMul", "Div", "Mul"):
                        side, mask_spec = cand, other
                        break
                if side is None:
                    return None
                if self._only_consumer(side.name) is None:
                    return None
                removed.append(self.producer[node.outputs[0].name])
                cur = side
                node = prod(cur)
                continue
            if node.op_type == "Div":
                s = self._scalar(node.inputs[1])
                if s is None or s == 0.0:
                    return None
                scale /= s
                if self._only_consumer(node.inputs[0].name) is None:
                    return None
                removed.append(self.producer[node.outputs[0].name])
                cur = node.inputs[0]
                node = prod(cur)
                continue
            if node.op_type == "Mul":
                s = self._scalar(node.inputs[1])
                other = node.inputs[0]
                if s is None:
                    s = self._scalar(node.inputs[0])
                    other = node.inputs[1]
                if s is None:
                    return None
                scale *= s
                if self._only_consumer(other.name) is None:
                    return None
                removed.append(self.producer[node.outputs[0].name])
                cur = other
                node = prod(cur)
                continue
            break
        if node is None or node.op_type != "MatMul":
            return None
        qk = node
        qk_idx = self.producer[qk.outputs[0].name]
        if self._only_consumer(qk.outputs[0].name) is None:
            return None
        removed.append(qk_idx)

        q_spec, kt_spec = qk.inputs
        k_transposed = 1
        k_spec = kt_spec

        # peel per-side scalar Muls (SDPA pattern 2: Q*s1, K*s2) and the K transpose
        def peel_side(spec):
            nonlocal scale
            p = prod(spec)
            while p is not None and p.op_type == "Mul":
                s = self._scalar(p.inputs[1])
                other = p.inputs[0]
                if s is None:
                    s = self._scalar(p.inputs[0])
                    other = p.inputs[1]
                if s is None:
                    break
                # the Mul's output must feed only this attention chain
                if (len(self.consumers.get(p.outputs[0].name, [])) != 1
                        or p.outputs[0].name in self.keep):
                    break
                scale *= s
                removed.append(self.producer[p.outputs[0].name])
                spec = other
                p = prod(spec)
            return spec, p

        q_spec, _ = peel_side(q_spec)
        kt_spec, k_prod = peel_side(kt_spec)
        k_spec = kt_spec
        if k_prod is not None and k_prod.op_type == "Transpose":
            perm = k_prod.attr_ints("perm")
            r = len(k_prod.inputs[0].shape)
            swap_last_two = perm is not None and r >= 2 and list(perm) == list(range(r - 2)) + [r - 1, r - 2]
            if (swap_last_two and kt_spec.name not in self.keep
                    and len(self.consumers.get(kt_spec.name, [])) == 1):
                removed.append(self.producer[kt_spec.name])
                k_spec = k_prod.inputs[0]
                k_transposed = 0

        if scale == 1.0:
            # AttentionFusedOps without explicit scale uses plain product;
            # encode scale=1 explicitly so sdpa doesn't apply 1/sqrt(d).
            scale_attr = "1.0"
        else:
            scale_attr = f"{scale:.17g}"

        # --- packed-heads extension (no reference analog) ------------------
        # Absorb the per-side head-split Reshape+Transpose and the output-side
        # Transpose+Reshape merge: the flash kernel reads each head straight
        # from the packed (B, L, H*D) projections through strides
        # (fuse_attention_heads in runtime/config.py).
        outputs = list(consumer.outputs)
        heads = 0
        # mask-free only: the packed flash kernel takes no mask, and demoting
        # masked attention (LLM prefill) to the einsum path would cost more
        # than the projection-dot fix saves
        if mask_spec is None and getattr(self.config, "fuse_attention_heads", False):
            packed = self._peel_packed_heads(q_spec, k_spec, v_spec, k_transposed, consumer)
            if packed is not None:
                q_spec, k_spec, v_spec, outputs, heads, extra = packed
                k_transposed = 0
                removed.extend(extra)

        inputs = [q_spec, k_spec, v_spec]
        if mask_spec is not None:
            inputs.append(mask_spec)
        attrs = {"scale": scale_attr, "k_transposed": str(k_transposed), "causal": "0"}
        if heads:
            attrs["heads"] = str(heads)
        fused = OpNode(
            name=consumer.name + "_sdpa",
            op_type="ostpu.sdpa",
            inputs=inputs,
            outputs=outputs,
            attrs=attrs,
        )
        return sorted(set(removed)), fused

    def _peel_packed_heads(self, q_spec, k_spec, v_spec, k_transposed, consumer):
        """Try to absorb head split/merge around a recognized attention.

        Requires, on each of Q/K/V: producer Transpose(0,2,1,3) of a Reshape
        (B,L,H*D)->(B,L,H,D) (K may instead be Transpose(0,2,3,1) when it
        arrives pre-transposed), and on the output: a sole-consumer
        Transpose(0,2,1,3) + Reshape back to (B,M,H*Dv). Every interior
        tensor must have exactly one consumer. Returns (q, k, v, outputs,
        heads, removed_indices) with packed (B, L, H*D) specs, or None."""
        ops = self.graph.ops

        def prod_idx(spec):
            return self.producer.get(spec.name)

        def peel_split(spec, want_perm):
            ti = prod_idx(spec)
            if ti is None:
                return None
            t = ops[ti]
            if (t.op_type != "Transpose"
                    or len(self.consumers.get(spec.name, [])) != 1
                    or spec.name in self.keep):
                return None
            perm = t.attr_ints("perm")
            if perm is None or list(perm) != want_perm:
                return None
            rspec = t.inputs[0]
            if (len(rspec.shape) != 4
                    or len(self.consumers.get(rspec.name, [])) != 1
                    or rspec.name in self.keep):
                return None
            ri = prod_idx(rspec)
            if ri is None or ops[ri].op_type != "Reshape":
                return None
            src = ops[ri].inputs[0]
            b, l, h, dh = rspec.shape
            if tuple(src.shape) != (b, l, h * dh):
                return None
            return src, h, dh, [ti, ri]

        q = peel_split(q_spec, [0, 2, 1, 3])
        k = peel_split(k_spec, [0, 2, 3, 1] if k_transposed else [0, 2, 1, 3])
        v = peel_split(v_spec, [0, 2, 1, 3])
        if q is None or k is None or v is None:
            return None
        if q[2] != k[2] or k[1] != v[1] or q[1] % k[1]:  # equal head dims, kv head counts; GQA divisibility
            return None

        # output merge: sdpa out (B,H,M,Dv) -> Transpose(0,2,1,3) -> Reshape
        out_spec = consumer.outputs[0]
        ti = self._only_consumer(out_spec.name)
        if ti is None:
            return None
        t = ops[ti]
        perm = t.attr_ints("perm") if t.op_type == "Transpose" else None
        if perm is None or list(perm) != [0, 2, 1, 3]:
            return None
        ri = self._only_consumer(t.outputs[0].name)
        if ri is None:
            return None
        r = ops[ri]
        if r.op_type != "Reshape":
            return None
        b, hh, m, dv = t.inputs[0].shape
        if tuple(r.outputs[0].shape) != (b, m, hh * dv):
            return None

        removed = q[3] + k[3] + v[3] + [ti, ri]
        return q[0], k[0], v[0], list(r.outputs), q[1], removed


def _match_gn_chain(ops, rw, keep, i, op):
    """Match the converter's GroupNorm decomposition rooted at
    InstanceNormalization op ``i`` (see fuse_groupnorm's docstring for the op
    pattern). Returns None or a dict with the chain's pieces; shared by
    fuse_groupnorm and fuse_gn_conv."""

    def only_consumer(name):
        if name in keep:
            return None
        c = rw.consumers.get(name, [])
        return c[0] if len(c) == 1 else None

    if op.op_type != "InstanceNormalization" or len(op.inputs) != 3:
        return None
    r_spec, sg_spec, sb_spec = op.inputs
    if not (sg_spec.is_weight and sb_spec.is_weight):
        return None
    if len(r_spec.shape) != 3:
        return None
    groups = r_spec.shape[1]
    if sg_spec.nelem != groups or sb_spec.nelem != groups:
        return None
    # pre-reshape from 4D NCHW
    ri = rw.producer.get(r_spec.name)
    if ri is None or ops[ri].op_type != "Reshape":
        return None
    if only_consumer(r_spec.name) != i:
        return None
    x_spec = ops[ri].inputs[0]
    if len(x_spec.shape) != 4 or x_spec.shape[0] != r_spec.shape[0]:
        return None
    c = x_spec.shape[1]
    if c % groups:
        return None
    # post-reshape back to x.shape
    pi = only_consumer(op.outputs[0].name)
    if pi is None or ops[pi].op_type != "Reshape":
        return None
    if tuple(ops[pi].outputs[0].shape) != tuple(x_spec.shape):
        return None
    # per-channel affine: Mul(gamma) -> Add(beta)
    mi = only_consumer(ops[pi].outputs[0].name)
    if mi is None or ops[mi].op_type != "Mul":
        return None
    g_spec = next((t for t in ops[mi].inputs if t.is_weight), None)
    if g_spec is None or g_spec.nelem != c:
        return None
    ai = only_consumer(ops[mi].outputs[0].name)
    if ai is None or ops[ai].op_type != "Add":
        return None
    b_spec = next((t for t in ops[ai].inputs if t.is_weight), None)
    if b_spec is None or b_spec.nelem != c:
        return None
    removed = [ri, i, pi, mi, ai]
    out_op = ops[ai]
    silu = 0
    # optional SiLU: Add output feeds exactly Sigmoid + Mul(of both)
    head = out_op.outputs[0].name
    cons = rw.consumers.get(head, [])
    if head not in keep and len(cons) == 2:
        sig = next((j for j in cons if ops[j].op_type == "Sigmoid"), None)
        mul = next((j for j in cons if ops[j].op_type == "Mul"), None)
        if sig is not None and mul is not None:
            sig_out = ops[sig].outputs[0].name
            mul_ins = {t.name for t in ops[mul].inputs}
            if only_consumer(sig_out) == mul and mul_ins == {head, sig_out}:
                removed.extend([sig, mul])
                out_op = ops[mul]
                silu = 1
    return {
        "removed": removed,
        "x": x_spec,
        "sg": sg_spec,
        "sb": sb_spec,
        "gamma": g_spec,
        "beta": b_spec,
        "out_op": out_op,
        "silu": silu,
        "groups": groups,
        "eps": op.attr_float("epsilon", 1e-5),
        "in_name": op.name,
    }


def _replace_fused(graph: Graph, plans) -> Graph:
    """Apply (removed_indices, fused_op) rewrite plans to a graph: the fused
    op takes the place of the chain's last op."""
    if not plans:
        return graph
    replace_at = {max(removed): fused for removed, fused in plans}
    drop = set()
    for removed, _ in plans:
        drop.update(removed)
    new_ops: List[OpNode] = []
    for i, op in enumerate(graph.ops):
        if i in replace_at:
            new_ops.append(replace_at[i])
        elif i not in drop:
            new_ops.append(op)
    return Graph(ops=new_ops)


def fuse_gn_conv(graph: Graph, config: SessionConfig, weight_loader=None) -> Graph:
    """Absorb GroupNorm -> affine -> SiLU -> Conv3x3(s1 p1 g1) chains into one
    ``ostpu.gn_silu_conv`` op (kernels/gn_conv.py).

    Runs before fuse_groupnorm, which takes the chains left over. The conv
    weight's TensorSpec is rewritten to the kernel's (9, O, C) tap-major
    upload form through WeightArg.transform 't9oc' (runtime/planner.py): a
    host-side relayout at upload, not a per-run transpose. A chain fuses only
    where the kernel takes its shape (``gn_conv_problem``)."""
    if not getattr(config, "fuse_gn_conv", False):
        return graph
    keep = set(getattr(config, "extra_outputs", ()) or ())
    rw = _Rewriter(graph, config, weight_loader)
    ops = graph.ops

    # weight-name use counts across all ops: a tied conv weight cannot be
    # relayouted for one consumer (WeightArgs are keyed by name)
    wuse: Dict[str, int] = {}
    for o in ops:
        for t in o.inputs:
            if t.is_weight:
                wuse[t.name] = wuse.get(t.name, 0) + 1

    plans = []
    claimed = set()
    for i, op in enumerate(ops):
        m = _match_gn_chain(ops, rw, keep, i, op)
        if m is None or not m["silu"]:
            continue
        head = m["out_op"].outputs[0].name
        if head in keep:
            continue
        cons = rw.consumers.get(head, [])
        if len(cons) != 1:
            continue
        ci = cons[0]
        conv = ops[ci]
        if conv.op_type != "Conv":
            continue
        x_spec = m["x"]
        n, c, h, w = x_spec.shape
        if conv.attr_int("group", 1) != 1:
            continue
        if list(conv.attr_ints("strides", [1, 1])) != [1, 1]:
            continue
        if list(conv.attr_ints("dilations", [1, 1])) != [1, 1]:
            continue
        if list(conv.attr_ints("pads", [0, 0, 0, 0])) != [1, 1, 1, 1]:
            continue
        if len(conv.inputs) < 2:
            continue
        w_spec = conv.inputs[1]
        if not w_spec.is_weight or not w_spec.dtype.is_float or w_spec.transform:
            continue
        if tuple(w_spec.shape[1:]) != (c, 3, 3):
            continue
        if wuse.get(w_spec.name, 0) != 1:
            continue
        if w_spec.name in getattr(config, "force_uint8_storage_set", ()):
            continue
        o_ch = w_spec.shape[0]
        b_spec = conv.inputs[2] if len(conv.inputs) > 2 else None
        if b_spec is not None and (not b_spec.is_weight or b_spec.nelem != o_ch):
            continue
        if gn_conv_problem(c, o_ch, h, w, config.torch_compute_dtype, m["groups"], n) is not None:
            continue
        removed = m["removed"] + [ci]
        if claimed & set(removed):
            continue
        claimed.update(removed)
        w_new = dataclasses.replace(
            w_spec, shape=(9, o_ch, c), transform="t9oc", file_shape=w_spec.shape
        )
        inputs = [x_spec, m["sg"], m["sb"], m["gamma"], m["beta"], w_new]
        if b_spec is not None:
            inputs.append(b_spec)
        fused = OpNode(
            name=m["in_name"] + "_gn_silu_conv",
            op_type="ostpu.gn_silu_conv",
            inputs=inputs,
            outputs=list(conv.outputs),
            attrs={
                "groups": str(m["groups"]),
                "epsilon": f"{m['eps']:.17g}",
            },
        )
        plans.append((removed, fused))
    return _replace_fused(graph, plans)


def fuse_groupnorm(graph: Graph, config: SessionConfig, weight_loader=None) -> Graph:
    """Collapse the converter's GroupNorm decomposition (+ optional SiLU)
    into one ``ostpu.gn_silu`` op.

    Pattern (the converter's group_norm: the shape ONNX exporters emit
    and the reference executes op by op via InstanceNormalization,
    src/onnxstream.cpp:4788):

        Reshape(N,C,H,W -> N,G,-1)
          -> InstanceNormalization(sg(G), sb(G), eps)
          -> Reshape(back) -> Mul(gamma, C elems) -> Add(beta, C elems)
          [-> Sigmoid + Mul  (SiLU)]

    All interior tensors must have exactly one consumer (two for the SiLU
    head tensor feeding both Sigmoid and the product Mul) and must not be
    requested as extra outputs. The fused op runs the CUDA kernel of
    kernels/gn_silu.py on the card."""
    if not getattr(config, "fuse_groupnorm", False):
        return graph
    keep = set(getattr(config, "extra_outputs", ()) or ())
    rw = _Rewriter(graph, config, weight_loader)
    ops = graph.ops

    plans = []
    claimed = set()
    for i, op in enumerate(ops):
        m = _match_gn_chain(ops, rw, keep, i, op)
        if m is None:
            continue
        removed = m["removed"]
        if claimed & set(removed):
            continue
        claimed.update(removed)
        fused = OpNode(
            name=m["in_name"] + "_gn_silu",
            op_type="ostpu.gn_silu",
            inputs=[m["x"], m["sg"], m["sb"], m["gamma"], m["beta"]],
            outputs=list(m["out_op"].outputs),
            attrs={
                "groups": str(m["groups"]),
                "epsilon": f"{m['eps']:.17g}",
                "silu": str(m["silu"]),
            },
        )
        plans.append((removed, fused))
    return _replace_fused(graph, plans)


def fuse_attention(graph: Graph, config: SessionConfig, weight_loader=None) -> Graph:
    """Apply the SDPA recognizers. Returns a new Graph (or the original if no
    pattern matched)."""
    if not (config.fuse_ops_in_attention or config.use_scaled_dp_attn_op):
        return graph
    rewriter = _Rewriter(graph, config, weight_loader)
    plans = []
    claimed = set()
    for i, op in enumerate(graph.ops):
        if op.op_type != "Softmax":
            continue
        result = rewriter.try_fuse_at(i)
        if result is None:
            continue
        removed, fused = result
        if claimed & set(removed):
            continue
        claimed.update(removed)
        plans.append((removed, fused))
    return _replace_fused(graph, plans)

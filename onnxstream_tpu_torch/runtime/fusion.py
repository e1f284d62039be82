"""Attention fusion: graph-level pattern recognizers.

Counterpart of ``fuse_attention`` in ``onnxstream_tpu/runtime/fusion.py``,
with the packed-heads extension (``fuse_attention_heads``). It rewrites the
reference's fused-attention patterns into the internal ``ostpu.sdpa`` op
(see onnxstream_tpu_torch/ops/attention.py):

  * AttentionFusedOps — MatMul [+ Mul(scale)] + Softmax(last axis) + MatMul
    (reference recognizer src/onnxstream.cpp:3576-3633), enabled by
    ``fuse_ops_in_attention``;
  * ScaledDotProductAttention — Transpose + MatMul + Div + Add + Softmax +
    MatMul and Transpose + Mul + Mul + MatMul + Add + Softmax + MatMul
    (src/onnxstream.cpp:3643-3755), enabled by ``use_scaled_dp_attn_op``.

The GroupNorm fusions of the JAX package (``fuse_groupnorm``,
``fuse_gn_conv``) are not ported yet; SessionConfig refuses them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec
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
    if not plans:
        return graph

    replace_at = {removed[-1]: fused for removed, fused in plans}
    drop = set()
    for removed, _ in plans:
        drop.update(removed)
    new_ops: List[OpNode] = []
    for i, op in enumerate(graph.ops):
        if i in replace_at:
            new_ops.append(replace_at[i])
        elif i in drop:
            continue
        else:
            new_ops.append(op)
    return Graph(ops=new_ops)

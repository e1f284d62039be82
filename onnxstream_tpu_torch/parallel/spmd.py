"""Plan-time sharding pass: the port's stand-in for XLA's SPMD partitioner.

Under ``SessionConfig.mesh`` every rank runs the graph on its own shards.
``shard_plan`` takes the plan of the whole graph (global shapes, the host
folds, the streamed weights) and gives every device tensor a placement: per
mesh dim one sharded axis or none, kept as a dict ``{axis: dim name}``. It
starts from the inputs (``activation_sharding``, ``kv_head_sharding`` for
``tp_kv_head_inputs``) and walks the ops in order:

  * MatMul / Gemm: x replicated on K, the weight ``Shard(1)`` where
    ``shard_weight_spec`` says so -> the result sharded on its last axis;
    two activations keep their batch, M and N axes;
  * Conv (NCHW, group 1): x replicated on C, the kernel ``Shard(0)`` -> the
    result sharded on axis 1, the bias sliced to match;
  * elementwise ops, Cast and the unary ops: operands sharded on the same
    axes, the others broadcasting there or sliced locally (a replicated
    full-size operand costs no traffic);
  * Reshape / Flatten: a sharded axis goes to the output axis that starts at
    the same flat offset (a split or a merge with the sharded axis leading),
    if that axis divides; Transpose, Unsqueeze, Squeeze, Expand, Identity,
    Split, Concat and Slice off their axis, Gather off its axis, the
    reductions, Softmax, LayerNormalization, InstanceNormalization, Resize
    and pooling keep the axes they do not work along;
  * ``ostpu.sdpa``: q sharded on its heads, k / v on their kv heads, both
    dividing (GQA's groups then stay rank-local), or q on its query rows
    unless the op is causal;
    the packed form's ``heads`` attribute becomes the local count;
  * ScatterND into a cache sharded on axis 0 (the KV cache's heads): the
    indices' first column must be a host constant whose rows for each
    rank's updates land in that rank's block; the indices are sliced to the
    local rows and the block's offset taken off;
  * every other op: an ``ostpu.all_gather`` of each sharded operand first,
    then it runs replicated. So an op never computes on a shard it cannot
    take.

Weights follow the activations: a weight is placed at its first use, as
``shard_weight_spec`` says where it is the weight operand of a MatMul / Gemm /
Conv, else to fit the operands beside it (sliced where they are sharded,
replicated elsewhere). Only activations are gathered at run time; a
weight's placement is a slice taken at upload. Static values (host folds,
int64 shape vectors) that an op reads on a sharded axis become local
constants: Reshape and Expand targets, Resize sizes, ScatterND offsets.

The graph's outputs are gathered, except an output placed as
``kv_head_sharding`` places the cache when the config names KV-head inputs:
it stays this rank's shard (the LLM pipeline feeds it back). The rewritten
graph is planned again with local shapes, so the planner's shape checks hold
every op's result to the declared global shape divided on its sharded axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec

PMap = Dict[int, str]  # sharded axis -> mesh dim name

ELEMENTWISE = frozenset({
    "Add", "Sub", "Mul", "Div", "Pow", "Less", "Greater", "Equal", "And", "Or", "Min", "Max", "Where",
    "Neg", "Identity", "Sqrt", "Cos", "Sin", "Sigmoid", "Erf", "Exp", "Log", "Abs", "Tanh", "Relu", "Not",
    "Floor", "Ceil", "LeakyRelu", "Gelu", "HardSigmoid", "Clip", "Cast"})
REDUCTIONS = frozenset({"ReduceMean", "ReduceSum", "ReduceMax"})
POOLS = frozenset({"MaxPool", "AveragePool", "GlobalAveragePool"})


def _placement_map(mesh, placements) -> PMap:
    """DTensor placements (one per mesh dim) -> {axis: dim name}."""
    from torch.distributed.tensor import Shard

    return {p.dim: name for name, p in zip(mesh.mesh_dim_names, placements) if isinstance(p, Shard)}


@dataclasses.dataclass
class _Val:
    """An op operand as the pass sees it: ``kind`` is "act" (a device
    tensor), "static" (a host value), "weight" (a streamed weight) or
    "none"; ``shape`` is global."""

    spec: TensorSpec
    kind: str
    shape: Tuple[int, ...] = ()
    value: Optional[np.ndarray] = None


class ShardingPass:
    def __init__(self, plan, mesh):
        self.plan = plan
        self.graph = plan.graph
        self.config = plan.config
        self.mesh = mesh
        self.sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        coord = mesh.get_coordinate()
        self.coord = dict(zip(mesh.mesh_dim_names, coord))
        self.args = {w.name: w for w in plan.arg_weights}
        self.pm: Dict[str, PMap] = {}  # activation -> placement
        self.wp: Dict[str, PMap] = {}  # weight -> placement, fixed at first use
        self.consts: Dict[str, np.ndarray] = {}  # local constants the pass made
        self.ops: List[OpNode] = []
        self.made: set = set()  # names of the ops the pass put in
        self._cache: Dict[tuple, TensorSpec] = {}  # (name, placement) -> the tensor holding it
        self._n = 0
        self.producer = {t.name: op for op in self.graph.ops for t in op.outputs if t.name}

    # ------------------------------------------------------------ shapes
    def local_shape(self, shape, pmap: PMap) -> Tuple[int, ...]:
        s = list(shape)
        for a, d in pmap.items():
            s[a] //= self.sizes[d]
        return tuple(s)

    def block(self, size: int, dim: str) -> Tuple[int, int]:
        """This rank's [start, stop) of an axis of ``size`` split over dim."""
        n = size // self.sizes[dim]
        r = self.coord[dim]
        return r * n, (r + 1) * n

    def shard_slices(self, shape, pmap: PMap) -> Tuple[Tuple[int, int, int], ...]:
        return tuple((a, *self.block(shape[a], d)) for a, d in sorted(pmap.items()))

    def _divides(self, shape, axis: int, dim: str) -> bool:
        """Whether axis splits over dim (a dim of one rank splits nothing)."""
        return self.sizes[dim] > 1 and shape[axis] > 1 and shape[axis] % self.sizes[dim] == 0

    def _fresh(self, base: str, tag: str) -> str:
        self._n += 1
        return f"{base}@{tag}{self._n}"

    # ------------------------------------------------------------ operands
    def val(self, spec: TensorSpec) -> _Val:
        if not spec.name:
            return _Val(spec, "none")
        if spec.is_weight:
            sw = self.plan.static_weights.get(spec.name)
            if sw is not None:
                return _Val(spec, "static", tuple(np.shape(sw)), sw)
            w = self.args[spec.name]
            # a K-major int8 weight (tnk) is placed by its file layout, the
            # MatMul's operand; it is relayouted after it is sliced
            return _Val(spec, "weight", tuple(w.file_shape if w.transform == "tnk" else w.shape))
        if spec.name in self.plan.static_env:
            v = self.plan.static_env[spec.name]
            return _Val(spec, "static", tuple(np.shape(v)), v)
        a = self.plan.avals.get(spec.name) or self.plan.input_avals[spec.name]
        return _Val(spec, "act", tuple(a.shape))

    def placed(self, v: _Val) -> Optional[PMap]:
        """The operand's placement, None for a free weight or a static."""
        if v.kind == "act":
            return self.pm[v.spec.name]
        if v.kind == "weight":
            return self.wp.get(v.spec.name)
        return None

    def _act_spec(self, name: str, shape, pmap: PMap) -> TensorSpec:
        return TensorSpec(name=name, shape=self.local_shape(shape, pmap))

    def _emit(self, op_type: str, name: str, inputs: List[TensorSpec], out_name: str, out_shape,
              attrs: Dict[str, str]) -> TensorSpec:
        out = TensorSpec(name=out_name, shape=tuple(out_shape))
        self.made.add(name)
        self.ops.append(OpNode(name=name, op_type=op_type, inputs=inputs, outputs=[out], attrs=attrs))
        return out

    def const(self, base: str, value: np.ndarray) -> TensorSpec:
        """A local constant: a weight name of its own whose value the
        rank's plan holds as a static."""
        name = self._fresh(base, "local")
        self.consts[name] = value
        return TensorSpec(name=name, shape=tuple(value.shape), dtype=DType.from_np(value.dtype))

    def weight_spec(self, v: _Val, pmap: PMap) -> TensorSpec:
        """A weight operand placed as pmap (its first use fixes it)."""
        s = v.spec
        shard = self.shard_slices(v.shape, pmap) if pmap else None
        return dataclasses.replace(s, shape=self.local_shape(v.shape, pmap), shard=shard,
                                   file_shape=s.file_shape or (tuple(v.shape) if pmap else None))

    def as_placed(self, v: _Val, want: PMap) -> TensorSpec:
        """The operand placed as ``want``: a free weight takes it at upload,
        a static is sliced into a local constant, an activation is gathered
        on the axes it holds sharded otherwise and sliced locally on the
        axes it holds whole."""
        if v.kind == "none":
            return v.spec
        if v.kind == "static":
            if not want:
                return v.spec
            key = (v.spec.name, tuple(sorted(want.items())))
            if key not in self._cache:
                arr = np.asarray(v.value)
                for a, start, stop in self.shard_slices(v.shape, want):
                    arr = np.take(arr, np.arange(start, stop), axis=a)
                self._cache[key] = self.const(v.spec.name, np.ascontiguousarray(arr))
            return self._cache[key]
        if v.kind == "weight" and v.spec.name not in self.wp:
            self.wp[v.spec.name] = dict(want)
            return self.weight_spec(v, want)
        have = self.placed(v)
        if have == want:
            return self.weight_spec(v, want) if v.kind == "weight" else self._act_spec(v.spec.name, v.shape, want)
        key = (v.spec.name, tuple(sorted(want.items())))
        if key in self._cache:
            return self._cache[key]
        cur = self.weight_spec(v, have) if v.kind == "weight" else self._act_spec(v.spec.name, v.shape, have)
        pm = dict(have)
        for a, d in sorted(have.items()):
            if want.get(a) != d:
                del pm[a]
                cur = self._emit("ostpu.all_gather", self._fresh(v.spec.name, "gather_op"), [cur],
                                 self._fresh(v.spec.name, "gathered"), self.local_shape(v.shape, pm),
                                 {"axis": str(a), "dim": d, "parts": str(self.sizes[d])})
        for a, d in sorted(want.items()):
            if pm.get(a) != d:
                pm[a] = d
                start, stop = self.block(v.shape[a], d)
                cur = self._emit("ostpu.shard_slice", self._fresh(v.spec.name, "slice_op"), [cur],
                                 self._fresh(v.spec.name, "sliced"), self.local_shape(v.shape, pm),
                                 {"axis": str(a), "start": str(start), "stop": str(stop)})
        self._cache[key] = cur
        return cur

    # ------------------------------------------------------------ rules
    def unify(self, vals: List[_Val], amaps: List[Dict[int, Optional[int]]], out_shape,
              fixed: Optional[PMap] = None, whole: Optional[List[set]] = None) -> Tuple[List[TensorSpec], PMap]:
        """The common rule: amaps[i] maps operand i's axes to output axes
        (None: an axis the op works along, which must be whole). The output
        placement is the union of the placed operands' (the first one wins a
        conflict; a mesh dim shards one axis); each operand is then placed to
        match on the axes it holds at full size (``whole[i]``: axes of
        another size that may still be sharded, e.g. GQA's kv heads)."""
        target: PMap = dict(fixed or {})
        for v, amap in zip(vals, amaps):
            have = self.placed(v) or {}
            for a, d in sorted(have.items()):
                oa = amap.get(a)
                if oa is None or oa in target or d in target.values():
                    continue
                if self._divides(out_shape, oa, d):
                    target[oa] = d
        specs = []
        for i, (v, amap) in enumerate(zip(vals, amaps)):
            want = {}
            for a, oa in amap.items():
                if oa is None or oa not in target or a >= len(v.shape):
                    continue
                extra = whole[i] if whole else ()
                if v.shape[a] == out_shape[oa] or a in extra:
                    want[a] = target[oa]
            specs.append(self.as_placed(v, want))
        return specs, target

    def finish(self, op: OpNode, inputs: List[TensorSpec], pmaps: List[PMap],
               attrs: Optional[Dict[str, str]] = None) -> None:
        outs = []
        for spec, pmap in zip(op.outputs, pmaps):
            if not spec.name:
                outs.append(spec)
                continue
            shape = self.plan.avals[spec.name].shape
            self.pm[spec.name] = pmap
            outs.append(dataclasses.replace(spec, shape=self.local_shape(shape, pmap)))
        self.ops.append(OpNode(name=op.name, op_type=op.op_type, inputs=inputs, outputs=outs,
                               attrs=dict(op.attrs) if attrs is None else attrs))

    def replicated(self, op: OpNode, vals: List[_Val]) -> None:
        self.finish(op, [self.as_placed(v, {}) for v in vals], [{} for _ in op.outputs])

    def out_shape(self, op: OpNode, i: int = 0) -> Tuple[int, ...]:
        return tuple(self.plan.avals[op.outputs[i].name].shape)

    def _aligned(self, v: _Val, rank: int) -> Dict[int, Optional[int]]:
        return {a: a + rank - len(v.shape) for a in range(len(v.shape))}

    def _static_ints(self, op: OpNode, vals: List[_Val], index: int, attr: str):
        if attr in op.attrs:
            return list(op.attr_ints(attr))
        if len(vals) > index and vals[index].kind == "static":
            return [int(x) for x in np.asarray(vals[index].value).reshape(-1)]
        return None

    def device_op(self, op: OpNode) -> None:
        vals = [self.val(t) for t in op.inputs]
        if all((self.placed(v) or {}) == {} for v in vals if v.kind in ("act", "weight")) and not any(
                v.kind == "weight" and v.spec.name not in self.wp for v in vals) and op.op_type not in (
                "MatMul", "Gemm", "Conv", "ScatterND"):
            # nothing sharded and no weight left to place: runs as it is
            self.finish(op, [self.as_placed(v, {}) for v in vals], [{} for _ in op.outputs])
            return
        rule = getattr(self, "rule_" + op.op_type.replace(".", "_"), None)
        if rule is None and op.op_type in ELEMENTWISE:
            rule = self.rule_elementwise
        elif rule is None and op.op_type in REDUCTIONS:
            rule = self.rule_reduce
        elif rule is None and op.op_type in POOLS:
            rule = self.rule_pool
        if rule is None or rule(op, vals) is False:
            self.replicated(op, vals)

    def rule_elementwise(self, op, vals):
        out = self.out_shape(op)
        live = [i for i, v in enumerate(vals) if v.kind != "none"]
        specs, target = self.unify([vals[i] for i in live], [self._aligned(vals[i], len(out)) for i in live], out)
        inputs = [v.spec for v in vals]
        for i, s in zip(live, specs):
            inputs[i] = s
        self.finish(op, inputs, [target])

    def _matmul_weight_first(self, x: _Val, w: _Val, w_axis: int, x_keep: PMap) -> None:
        """Place a free MatMul / Conv weight as ``shard_weight_spec`` says,
        where the tp dim is not already taken by x's kept axes."""
        from onnxstream_tpu_torch.parallel.sharding import shard_weight_spec
        from torch.distributed.tensor import Shard

        if w.kind != "weight" or w.spec.name in self.wp or self.sizes.get("tp", 1) == 1:
            return
        spec = shard_weight_spec(w.shape, self.sizes["tp"])
        if isinstance(spec, Shard) and spec.dim == w_axis and "tp" not in x_keep.values():
            self.wp[w.spec.name] = {w_axis: "tp"}

    def rule_MatMul(self, op, vals):
        x, w = vals[0], vals[1]
        out = self.out_shape(op)
        R = len(out)
        if len(x.shape) < 2 or len(w.shape) < 2:
            return False
        x_map = {a: (R - len(x.shape) + a if a < len(x.shape) - 1 else None) for a in range(len(x.shape))}
        w_map = {a: (R - len(w.shape) + a if a != len(w.shape) - 2 else None) for a in range(len(w.shape))}
        if len(w.shape) == 2:
            keep = {a: d for a, d in (self.placed(x) or {}).items() if x_map[a] is not None}
            self._matmul_weight_first(x, w, 1, keep)
        specs, target = self.unify([x, w], [x_map, w_map], out)
        self.finish(op, specs, [target])

    def rule_Gemm(self, op, vals):
        if op.attr_int("transA", 0):
            return False
        a, b = vals[0], vals[1]
        out = self.out_shape(op)
        trans_b = op.attr_int("transB", 0)
        b_map = {0: 1, 1: None} if trans_b else {0: None, 1: 1}
        if not trans_b:
            self._matmul_weight_first(a, b, 1, {k: d for k, d in (self.placed(a) or {}).items() if k == 0})
        vs, maps = [a, b], [{0: 0, 1: None}, b_map]
        if len(vals) > 2 and vals[2].kind != "none":
            vs.append(vals[2])
            maps.append(self._aligned(vals[2], 2))
        specs, target = self.unify(vs, maps, out)
        self.finish(op, specs + [v.spec for v in vals[len(specs):]], [target])

    def rule_Conv(self, op, vals):
        if op.attr_int("group", 1) != 1 or op.attr("layout") == "NHWC":
            return False
        x, w = vals[0], vals[1]
        out = self.out_shape(op)
        self._matmul_weight_first(x, w, 0, {a: d for a, d in (self.placed(x) or {}).items() if a == 0})
        vs = [x, w]
        maps = [{a: (0 if a == 0 else None) for a in range(len(x.shape))},
                {a: (1 if a == 0 else None) for a in range(len(w.shape))}]
        if len(vals) > 2 and vals[2].kind != "none":
            vs.append(vals[2])
            maps.append({0: 1})
        specs, target = self.unify(vs, maps, out)
        self.finish(op, specs + [v.spec for v in vals[len(specs):]], [target])

    def _reshape_map(self, in_shape, out_shape, pmap: PMap) -> PMap:
        """Input axis a (split over d) -> the output axis that starts at the
        same flat offset, if it divides over d; axes that map nowhere are
        left out (the caller gathers them)."""
        out: PMap = {}
        for a, d in sorted(pmap.items()):
            outer = math.prod(in_shape[:a])
            for j, size in enumerate(out_shape):
                if math.prod(out_shape[:j]) == outer and size > 1:
                    if size % self.sizes[d] == 0 and j not in out:
                        out[j] = d
                    break
        return out

    def _reshaped(self, op, vals, out, target_const: bool):
        x = vals[0]
        have = self.placed(x) or {}
        omap = self._reshape_map(x.shape, out, have)
        inv = {d: a for a, d in have.items()}
        keep = {inv[d]: d for d in omap.values()}
        xs = self.as_placed(x, keep)
        inputs = [xs] + [v.spec for v in vals[1:]]
        if target_const:
            inputs[1] = self.const(op.inputs[1].name or op.name, np.asarray(self.local_shape(out, omap), np.int64))
        self.finish(op, inputs, [omap])

    def rule_Reshape(self, op, vals):
        self._reshaped(op, vals, self.out_shape(op), target_const=True)

    def rule_Flatten(self, op, vals):
        self._reshaped(op, vals, self.out_shape(op), target_const=False)

    def rule_Transpose(self, op, vals):
        x = vals[0]
        perm = op.attr_ints("perm") or tuple(reversed(range(len(x.shape))))
        have = self.placed(x) or {}
        self.finish(op, [self.as_placed(x, have)], [{i: have[p] for i, p in enumerate(perm) if p in have}])

    def rule_Unsqueeze(self, op, vals):
        x = vals[0]
        axes = self._static_ints(op, vals, 1, "axes")
        if axes is None:
            return False
        R = len(self.out_shape(op))
        ins = sorted(a % R for a in axes)
        pos = [i for i in range(R) if i not in ins]
        have = self.placed(x) or {}
        self.finish(op, [self.as_placed(x, have)] + [v.spec for v in vals[1:]],
                    [{pos[a]: d for a, d in have.items()}])

    def rule_Squeeze(self, op, vals):
        x = vals[0]
        axes = self._static_ints(op, vals, 1, "axes")
        n = len(x.shape)
        gone = {a % n for a in axes} if axes is not None else {a for a in range(n) if x.shape[a] == 1}
        pos = {a: i for i, a in enumerate(a for a in range(n) if a not in gone)}
        have = {a: d for a, d in (self.placed(x) or {}).items() if a in pos}
        self.finish(op, [self.as_placed(x, have)] + [v.spec for v in vals[1:]],
                    [{pos[a]: d for a, d in have.items()}])

    def rule_Expand(self, op, vals):
        out = self.out_shape(op)
        x = vals[0]
        amap = {a: (oa if x.shape[a] == out[oa] else None) for a, oa in self._aligned(x, len(out)).items()}
        (xs,), target = self.unify([x], [amap], out)
        self.finish(op, [xs, self.const(op.inputs[1].name or op.name,
                                        np.asarray(self.local_shape(out, target), np.int64))], [target])

    def _axis(self, op, rank: int, default: int = 0) -> int:
        return op.attr_int("axis", default) % rank

    def rule_Split(self, op, vals):
        x = vals[0]
        ax = self._axis(op, len(x.shape))
        have = {a: d for a, d in (self.placed(x) or {}).items() if a != ax}
        self.finish(op, [self.as_placed(x, have)] + [v.spec for v in vals[1:]], [dict(have) for _ in op.outputs])

    def rule_Concat(self, op, vals):
        out = self.out_shape(op)
        ax = self._axis(op, len(out))
        live = [i for i, v in enumerate(vals) if v.kind != "none"]
        maps = [{a: (None if a == ax else a) for a in range(len(out))} for _ in live]
        specs, target = self.unify([vals[i] for i in live], maps, out)
        inputs = [v.spec for v in vals]
        for i, s in zip(live, specs):
            inputs[i] = s
        self.finish(op, inputs, [target])

    def rule_Slice(self, op, vals):
        x = vals[0]
        if any(v.kind not in ("static", "none") for v in vals[1:]):
            return False
        n_sl = np.asarray(vals[1].value).size
        axes = (np.asarray(vals[3].value).reshape(-1).tolist()
                if len(vals) > 3 and vals[3].kind == "static" else range(n_sl))
        axes = [int(a) % len(x.shape) for a in axes]
        have = {a: d for a, d in (self.placed(x) or {}).items() if a not in axes}
        self.finish(op, [self.as_placed(x, have)] + [v.spec for v in vals[1:]], [have])

    def rule_Gather(self, op, vals):
        data, idx = vals[0], vals[1]
        out = self.out_shape(op)
        ax = self._axis(op, len(data.shape))
        ri = len(idx.shape)
        dmap = {k: (None if k == ax else (k if k < ax else k + ri - 1)) for k in range(len(data.shape))}
        imap = {j: ax + j for j in range(ri)}
        specs, target = self.unify([idx, data], [imap, dmap], out)
        self.finish(op, [specs[1], specs[0]], [target])

    def _keep_axes(self, op, vals, worked: set, keepdims: bool = True,
                   extra: Optional[Dict[int, Dict[int, Optional[int]]]] = None) -> None:
        """Ops that work along ``worked`` (whole there) and keep x's other
        axes; ``extra`` maps the axes of per-channel operands (input index ->
        axis map)."""
        x = vals[0]
        n = len(x.shape)
        kept = [a for a in range(n) if a not in worked]
        amap = {a: (None if a in worked else (a if keepdims else kept.index(a))) for a in range(n)}
        idx, maps = [0], [amap]
        for i, m in (extra or {}).items():
            if i < len(vals) and vals[i].kind != "none":
                idx.append(i)
                maps.append(m)
        specs, target = self.unify([vals[i] for i in idx], maps, self.out_shape(op))
        inputs = [v.spec for v in vals]
        for i, spec in zip(idx, specs):
            inputs[i] = spec
        self.finish(op, inputs, [target] + [{} for _ in op.outputs[1:]])

    def rule_reduce(self, op, vals):
        n = len(vals[0].shape)
        axes = self._static_ints(op, vals, 1, "axes")
        worked = {a % n for a in axes} if axes else set(range(n))
        self._keep_axes(op, vals, worked, bool(op.attr_int("keepdims", 1)))

    def rule_ArgMax(self, op, vals):
        n = len(vals[0].shape)
        self._keep_axes(op, vals, {op.attr_int("axis", 0) % n}, bool(op.attr_int("keepdims", 1)))

    def rule_Softmax(self, op, vals):
        self._keep_axes(op, vals, {op.attr_int("axis", -1) % len(vals[0].shape)})

    def rule_LayerNormalization(self, op, vals):
        n = len(vals[0].shape)
        ax = op.attr_int("axis", -1) % n
        whole = {i: {a: None for a in range(len(vals[i].shape))} for i in (1, 2) if i < len(vals)}
        self._keep_axes(op, vals, set(range(ax, n)), extra=whole)

    def rule_InstanceNormalization(self, op, vals):
        n = len(vals[0].shape)
        self._keep_axes(op, vals, set(range(2, n)), extra={1: {0: 1}, 2: {0: 1}})

    def rule_pool(self, op, vals):
        if op.attr("layout") == "NHWC":
            return False
        self._keep_axes(op, vals, set(range(2, len(vals[0].shape))))

    def rule_Resize(self, op, vals):
        if op.attr("layout") == "NHWC":
            return False
        x = vals[0]
        out = self.out_shape(op)
        self._keep_axes(op, vals, {a for a in range(len(x.shape)) if x.shape[a] != out[a]})
        if len(vals) > 3 and vals[3].kind == "static" and np.asarray(vals[3].value).size:
            # absolute sizes: this rank's
            local = self.local_shape(out, self.pm[op.outputs[0].name])
            self.ops[-1].inputs[3] = self.const(op.inputs[3].name, np.asarray(local, np.int64))

    def rule_ostpu_sdpa(self, op, vals):
        heads = op.attr_int("heads", 0)
        q, k, v = vals[0], vals[1], vals[2]
        mask = vals[3] if len(vals) > 3 else _Val(TensorSpec(name=""), "none")
        out = self.out_shape(op)
        R = len(out)
        qp = self.placed(q) or {}
        if heads:
            # packed (..., M, H*D): shards of the last axis are whole heads
            d = q.shape[-1] // heads
            hkv = k.shape[-1] // d
            tp = qp.get(R - 1)
            if tp is not None and not (heads % self.sizes[tp] == 0 and hkv % self.sizes[tp] == 0):
                tp = None
            fixed = {R - 1: tp} if tp else {}
            last = {R - 1}
            q_map = {a: (a if a < R - 1 or tp else None) for a in range(R)}
            kv_map = {a: (None if a == R - 2 else (a if a < R - 1 or tp else None)) for a in range(R)}
            vs, maps, whole = [q, k, v], [q_map, kv_map, kv_map], [set(), last, last]
        else:
            # head-major (..., H, M, D); k (..., Hkv, N, D) or (..., Hkv, D, N)
            h_ax = R - 3
            hq, hk = q.shape[h_ax], k.shape[len(k.shape) - 3]
            tp = qp.get(h_ax)
            if tp is not None and not (hq % self.sizes[tp] == 0 and hk % self.sizes[tp] == 0):
                tp = None
            fixed = {h_ax: tp} if tp else {}
            q_map = {a: (a if a < R - 1 else None) for a in range(R)}
            kv_map = {a: (a if a < R - 2 else None) for a in range(R)}
            if tp is None:  # heads that do not divide stay whole
                q_map[h_ax] = kv_map[h_ax] = None
            vs, maps, whole = [q, k, v], [q_map, kv_map, kv_map], [set(), {h_ax}, {h_ax}]
            if mask.kind != "none":
                vs.append(mask)
                maps.append({a: (oa if oa < R - 1 else None) for a, oa in self._aligned(mask, R).items()})
                whole.append(set())
        if op.attr_int("causal", 0):
            # the causal mask counts query rows from the first: they stay whole
            for amap in maps:
                for a, oa in amap.items():
                    if oa == R - 2:
                        amap[a] = None
        specs, target = self.unify(vs, maps, out, fixed=fixed, whole=whole)
        inputs = specs + [x.spec for x in vals[len(specs):]]
        attrs = dict(op.attrs)
        if heads and target.get(R - 1):
            attrs["heads"] = str(heads // self.sizes[target[R - 1]])
        self.finish(op, inputs, [target], attrs)

    def _static_first_column(self, v: _Val) -> Optional[np.ndarray]:
        """Column 0 of ScatterND indices, where the host knows it: static
        indices, or a Concat along the last axis whose first operand is a
        host constant one column wide (the llama builder's KV write)."""
        if v.kind == "static":
            arr = np.asarray(v.value)
            return arr.reshape(-1, arr.shape[-1])[:, 0]
        prod = self.producer.get(v.spec.name)
        if prod is None or prod.op_type != "Concat":
            return None
        first = self.val(prod.inputs[0])
        rank = len(first.shape)
        if first.kind != "static" or prod.attr_int("axis", 0) % rank != rank - 1 or first.shape[-1] != 1:
            return None
        return np.asarray(first.value).reshape(-1)

    def rule_ScatterND(self, op, vals):
        data, idx, upd = vals
        dp = self.placed(data) or {}
        if list(dp) != [0] or len(idx.shape) != 2:
            return False
        d = dp[0]
        n, parts = idx.shape[0], self.sizes[d]
        col0 = self._static_first_column(idx)
        if col0 is None or n % parts or len(col0) != n:
            return False
        rows, block = n // parts, data.shape[0] // parts
        for r in range(parts):
            c = col0[r * rows:(r + 1) * rows]
            if c.size and (c.min() < r * block or c.max() >= (r + 1) * block):
                return False
        start, _ = self.block(data.shape[0], d)
        data_s = self.as_placed(data, {0: d})
        upd_s = self.as_placed(upd, {0: d})
        offset = np.zeros((1, idx.shape[1]), np.int64)
        offset[0, 0] = start
        if idx.kind == "static":
            local = np.asarray(idx.value)[self.block(n, d)[0]:self.block(n, d)[1]] - offset
            idx_s = self.const(op.inputs[1].name, local.astype(np.int64))
        else:
            key = (idx.spec.name, "rows", d)
            if key not in self._cache:
                rows_s = self.as_placed(idx, {0: d})
                self._cache[key] = self._emit(
                    "Sub", self._fresh(op.name, "index_op"), [rows_s, self.const(op.name, offset)],
                    self._fresh(idx.spec.name, "local"), rows_s.shape, {})
            idx_s = self._cache[key]
        self.finish(op, [data_s, idx_s, upd_s], [{0: d}])

    # ------------------------------------------------------------ the walk
    def run(self, kv_local: bool):
        from onnxstream_tpu_torch.parallel.sharding import activation_sharding, kv_head_sharding

        kv_inputs = self.config.tp_kv_head_inputs
        for name, aval in self.plan.input_avals.items():
            fn = kv_head_sharding if name in kv_inputs else activation_sharding
            pmap = _placement_map(self.mesh, fn(self.mesh, aval.shape))
            self.pm[name] = {a: d for a, d in pmap.items() if self._divides(aval.shape, a, d)}
        for oi, op in enumerate(self.graph.ops):
            if self.plan.op_modes[oi] == "host":
                self.ops.append(op)
            else:
                self.device_op(op)
        alias: Dict[str, str] = {}
        local_outputs: Dict[str, PMap] = {}
        for name in self.plan.fetch_names:
            pmap = self.pm.get(name)
            if not pmap:
                continue
            shape = (self.plan.avals.get(name) or self.plan.input_avals[name]).shape
            if kv_local and pmap == _placement_map(self.mesh, kv_head_sharding(self.mesh, shape)):
                local_outputs[name] = pmap
                continue
            alias[name] = self.as_placed(_Val(TensorSpec(name=name), "act", tuple(shape)), {}).name
        return alias, local_outputs


def shard_plan(plan, weight_loader, replan):
    """The plan of this rank's share of the graph: the pass over the global
    plan, then ``replan(graph, local input avals, loader, statics)`` on the
    rewritten graph. The returned plan carries the placements the executor
    reads (``Plan.mesh_info``)."""
    from onnxstream_tpu_torch.runtime.planner import ShapeDtype
    from onnxstream_tpu_torch.runtime.quantization import qdq_skip

    mesh = plan.config.mesh
    sp = ShardingPass(plan, mesh)
    alias, local_outputs = sp.run(kv_local=bool(plan.config.tp_kv_head_inputs))
    graph = Graph(ops=sp.ops)
    local_inputs = {k: ShapeDtype(sp.local_shape(a.shape, sp.pm[k]), a.dtype) for k, a in plan.input_avals.items()}

    def loader(name, dtype, shape):
        if name in sp.consts:
            return sp.consts[name]
        return weight_loader(name, dtype, shape)

    statics = dict(plan.static_weights)
    statics.update(sp.consts)
    local = replan(graph, local_inputs, loader, plan.static_env, statics, plan.fetch_names)
    local.pinned_inputs = plan.pinned_inputs
    local.mesh_info = MeshInfo(
        input_shapes={k: tuple(a.shape) for k, a in plan.input_avals.items()},
        fetch_alias=alias, local_outputs=local_outputs,
        placements=dict(sp.pm), weight_placements=dict(sp.wp),
        global_avals=dict(plan.avals), global_weight_bytes=sum(
            math.prod(w.shape) * w.upload_dtype.itemsize for w in plan.arg_weights),
        pass_ops=frozenset(sp.made), qdq_skip=frozenset(qdq_skip(plan.graph)), sizes=dict(sp.sizes),
        coord=dict(sp.coord))
    return local


@dataclasses.dataclass
class MeshInfo:
    """What a rank's plan keeps of the pass: per graph input its global
    shape; the gathered
    tensor behind each sharded output; the outputs that stay local; every
    activation's and weight's placement ({axis: dim}); the global plan's
    shapes and the weight bytes one device would hold; the ops the pass put
    in (gathers, slices, index ops: none of them is the graph's, so none is
    quantized or calibrated, and a W8A8 op looks through them for its
    input's producer); one device's QDQ skip set (``quantization.qdq_skip`` of
    the whole graph); the mesh's sizes and this rank's coordinates."""

    input_shapes: Dict[str, Tuple[int, ...]]
    fetch_alias: Dict[str, str]
    local_outputs: Dict[str, PMap]
    placements: Dict[str, PMap]
    weight_placements: Dict[str, PMap]
    global_avals: Dict[str, object]
    global_weight_bytes: int
    pass_ops: frozenset = frozenset()
    qdq_skip: frozenset = frozenset()
    sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    coord: Dict[str, int] = dataclasses.field(default_factory=dict)

    def whole_shape(self, name: str) -> Tuple[int, ...]:
        a = self.global_avals.get(name)
        return tuple(a.shape) if a is not None else self.input_shapes[name]

    def slices(self, name: str) -> Tuple[Tuple[int, int, int], ...]:
        """This rank's block ((axis, start, stop), ...) of the whole tensor
        (a graph input or a device tensor of the whole graph)."""
        shape = self.whole_shape(name)
        out = []
        for a, d in sorted(self.placements.get(name, {}).items()):
            n = shape[a] // self.sizes[d]
            out.append((a, self.coord[d] * n, (self.coord[d] + 1) * n))
        return tuple(out)

"""Graph planner: host/device partial evaluation.

Counterpart of ``onnxstream_tpu/runtime/planner.py``. The planner walks the
parsed Graph once per input-shape bucket and decides, per op:

  * ``host``  — every input is statically known and the op is foldable: run it
    now on CPU tensors; the result lives in ``static_env`` as numpy (shape and
    index math, int64 weights, ...);
  * ``device`` — run by the executor on ``SessionConfig.device``. Its output
    shapes and dtypes come from running the op impl on ``meta`` tensors, and
    are verified against the shapes recorded in model.txt (the reference's
    check_output_shape, executed at plan time).

Ops that demand a static operand (Reshape shapes, Resize scales, ...) raise
StaticRequired on a ``meta`` tensor; the planner reacts by loading that
weight eagerly and pinning it host-side, then retries the op.

Weights that stay dynamic become ordered streaming arguments, in first-use
order (the order announced to ``WeightsProvider.on_init``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import DType, to_numpy, to_torch, torch_dtype
from onnxstream_tpu_torch.ir import Graph, OpNode, TensorSpec
from onnxstream_tpu_torch.kernels.matmul import oihw_to_w9co
from onnxstream_tpu_torch.kernels.qmatmul import dyn_takes_kmajor, qconv_takes_nhwc, qgemm_takes_kmajor
from onnxstream_tpu_torch.ops import Ctx, StaticRequired, get_impl
from onnxstream_tpu_torch.ops.standard import shape_slice
from onnxstream_tpu_torch.runtime.config import SessionConfig

_META = torch.device("meta")


class PlanError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a device tensor (the planner's abstract value)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device=_META)


@dataclasses.dataclass
class WeightArg:
    name: str
    file_dtype: DType
    upload_dtype: torch.dtype  # dtype of the device copy
    shape: Tuple[int, ...]
    # (scale, zero_point) of a quantized weight: floats per tensor, or (N,)
    # float32 device tensors per output channel (force_uint8_storage_set
    # fills them in at first fetch; (0.0, 0) until then)
    quant: Optional[Tuple[Any, Any]] = None
    # symmetric per-channel int8 storage (int8_symmetric_storage, 2-D only)
    symmetric: bool = False
    # host-side relayout at upload (the fusion recognizers set these through
    # the TensorSpec): ``shape`` above is the transformed device shape,
    # ``file_shape`` what the provider stores, ``transform`` the name of the
    # WEIGHT_TRANSFORMS entry applied in between
    transform: Optional[str] = None
    file_shape: Optional[Tuple[int, ...]] = None
    # the dtype the ops read it in where that is not the upload dtype: the
    # compute dtype of a float weight stored in float16 (force_fp16_storage
    # under float32 compute), cast by the executor at each read
    read_dtype: Optional[torch.dtype] = None
    # under a mesh: this rank's slice ((axis, start, stop), ...) of the
    # weight's ``file_shape``, taken at upload; ``shape`` is the local shape
    shard: Optional[Tuple[Tuple[int, int, int], ...]] = None


def _t9oc(a: torch.Tensor) -> torch.Tensor:
    """(O, C, kh, kw) ONNX conv weight -> (kh*kw, O, C), the tap-major form of
    the fused GroupNorm + SiLU + conv kernel (kernels/gn_conv.py): each tap's
    (O, C) slice is then a row-major matrix operand as it lies. The relayout
    happens once on the host at upload."""
    o, c, kh, kw = a.shape
    return a.permute(2, 3, 0, 1).reshape(kh * kw, o, c).contiguous()


def _t9co(a: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) ONNX conv weight -> (9 C, O), rows tap-major: the B operand
    of the im2col product (kernels/matmul.py conv3x3_im2col) as it lies. The
    relayout happens once on the host at upload."""
    return oihw_to_w9co(a)


def _tnk(a: torch.Tensor) -> torch.Tensor:
    """(K, N) MatMul weight -> (N, K): the K-major B operand of kernel 3's u8
    wgmma pipeline (kernels/qmatmul.py qmatmul with ``weight_nk``), which has
    no transpose for 8-bit operands, and of kernel 6's s8 pipeline and GEMV
    (``w8a8_dyn_matmul`` with ``weight_nk``; the executor quantizes that
    weight first). The relayout happens once on the host at upload."""
    return a.t().contiguous()


def _ohwi(a: torch.Tensor) -> torch.Tensor:
    """(O, C, kh, kw) conv weight -> the same shape in ``torch.channels_last``,
    i.e. laid out (O, kh, kw, C): the K-major A operand of kernel 4's u8
    wgmma pipeline (kernels/qconv.py qconv), K ordered (i, j, c) as its
    channels-last input gather reads it. The shape keeps its OIHW meaning;
    the relayout happens once on the host at upload."""
    return a.contiguous(memory_format=torch.channels_last)


# name -> host relayout of a fetched weight (a CPU tensor in file layout);
# the executor applies it between provider.get and the upload. The provider
# keeps the file layout.
WEIGHT_TRANSFORMS = {"t9oc": _t9oc, "t9co": _t9co, "tnk": _tnk, "ohwi": _ohwi}


def qlinear_mode(op: OpNode, config: SessionConfig) -> Optional[str]:
    """The calibrated W8A8 route of an op, ``"matmul"`` or ``"conv"``, or None:
    ``use_uint8_arithmetic``, a uint8 weight from the file and a range for
    the op (reference static-W8A8 MatMul src/onnxstream.cpp:5790-5795 and qu8
    Conv 4631-4689; JAX ``_qlinear_mode``). The executor takes the route when
    the weight is also a streamed argument; the planner uploads such MatMul
    weights K-major (``_tnk``) and the Conv weights kernel 4's wgmma variant
    takes channels-last (``_ohwi``)."""
    if not (config.use_uint8_arithmetic and len(op.inputs) >= 2 and op.inputs[1].is_weight
            and op.inputs[1].dtype == DType.uint8 and op.name in config.range_data):
        return None
    if op.op_type == "MatMul":
        return "matmul"
    if op.op_type == "Conv" and op.attr_int("group", 1) == 1:
        return "conv"
    return None


@dataclasses.dataclass
class Plan:
    graph: Graph
    config: SessionConfig
    input_avals: Dict[str, ShapeDtype]
    static_env: Dict[str, np.ndarray]
    static_weights: Dict[str, np.ndarray]
    arg_weights: List[WeightArg]
    op_modes: List[str]  # 'host' | 'device'
    avals: Dict[str, ShapeDtype]  # device tensor shapes/dtypes (by name)
    fetch_names: List[str]
    # graph inputs pinned as host constants because an op demanded them
    # statically; the session re-plans when their values change
    pinned_inputs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # under a mesh: this rank's placements (parallel/spmd.py MeshInfo);
    # input_avals and avals are then local
    mesh_info: Any = None

    def stream_entries(self):
        """(name, dtype, shape) in stream order, for WeightsProvider.on_init."""
        return [(w.name, w.file_dtype, w.file_shape or w.shape) for w in self.arg_weights]


def _upload_dtype(spec: TensorSpec, config: SessionConfig) -> torch.dtype:
    """The dtype a weight is uploaded in: float weights travel in the compute
    dtype (converted once on the host), or in float16 under
    ``force_fp16_storage`` with float32 compute (reference
    onnxstream.cpp:3764); uint8 weights stay uint8, weights in
    ``force_uint8_storage_set`` are quantized at first fetch to int8 (2-D,
    ``int8_symmetric_storage``) or uint8, everything else keeps its file
    dtype (JAX ``planner._upload_dtype``)."""
    if spec.name in config.force_uint8_storage_set and spec.dtype.is_float:
        if config.int8_symmetric_storage and len(spec.shape) == 2:
            return torch.int8
        return torch.uint8
    if spec.dtype.is_float:
        if config.force_fp16_storage and config.compute_dtype == "float32":
            return torch.float16
        return config.torch_compute_dtype
    return spec.dtype.torch


class _Planner:
    def __init__(self, graph: Graph, config: SessionConfig, input_avals, weight_loader,
                 input_values=None, static_env=None, static_weights=None):
        self.graph = graph
        self.config = config
        cdt = config.torch_compute_dtype

        # float graph inputs are converted to the compute dtype at entry, and
        # int64 inputs to int32 (device integers are 32-bit; the executor
        # applies the same casts at run time)
        def in_dtype(dt) -> torch.dtype:
            dt = torch_dtype(dt)
            if dt.is_floating_point:
                return cdt
            if dt == torch.int64:
                return torch.int32
            return dt

        self.input_avals = {
            k: ShapeDtype(tuple(v.shape), in_dtype(v.dtype)) for k, v in input_avals.items()
        }
        self.load_weight = weight_loader  # (name, DType, shape) -> host tensor
        # a rank's plan starts from the whole graph's host folds and static
        # weights (parallel/spmd.py): its host ops are not folded again
        self.static_env: Dict[str, np.ndarray] = dict(static_env or {})
        self.static_weights: Dict[str, np.ndarray] = dict(static_weights or {})
        self.arg_weights: List[WeightArg] = []
        self._arg_set: Dict[str, WeightArg] = {}
        self.avals: Dict[str, ShapeDtype] = {}
        self.op_modes: List[str] = []
        self.input_values = input_values or {}
        self.pinned_inputs: Dict[str, np.ndarray] = {}
        # weight name -> ops reading it: a tied weight keeps the file layout
        self._wuse: Dict[str, int] = {}
        for op in graph.ops:
            for t in op.inputs:
                if t.is_weight:
                    self._wuse[t.name] = self._wuse.get(t.name, 0) + 1

    # -- value resolution ----------------------------------------------------
    def _resolve(self, spec: TensorSpec):
        """Return ('none',None) | ('static',np) | ('sym',ShapeDtype) | ('weight',spec)."""
        if not spec.name:
            return ("none", None)
        if spec.is_weight:
            if spec.name in self.static_weights:
                return ("static", self.static_weights[spec.name])
            if spec.name in self._arg_set:
                w = self._arg_set[spec.name]
                dt = self.config.torch_compute_dtype if w.quant else (w.read_dtype or w.upload_dtype)
                return ("sym", ShapeDtype(w.shape, dt))
            # undecided weight: int64 weights are shape math -> always static
            if spec.dtype == DType.int64:
                self._pin_static_weight(spec)
                return ("static", self.static_weights[spec.name])
            return ("weight", spec)
        if spec.name in self.static_env:
            return ("static", self.static_env[spec.name])
        if spec.name in self.avals:
            return ("sym", self.avals[spec.name])
        if spec.name in self.input_avals:
            return ("sym", self.input_avals[spec.name])
        raise PlanError(f"tensor {spec.name!r} consumed before being produced")

    def _pin_static_weight(self, spec: TensorSpec) -> None:
        arr = to_numpy(self.load_weight(spec.name, spec.dtype, spec.file_shape or spec.shape))
        for axis, start, stop in spec.shard or ():
            arr = np.take(arr, np.arange(start, stop), axis=axis)
        if spec.dtype == DType.uint8:
            arr = ((arr.astype(np.float32) - spec.zero_point) * spec.scale).astype(np.float32)
        self.static_weights[spec.name] = arr

    def _kmajor(self, op: OpNode, i: int) -> bool:
        """Whether input i of op is the weight of a calibrated W8A8 MatMul that
        uploads K-major, as (N, K) through WEIGHT_TRANSFORMS["tnk"], for kernel
        3's wgmma pipeline: 2-D, K as the pipeline takes it
        (``qgemm_takes_kmajor``), read by this op alone (a tied weight keeps
        the file layout, as rewrite_smallconv leaves tied convs alone). The
        MatMul keeps its op and its plan-time shapes in the file layout, so
        the tag goes on the WeightArg, not on a rewritten TensorSpec."""
        spec = op.inputs[i]
        return (i == 1 and qlinear_mode(op, self.config) == "matmul" and len(spec.shape) == 2
                and qgemm_takes_kmajor(spec.shape[0]) and not spec.transform
                and self._wuse.get(spec.name, 0) == 1)

    def _dyn_kmajor(self, op: OpNode, i: int) -> bool:
        """Whether input i of op is the weight of a MatMul that the executor
        runs through kernel 6 (``w8a8_dyn_matmul``; its ``_quant_route``): a
        2-D float weight in ``force_uint8_storage_set`` stored as symmetric
        int8 (``int8_symmetric_storage``) with ``use_w8a8_dyn_matmul``, the
        MatMul not run in float32 (``requires_upcast``), K as the K-major
        forms take it (``dyn_takes_kmajor``), read by this op alone (a tied
        weight keeps the file layout). Such a weight uploads K-major, as (N,
        K) through WEIGHT_TRANSFORMS["tnk"], quantized before the relayout."""
        spec, cfg = op.inputs[i], self.config
        return (i == 1 and op.op_type == "MatMul" and len(op.inputs) == 2 and len(spec.shape) == 2
                and _upload_dtype(spec, cfg) == torch.int8 and cfg.use_w8a8_dyn_matmul
                and dyn_takes_kmajor(spec.shape[0]) and not spec.transform
                and self._wuse.get(spec.name, 0) == 1
                and not (cfg.requires_upcast is not None and cfg.requires_upcast(op.op_type, op.name)))

    def _relayout(self, op: OpNode, i: int) -> Optional[str]:
        """The upload transform that input i of op gets for kernel 3, 4 or 6's
        K-major forms, or None: ``"tnk"`` for a calibrated W8A8 MatMul's
        weight (``_kmajor``) and for an int8 MatMul weight of kernel 6
        (``_dyn_kmajor``); ``"ohwi"`` for a calibrated W8A8 Conv's 4-D
        weight that the pipeline takes (``qconv_takes_nhwc``), read by this op
        alone (the executor then quantizes that conv's input channels-last),
        and for the 4-D weight of a ``layout:NHWC`` Conv read by it alone, so
        that cuDNN gets both operands channels-last."""
        if self._kmajor(op, i) or self._dyn_kmajor(op, i):
            return "tnk"
        spec = op.inputs[i]
        alone = i == 1 and len(spec.shape) == 4 and not spec.transform and self._wuse.get(spec.name, 0) == 1
        if alone and qlinear_mode(op, self.config) == "conv" and qconv_takes_nhwc(spec.shape[1]):
            return "ohwi"
        if alone and op.op_type == "Conv" and op.attr("layout") == "NHWC":
            return "ohwi"  # the channel-last Conv of the layout pass reads it so (ops/standard.py)
        return None

    def _promote_weight_to_arg(self, spec: TensorSpec, relayout: Optional[str] = None) -> WeightArg:
        w = self._arg_set.get(spec.name)
        if w is None:
            shape, transform, file_shape = spec.shape, spec.transform, spec.file_shape
            if relayout == "tnk":
                # a rank's slice keeps the whole weight's file shape
                shape, transform, file_shape = (spec.shape[1], spec.shape[0]), "tnk", spec.file_shape or spec.shape
            elif relayout == "ohwi":
                # a rank's O slice keeps the whole weight's file shape too
                transform, file_shape = "ohwi", spec.file_shape or spec.shape
            quant = (spec.scale, spec.zero_point) if spec.dtype == DType.uint8 else None
            symmetric = False
            if quant is None and spec.name in self.config.force_uint8_storage_set and spec.dtype.is_float:
                quant = (0.0, 0)  # placeholder; the executor sets the real ones at first fetch
                symmetric = self.config.int8_symmetric_storage and len(spec.shape) == 2
            upload = _upload_dtype(spec, self.config)
            cdt = self.config.torch_compute_dtype
            w = WeightArg(
                name=spec.name,
                file_dtype=spec.dtype,
                upload_dtype=upload,
                shape=shape,
                quant=quant,
                symmetric=symmetric,
                transform=transform,
                file_shape=file_shape,
                read_dtype=cdt if quant is None and upload.is_floating_point and upload != cdt else None,
                shard=spec.shard,
            )
            self._arg_set[spec.name] = w
            self.arg_weights.append(w)
        return w

    # -- per-op planning -------------------------------------------------------
    def plan_op(self, op: OpNode) -> None:
        impl = get_impl(op.op_type)
        if op.outputs and all(t.name in self.static_env for t in op.outputs if t.name):
            self.op_modes.append("host")  # folded already (a rank's plan)
            return
        resolved = [self._resolve(t) for t in op.inputs]

        # Shape folds from metadata, device tensors and weights included
        if op.op_type == "Shape":
            kind, val = resolved[0]
            if kind == "none":
                raise PlanError(f"{op.name}: Shape of missing input")
            shape = op.inputs[0].shape if kind == "weight" else tuple(val.shape)
            self.op_modes.append("host")
            self._check_and_store(op, [np.asarray(shape_slice(shape, op), dtype=np.int64)], device=False)
            return

        # Host folding: all inputs static (undecided weights block folding
        # unless the op itself later demands them static).
        if impl.host and all(k in ("static", "none") for k, _ in resolved):
            ins = [None if v is None else to_torch(v) for _, v in resolved]
            ctx = Ctx("host", self.config, op.name)
            try:
                outs = impl.fn(ctx, op, ins)
            except StaticRequired as e:
                raise PlanError(f"{op.name}: host fold failed: {e}") from e
            self.op_modes.append("host")
            self._check_and_store(op, [to_numpy(o) for o in outs], device=False)
            return

        # Device op: shapes from the impl run on meta tensors. Undecided
        # weights default to args; StaticRequired demotes them to host
        # constants and retries.
        ctx = Ctx("device", self.config, op.name, device=_META)
        for _attempt in range(len(op.inputs) + 1):
            kinds = [self._resolve(t) for t in op.inputs]
            ins: List[Any] = []
            for i, (kind, val) in enumerate(kinds):
                if kind == "none":
                    ins.append(None)
                elif kind == "static":
                    ins.append(val)
                elif kind == "sym":
                    ins.append(val.meta())
                else:  # undecided weight, as the device would hold it
                    spec = op.inputs[i]
                    dt = (self.config.torch_compute_dtype
                          if spec.dtype.is_float or spec.dtype == DType.uint8 else spec.dtype.torch)
                    ins.append(ShapeDtype(spec.shape, dt).meta())
            try:
                outs = impl.fn(ctx, op, ins)
                break
            except StaticRequired as e:
                spec = op.inputs[e.index]
                if spec.is_weight and spec.name not in self.static_weights:
                    self._pin_static_weight(spec)
                    continue
                if (spec.name in self.input_avals and spec.name in self.input_values
                        and spec.name not in self.static_env):
                    # a pushed tensor used as a static op argument: pin its
                    # current value; the session keys the executor on it
                    val = np.asarray(self.input_values[spec.name])
                    self.static_env[spec.name] = val
                    self.pinned_inputs[spec.name] = val
                    continue
                raise PlanError(
                    f"{op.name} ({op.op_type}): input {e.index} ({spec.name!r}) must be "
                    f"statically known but is a runtime tensor — this graph needs "
                    f"dynamic-shape bucketing"
                ) from e
        else:
            raise PlanError(f"{op.name}: could not satisfy static input requirements")

        # commit: promote undecided weights used dynamically to args
        for i, (kind, _) in enumerate(kinds):
            if kind == "weight":
                self._promote_weight_to_arg(op.inputs[i], self._relayout(op, i))

        self.op_modes.append("device")
        self._check_and_store(op, outs, device=True)

    def _check_and_store(self, op: OpNode, outs, device: bool) -> None:
        if len(outs) != len(op.outputs):
            raise PlanError(f"{op.name}: impl produced {len(outs)} outputs, expected {len(op.outputs)}")
        for spec, out in zip(op.outputs, outs):
            got = tuple(int(d) for d in out.shape)
            want = spec.shape
            if self.config.strict_shapes and want and not spec.has_dynamic_dims and got != want:
                raise PlanError(
                    f"{op.name} ({op.op_type}): output {spec.name!r} shape {got} != "
                    f"declared {want} (check_output_shape)"
                )
            if device:
                self.avals[spec.name] = ShapeDtype(got, out.dtype)
            else:
                self.static_env[spec.name] = out

    def plan(self, fetch_names: Sequence[str]) -> Plan:
        for op in self.graph.ops:
            try:
                self.plan_op(op)
            except PlanError:
                raise
            except Exception as e:
                raise PlanError(f"{op.name} ({op.op_type}): {type(e).__name__}: {e}") from e
        return Plan(
            graph=self.graph,
            config=self.config,
            input_avals=self.input_avals,
            static_env=self.static_env,
            static_weights=self.static_weights,
            arg_weights=self.arg_weights,
            op_modes=self.op_modes,
            avals=self.avals,
            fetch_names=list(fetch_names),
            pinned_inputs=self.pinned_inputs,
        )


def plan_graph(
    graph: Graph,
    config: SessionConfig,
    input_avals: Dict[str, ShapeDtype],
    weight_loader,
    fetch_names: Optional[Sequence[str]] = None,
    input_values: Optional[Dict[str, np.ndarray]] = None,
) -> Plan:
    if fetch_names is None:
        fetch_names = graph.output_names() + [n for n in config.extra_outputs if n not in graph.output_names()]
    plan = _Planner(graph, config, input_avals, weight_loader, input_values).plan(list(fetch_names))
    if config.mesh is None or config.pp_devices:
        # pipeline stages hold whole weights and move whole activations (the
        # JAX package's stages win over its mesh): the rank runs the staged
        # plan on its whole inputs, unsharded
        return plan
    from onnxstream_tpu_torch.parallel.spmd import shard_plan

    def replan(local_graph, local_inputs, loader, static_env, static_weights, fetch):
        return _Planner(local_graph, config, local_inputs, loader, static_env=static_env,
                        static_weights=static_weights).plan(list(fetch))

    return shard_plan(plan, weight_loader, replan)

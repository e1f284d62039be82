"""Segmented eager executor.

Counterpart of ``onnxstream_tpu/runtime/executor.py``. The planned device ops
run op by op on ``SessionConfig.device``:

  * the device ops are partitioned into **segments**, contiguous runs whose
    streamed weights fit ``config.hbm_budget_bytes`` (0 = one segment, weights
    stay resident on the device after the first run);
  * each segment's weights come through the WeightsProvider chain, are
    converted once on the host to the upload dtype, pinned, and copied to the
    device; segments run one after another (overlapping segment k+1's upload
    with segment k is later work);
  * intermediates are freed after their last use inside a segment.

Both runs pin the backend's precision flags to the JAX package's numerics:
float32 products and convolutions in full float32 (no TF32), and bf16/fp16
GEMM reductions in float32.

``run_eager`` is the per-op interpreter with ops_printf / ops_times_printf;
it holds every weight at once and serves as the oracle for ``run``.

``run(device_outputs=True)`` returns the fetched tensors as they are, on the
device and in their compute dtypes, so a caller can feed them back as inputs
(the LLM KV cache). Inputs that are already device tensors are used in place,
and plan constants cross to the device once per executor (``Ctx.consts``):
a decode step then makes no host copy and no host sync. Resident weights of
at least ``SHARED_CACHE_MIN_BYTES`` live in ``shared_device_weight_cache``
when the config gives one, so sessions that share it upload them once.

Quantized weights (JAX ``_maybe_force_quant``, ``_w8_weight``,
``_dyn_s8_weight``): a weight in ``force_uint8_storage_set`` is quantized on
the host at first fetch (symmetric per-channel int8 with
``int8_symmetric_storage``, else percentile uint8, per channel with
``uint8_per_channel``) and uploaded at 1 byte per element; its per-channel
scales and zero points go to the device with it, once. A MatMul whose weight
is 2-D and quantized runs through a hand-written kernel of
``kernels/qmatmul.py``: ``w8a8_dyn_matmul`` for symmetric int8 weights
(``use_w8a8_dyn_matmul``), ``w8_matmul`` for uint8 weights, from the file
(``uint8[scale,zp]``) or forced (``use_w8_matmul``); the activation is cast
to the compute dtype first. Every other quantized weight is dequantized on
read, per-channel scales broadcasting on the last axis.

Calibrated W8A8 (JAX ``_qlinear_mode``, ``_eval_qlinear``): with
``use_uint8_arithmetic``, a MatMul or group-1 Conv whose weight is uint8 in the
file and whose op has a range in ``config.range_data`` quantizes its input
activation with the producer op's calibrated range and runs through kernel 3
(``kernels/qmatmul.py qmatmul``; a Conv through ``kernels/qconv.py qconv``,
kernel 3 as an implicit GEMM), with a float output in the compute dtype.
This route comes first; then the int8 and uint8 weight routes above, then
dequantize-on-read. ``use_uint8_qdq`` quantize-dequantizes every pushed float
intermediate (``_maybe_qdq``), single-use tensors consumed by the next op
excepted, as the reference does. ``run_eager`` with ``range_data_calibrate``
records per-op ranges (graph inputs under their tensor names, op outputs
before QDQ) into ``Executor.range_data``; the percentiles are taken on the
device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import DType, to_torch
from onnxstream_tpu_torch.ir import OpNode
from onnxstream_tpu_torch.kernels.qconv import qconv
from onnxstream_tpu_torch.kernels.qmatmul import qmatmul, quantize_activation, w8_matmul, w8a8_dyn_matmul
from onnxstream_tpu_torch.ops import Ctx, get_impl
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS, Plan, WeightArg
from onnxstream_tpu_torch.runtime.quantization import (
    RangeData,
    quantize_weight_percentile,
    quantize_weight_percentile_per_channel,
    quantize_weight_symmetric_per_channel,
    range_to_scale,
)
from onnxstream_tpu_torch.runtime.weights import WeightsProvider


# Only weights this big go to the shared cache, keyed by (name, shape, dtype):
# builder constants (shape vectors) may reuse a name with other contents
# across bucket graphs, model weights never do.
SHARED_CACHE_MIN_BYTES = 1 << 20


def upload_bytes(w: WeightArg) -> int:
    n = 1
    for d in w.shape:
        n *= d
    return n * w.upload_dtype.itemsize


@dataclasses.dataclass
class Segment:
    op_indices: List[int]
    weight_args: List[WeightArg]
    in_names: List[str]
    out_names: List[str]
    weight_bytes: int


def build_segments(plan: Plan, fetch_names: Sequence[str]) -> List[Segment]:
    graph, config = plan.graph, plan.config
    budget = config.hbm_budget_bytes

    device_ops = [i for i, m in enumerate(plan.op_modes) if m == "device"]
    arg_by_name = {w.name: w for w in plan.arg_weights}

    def op_weight_names(i):
        return [t.name for t in graph.ops[i].inputs if t.is_weight and t.name in arg_by_name]

    # a weight used by several ops is fetched once per segment that needs it
    segments: List[Segment] = []
    cur_ops: List[int] = []
    cur_w: List[WeightArg] = []
    cur_names: set = set()
    cur_bytes = 0

    def flush():
        nonlocal cur_ops, cur_w, cur_names, cur_bytes
        if cur_ops:
            segments.append(Segment(cur_ops, cur_w, [], [], cur_bytes))
        cur_ops, cur_w, cur_names, cur_bytes = [], [], set(), 0

    for i in device_ops:
        new_names = [n for n in op_weight_names(i) if n not in cur_names]
        wbytes = sum(upload_bytes(arg_by_name[n]) for n in new_names)
        if budget > 0 and cur_ops and cur_bytes + wbytes > budget:
            flush()
            new_names = op_weight_names(i)
            wbytes = sum(upload_bytes(arg_by_name[n]) for n in new_names)
        cur_ops.append(i)
        for n in new_names:
            if n not in cur_names:
                cur_names.add(n)
                cur_w.append(arg_by_name[n])
        cur_bytes += wbytes
    flush()

    # boundary activations: producer segment of each device tensor
    producer_seg: Dict[str, int] = {}
    for si, seg in enumerate(segments):
        for oi in seg.op_indices:
            for t in graph.ops[oi].outputs:
                if t.name:
                    producer_seg[t.name] = si
    needed_out: Dict[int, set] = {si: set() for si in range(len(segments))}
    needed_in: Dict[int, set] = {si: set() for si in range(len(segments))}
    for si, seg in enumerate(segments):
        for oi in seg.op_indices:
            for t in graph.ops[oi].inputs:
                if t.is_weight or not t.name or t.name in plan.static_env:
                    continue
                p = producer_seg.get(t.name)
                if p is None:  # graph input
                    needed_in[si].add(t.name)
                elif p != si:
                    needed_out[p].add(t.name)
                    needed_in[si].add(t.name)
    for name in fetch_names:
        p = producer_seg.get(name)
        if p is not None:
            needed_out[p].add(name)
    for si, seg in enumerate(segments):
        seg.in_names = sorted(needed_in[si])
        seg.out_names = sorted(needed_out[si])
    return segments


@contextlib.contextmanager
def reference_precision():
    """Pin the backend precision flags to the JAX package's numerics for the
    duration of a run, and restore the caller's settings afterwards."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    m.allow_tf32 = c.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, c.allow_tf32, m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved


def percentiles(t: torch.Tensor) -> tuple:
    """``quantization.get_percentiles`` of a tensor, computed where it lies:
    the same order statistics of its finite values, from a sort."""
    flat = t.detach().float().reshape(-1)
    finite = flat[torch.isfinite(flat)]
    n = finite.numel()
    if n == 0:
        return 0.0, 0.0
    if n == 1:
        v = float(finite[0])
        return v, v
    k_lo = int(n * 0.001)
    k_hi = max(n - 1 - int(n * 0.001), k_lo)
    ends = torch.sort(finite).values[[k_lo, k_hi]].tolist()
    return min(ends), max(ends)


def _to_host(v) -> np.ndarray:
    """Fetched output -> numpy: floats as float32 (converted on the device
    first), signed integers as int64 (the wire integer dtype)."""
    t = to_torch(v)
    if t.is_floating_point():
        t = t.float()
    elif t.dtype in (torch.int8, torch.int16, torch.int32):
        t = t.long()
    return t.cpu().numpy()


class Executor:
    def __init__(self, plan: Plan, provider: WeightsProvider):
        self.plan = plan
        self.graph = plan.graph
        self.config = plan.config
        self.device = torch.device(self.config.device)
        self.provider = provider
        self.segments = build_segments(plan, plan.fetch_names)
        self._resident: Dict[str, torch.Tensor] = {}
        # id(plan constant) -> [array, device copy]: see Ctx.tensor
        self._consts: Dict[int, list] = {
            id(v): [v, None] for v in (*plan.static_env.values(), *plan.static_weights.values())
            if isinstance(v, np.ndarray)}
        self.ops_times: Dict[str, float] = {}
        # last device op reading each activation: it is freed after that op
        last_use: Dict[str, int] = {}
        for i, op in enumerate(self.graph.ops):
            for t in op.inputs:
                if t.name and not t.is_weight:
                    last_use[t.name] = i
        self._last_use = last_use
        # ops run with fp32 inputs and outputs: the predicate is asked once
        # per op here, not on every run
        upcast = self.config.requires_upcast
        self._upcast = frozenset() if upcast is None else frozenset(
            i for i, op in enumerate(self.graph.ops) if upcast(op.op_type, op.name))
        self._arg_by_name = {w.name: w for w in plan.arg_weights}
        # calibration ranges recorded by run_eager (range_data_calibrate)
        self.range_data = RangeData()
        # tensor name -> producing op name: a W8A8 op quantizes its input with
        # the producer's calibrated output range (JAX Executor._producer_op)
        self._producer_op = {t.name: op.name for op in self.graph.ops for t in op.outputs if t.name}
        # reference QDQ skip rule (src/onnxstream.cpp:3009-3020): a pushed
        # tensor consumed only by the immediately next op is not quantized
        refs: Dict[str, int] = {}
        for op in self.graph.ops:
            for t in op.inputs:
                if t.name and not t.is_weight:
                    refs[t.name] = refs.get(t.name, 0) + 1
        self._qdq_skip = {
            op.outputs[0].name for op, nxt in zip(self.graph.ops, self.graph.ops[1:])
            if len(op.outputs) == 1 and op.outputs[0].name and refs.get(op.outputs[0].name, 0) == 1
            and any(t.name == op.outputs[0].name for t in nxt.inputs if not t.is_weight)}
        # op index -> "matmul" | "conv": the calibrated W8A8 route (first in
        # precedence), then op index -> the 8-bit weight kernel of a MatMul
        self._qlinear = {i: m for i, op in enumerate(self.graph.ops)
                         if plan.op_modes[i] == "device" and (m := self._qlinear_mode(op))}
        self._qroute = {i: r for i, op in enumerate(self.graph.ops)
                        if plan.op_modes[i] == "device" and i not in self._qlinear
                        and (r := self._quant_route(i, op))}
        # host seconds spent quantizing force_uint8_storage_set weights
        self.quantize_seconds = 0.0
        provider.on_init(plan.stream_entries())
        self._first_run_done = False

    # ------------------------------------------------------------- weights
    def _maybe_force_quant(self, w: WeightArg, host: torch.Tensor) -> Optional[torch.Tensor]:
        """force_uint8_storage_set: quantize a float weight on the host at
        fetch time and return it (None for any other weight); its (scale,
        zero point) land on the WeightArg, vectors on the device (reference
        storage demotion, src/onnxstream.cpp:3764-3808; JAX
        ``Executor._maybe_force_quant``)."""
        if (w.name not in self.config.force_uint8_storage_set or not w.file_dtype.is_float
                or host.dtype in (torch.uint8, torch.int8)):
            return None
        t0 = time.perf_counter()
        a32 = host.float().numpy()
        if w.symmetric:
            # symmetric per-channel s8, the storage form of w8a8_dyn_matmul
            q, scale = quantize_weight_symmetric_per_channel(a32)
            quant = (scale, 0.0)
        elif self.config.uint8_per_channel and a32.ndim == 2:
            q, scale, zero = quantize_weight_percentile_per_channel(a32)
            quant = (scale, zero)
        else:
            q, scale, zero = quantize_weight_percentile(a32)
            quant = (scale, zero)
        self.quantize_seconds += time.perf_counter() - t0
        w.quant = tuple(torch.from_numpy(v).to(self.device) if isinstance(v, np.ndarray) else v
                        for v in quant)
        return torch.from_numpy(q)

    def _upload(self, w: WeightArg) -> torch.Tensor:
        """Provider fetch in file layout -> the WeightArg's relayout
        (WEIGHT_TRANSFORMS, e.g. (O, C, 3, 3) -> (9, O, C) for the fused
        GroupNorm + SiLU + conv kernel) -> upload dtype on the host (quantized
        for force_uint8_storage_set) -> pinned -> device."""
        host = self.provider.get(w.name, w.file_dtype, w.file_shape or w.shape)
        if w.transform:
            # the fusion pass leaves forced-quantized weights alone, so a
            # transformed weight is a float one and skips _maybe_force_quant
            conv = WEIGHT_TRANSFORMS[w.transform](host).to(w.upload_dtype)
        else:
            conv = self._maybe_force_quant(w, host)
            if conv is None:
                conv = host.to(w.upload_dtype)
        if self.device.type != "cuda":
            return conv.to(self.device)
        return conv.pin_memory().to(self.device, non_blocking=True)

    def _cache_slot(self, w: WeightArg):
        """(cache, key) holding w's resident device copy: the shared cache
        for big weights when the config gives one, else this executor's."""
        shared = self.config.shared_device_weight_cache
        if shared is not None and upload_bytes(w) >= SHARED_CACHE_MIN_BYTES:
            return shared, (w.name, w.shape, str(w.upload_dtype))
        return self._resident, w.name

    def _fetch_segment_weights(self, seg: Segment) -> Dict[str, torch.Tensor]:
        resident = self.config.hbm_budget_bytes == 0
        out: Dict[str, torch.Tensor] = {}
        for w in seg.weight_args:
            cache, key = self._cache_slot(w)
            hit = cache.get(key)
            if hit is None:
                dev = self._upload(w)
                if resident:
                    cache[key] = (dev, w.quant, w.symmetric)
                    # the device copy owns the weight now (reference
                    # WeightsProvider::remove); weights_exclusion_set opts out
                    if w.name not in self.config.weights_exclusion_set:
                        self.provider.remove(w.name)
            else:
                # a hit uploaded by another executor carries the quantization
                # parameters to this executor's WeightArg, whose forced
                # weights still hold the planner's placeholder
                dev, quant, symmetric = hit
                if quant is not None:
                    w.quant, w.symmetric = quant, symmetric
            out[w.name] = dev
        return out

    def weight_bytes(self) -> int:
        return sum(upload_bytes(w) for w in self.plan.arg_weights)

    def device_weights(self) -> List[torch.Tensor]:
        """The resident device weights this executor uses (shared ones
        included) and their per-channel scales and zero points, for counting
        device memory across sessions."""
        out = []
        for w in self.plan.arg_weights:
            cache, key = self._cache_slot(w)
            if key in cache:
                dev, quant, _ = cache[key]
                out.append(dev)
                out.extend(v for v in quant or () if isinstance(v, torch.Tensor))
        return out

    @property
    def quant_routes(self) -> Dict[str, str]:
        """Op name -> the quantized kernel it runs through: ``qmatmul`` /
        ``qconv`` (calibrated W8A8), ``w8a8_dyn_matmul``, ``w8_matmul``."""
        routes = {self.graph.ops[i].name: r for i, r in self._qroute.items()}
        routes.update({self.graph.ops[i].name: "qconv" if m == "conv" else "qmatmul"
                       for i, m in self._qlinear.items()})
        return routes

    def _qlinear_mode(self, op: OpNode) -> Optional[str]:
        """The calibrated W8A8 route: a uint8 weight from the file and a range
        for this op (reference static-W8A8 MatMul src/onnxstream.cpp:5790-5795
        and qu8 Conv 4631-4689; JAX ``_qlinear_mode``)."""
        if not (self.config.use_uint8_arithmetic and len(op.inputs) >= 2 and op.inputs[1].is_weight
                and op.inputs[1].dtype == DType.uint8 and op.name in self.config.range_data
                and op.inputs[1].name in self._arg_by_name):
            return None
        if op.op_type == "MatMul":
            return "matmul"
        if op.op_type == "Conv" and op.attr_int("group", 1) == 1:
            return "conv"
        return None

    def _activation_qparams(self, op: OpNode):
        """(scale, zero) to quantize op's input activation: the producer op's
        calibrated range when known (the statistic the reference computes at
        push time), else a range recorded under the tensor's own name (graph
        inputs, observed during calibration), else this op's own range."""
        rd = self.config.range_data
        tname = op.inputs[0].name
        name = self._producer_op.get(tname)
        if name is None or name not in rd:
            name = tname if tname in rd else op.name
        return range_to_scale(*rd[name])

    def _quant_route(self, oi: int, op: OpNode) -> Optional[str]:
        """The kernel of a MatMul whose weight is 2-D and quantized (JAX
        ``_dyn_s8_weight`` and ``_w8_weight``): ``w8a8_dyn_matmul`` for
        symmetric int8 storage, ``w8_matmul`` for uint8; None otherwise, and
        for ops run in float32 (requires_upcast)."""
        if op.op_type != "MatMul" or len(op.inputs) != 2 or oi in self._upcast:
            return None
        t = op.inputs[1]
        if not (t.is_weight and t.name) or t.name in self.plan.static_weights:
            return None
        w = self._arg_by_name.get(t.name)
        if w is None or w.quant is None or len(w.shape) != 2:
            return None
        if w.symmetric:
            return "w8a8_dyn_matmul" if self.config.use_w8a8_dyn_matmul else None
        return "w8_matmul" if self.config.use_w8_matmul else None

    # --------------------------------------------------------------- op eval
    def _eval_qmatmul(self, route: str, op: OpNode, env: Dict[str, Any],
                      weights_env: Dict[str, Any]) -> torch.Tensor:
        w = self._arg_by_name[op.inputs[1].name]
        aname = op.inputs[0].name
        a = self.plan.static_env.get(aname, env.get(aname))
        if not isinstance(a, torch.Tensor):
            a = Ctx("device", self.config, op.name, device=self.device, consts=self._consts).tensor(a)
        cdt = self.config.torch_compute_dtype
        if a.is_floating_point() and a.dtype != cdt:
            a = a.to(cdt)
        scale, zero = w.quant
        if route == "w8a8_dyn_matmul":
            return w8a8_dyn_matmul(a, weights_env[w.name], scale, out_dtype=cdt)
        return w8_matmul(a, weights_env[w.name], scale, zero, out_dtype=cdt)

    def _eval_qlinear(self, mode: str, op: OpNode, env: Dict[str, Any],
                      weights_env: Dict[str, Any]) -> torch.Tensor:
        """Quantize the input activation, run kernel 3 (integer products,
        zero-point corrections and dequantization in one launch) and return
        the float result in the compute dtype. Requantizing the output to the
        op's range is left to the QDQ stage (JAX ``_eval_qlinear``)."""
        cdt = self.config.torch_compute_dtype
        ctx = Ctx("device", self.config, op.name, device=self.device, consts=self._consts)
        aname = op.inputs[0].name
        a = ctx.tensor(self.plan.static_env.get(aname, env.get(aname)))
        w = self._arg_by_name[op.inputs[1].name]
        w_scale, w_zero = w.quant
        a_scale, a_zero = self._activation_qparams(op)
        if mode == "matmul":
            a_q = quantize_activation(a, a_scale, a_zero)
            return qmatmul(a_q, weights_env[w.name], a_scale, a_zero, w_scale, w_zero, out_dtype=cdt)
        bias = None
        if len(op.inputs) > 2 and op.inputs[2].name:
            bname = op.inputs[2].name
            bias = ctx.tensor(self.plan.static_weights[bname] if bname in self.plan.static_weights
                              else weights_env[bname])
        conv1d = a.ndim == 3
        if conv1d:
            a = a[..., None]
        strides = list(op.attr_ints("strides", [1, 1]))
        dilations = list(op.attr_ints("dilations", [1, 1]))
        pads = list(op.attr_ints("pads", [0, 0, 0, 0]))
        if conv1d:
            strides += [1] * (2 - len(strides))
            dilations += [1] * (2 - len(dilations))
            if len(pads) == 2:
                pads = [pads[0], 0, pads[1], 0]
        w_raw = weights_env[w.name]
        if w_raw.ndim == 3:
            w_raw = w_raw[..., None]
        out = qconv(quantize_activation(a, a_scale, a_zero), w_raw, a_scale, a_zero, w_scale, w_zero,
                    bias=bias, strides=strides, pads=pads, dilations=dilations, out_dtype=cdt)
        return out[..., 0] if conv1d else out

    def _qdq_range(self, op: OpNode, x: torch.Tensor):
        """(scale, zero) for the QDQ of a pushed tensor: XNNPACK's fixed qu8
        softmax quantization (1/256, 0; reference src/onnxstream.cpp:5862), a
        calibrated range, or the reference's 0.1% percentiles estimated on
        the device from a strided subsample of at most 2^20 values (JAX
        ``_qdq_range``)."""
        if op.op_type == "Softmax":
            return 1.0 / 256.0, 0.0
        if op.name in self.config.range_data:
            return range_to_scale(*self.config.range_data[op.name])
        xf = x.float().reshape(-1)
        n = xf.numel()
        if n > (1 << 20):
            xf = xf[:: n // (1 << 20)]
            n = xf.numel()
        xs = torch.sort(xf).values
        k = int(n * 0.001)
        lo = xs[k].clamp(max=0.0)  # range_to_scale forces 0 into the range
        hi = xs[n - 1 - k].clamp(min=0.0)
        scale = (hi - lo) / 255.0
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        zero = torch.round(-lo / scale).clamp(0, 255)
        return scale, zero

    def _maybe_qdq(self, op: OpNode, outs: List[Any]) -> List[Any]:
        """use_uint8_qdq: quantize-dequantize each pushed float intermediate
        (reference push_tensor, src/onnxstream.cpp:3022-3034). Single-use
        tensors consumed by the immediately following op are skipped, as in
        the reference (3009-3020); fetched outputs are never degraded."""
        if not self.config.use_uint8_qdq:
            return outs
        fetched = set(self.plan.fetch_names)
        res = []
        for spec, o in zip(op.outputs, outs):
            if (spec.name and spec.name not in self._qdq_skip and spec.name not in fetched
                    and isinstance(o, torch.Tensor) and o.is_floating_point()):
                scale, zero = self._qdq_range(op, o)
                # a tensor divisor keeps the division IEEE on the card
                s = scale if isinstance(scale, torch.Tensor) else torch.full(
                    (), scale, dtype=torch.float32, device=o.device)
                q = (torch.round(o.float() / s) + zero).clamp_(0, 255).to(torch.uint8)
                o = ((q.float() - zero) * s).to(o.dtype)
            res.append(o)
        return res

    def _eval_op(self, oi: int, op: OpNode, env: Dict[str, Any], weights_env: Dict[str, Any]):
        qmode = self._qlinear.get(oi)
        if qmode is not None:
            return [self._eval_qlinear(qmode, op, env, weights_env)]
        route = self._qroute.get(oi)
        if route is not None:
            return [self._eval_qmatmul(route, op, env, weights_env)]
        ins: List[Any] = []
        for t in op.inputs:
            if not t.name:
                ins.append(None)
            elif t.is_weight:
                v = self.plan.static_weights.get(t.name)
                if v is None:
                    v = weights_env[t.name]
                    quant = self._arg_by_name[t.name].quant
                    if quant is not None:
                        # dequantize on read (reference src/onnxstream.cpp:2885-2909)
                        scale, zero = quant
                        v = ((v.float() - zero) * scale).to(self.config.torch_compute_dtype)
                ins.append(v)
            elif t.name in self.plan.static_env:
                ins.append(self.plan.static_env[t.name])
            else:
                ins.append(env[t.name])
        upcast = oi in self._upcast
        if upcast:
            # device values only: static numpy operands keep their dtype
            ins = [v.float() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                   for v in ins]
        ctx = Ctx("device", self.config, op.name, device=self.device, consts=self._consts)
        outs = get_impl(op.op_type).fn(ctx, op, ins)
        if upcast:
            cdt = self.config.torch_compute_dtype
            outs = [o.to(cdt) if isinstance(o, torch.Tensor) and o.is_floating_point() else o
                    for o in outs]
        return outs

    def _run_segment(self, seg: Segment, weights: Dict[str, torch.Tensor],
                     env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keep = set(seg.out_names)
        for oi in seg.op_indices:
            op = self.graph.ops[oi]
            for spec, val in zip(op.outputs, self._maybe_qdq(op, self._eval_op(oi, op, env, weights))):
                if spec.name:
                    env[spec.name] = val
            for t in op.inputs:
                if t.name and not t.is_weight and self._last_use.get(t.name) == oi and t.name not in keep:
                    env.pop(t.name, None)
        return {n: env[n] for n in seg.out_names}

    # ------------------------------------------------------------------ runs
    def _prepare_inputs(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        prepared = {}
        for k, aval in self.plan.input_avals.items():
            if k not in inputs:
                raise KeyError(f"missing graph input {k!r}")
            prepared[k] = to_torch(inputs[k]).to(self.device, aval.dtype)
        return prepared

    def _outputs(self, results: Dict[str, Any], device_outputs: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in self.plan.fetch_names:
            if name in results:
                v = results[name]
            elif name in self.plan.static_env:
                v = self.plan.static_env[name]
            else:
                v = self.plan.static_weights[name]
            out[name] = v if device_outputs else _to_host(v)
        return out

    def run(self, inputs: Dict[str, Any], device_outputs: bool = False) -> Dict[str, Any]:
        """Segmented run. Returns float outputs as float32 numpy and integers
        as int64 numpy; with ``device_outputs`` the device tensors as they
        are (outputs folded on the host stay numpy)."""
        if self._first_run_done:
            self.provider.on_restart()
        with reference_precision():
            acts = self._prepare_inputs(inputs)
            results: Dict[str, torch.Tensor] = {}
            for si, seg in enumerate(self.segments):
                weights = self._fetch_segment_weights(seg)
                env = {n: (acts[n] if n in acts else results[n]) for n in seg.in_names}
                # all graph inputs flow through the first segment's env too
                if si == 0:
                    env = {**acts, **env}
                results.update(self._run_segment(seg, weights, env))
                del weights
            out = self._outputs(results, device_outputs)
        self._first_run_done = True
        return out

    def run_eager(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Per-op interpreter over every device op with all weights fetched
        up front: ops_printf / ops_times_printf, range calibration
        (reference src/onnxstream.cpp:2983-3004), and the oracle for run()."""
        if self._first_run_done:
            self.provider.on_restart()
        timed = self.config.ops_times_printf
        calibrate = self.config.range_data_calibrate
        fetched = set(self.plan.fetch_names)
        with reference_precision():
            env: Dict[str, Any] = self._prepare_inputs(inputs)
            if calibrate:
                # graph-input ranges under the tensor name: W8A8 ops whose
                # input has no producer quantize with this range
                for k, v in env.items():
                    if v.is_floating_point():
                        self.range_data.update(k, *percentiles(v))
            weights_env = {w.name: self._upload(w) for w in self.plan.arg_weights}
            for oi, op in enumerate(self.graph.ops):
                if self.plan.op_modes[oi] != "device":
                    continue
                if self.config.ops_printf:
                    print(f"#{oi}) {op.op_type} ({op.name})")
                t0 = time.perf_counter() if timed else 0.0
                outs = self._eval_op(oi, op, env, weights_env)
                if calibrate:
                    # calibration observes pre-QDQ values (reference
                    # push_tensor records ranges before conversion)
                    for o in outs:
                        if isinstance(o, torch.Tensor) and o.is_floating_point():
                            self.range_data.update(op.name, *percentiles(o))
                outs = self._maybe_qdq(op, outs)
                if timed:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.ops_times[op.op_type] = self.ops_times.get(op.op_type, 0.0) + (
                        time.perf_counter() - t0) * 1e3
                for spec, val in zip(op.outputs, outs):
                    if spec.name:
                        env[spec.name] = val
                # an activation is freed after its last reader, as in run()
                for t in op.inputs:
                    if t.name and not t.is_weight and self._last_use.get(t.name) == oi and t.name not in fetched:
                        env.pop(t.name, None)
            out = self._outputs(env)
        self._first_run_done = True
        if timed and self.ops_times:
            for t, ms in sorted(self.ops_times.items(), key=lambda kv: -kv[1]):
                print(f"{t}: {ms:.1f} ms")
        return out

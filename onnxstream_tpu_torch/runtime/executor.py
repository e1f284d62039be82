"""Segmented eager executor.

Counterpart of ``onnxstream_tpu/runtime/executor.py``. The planned device ops
run op by op on ``SessionConfig.device``:

  * the device ops are partitioned into **segments**, contiguous runs whose
    streamed weights fit ``config.hbm_budget_bytes`` (0 = one segment, weights
    stay resident on the device after the first run);
  * each segment's weights come through the WeightsProvider chain and are
    converted on the host to the upload dtype; a float weight converted so
    goes back to the provider (``update``), so that a caching provider
    converts it once (JAX ``_fetch_segment_weights``). In a streamed run, a
    provider that keeps no converted copy (``keeps_updates`` False: nocache,
    the prefetchers) hands over the file's bytes, which are converted on
    the card after the copy instead;
  * streamed runs (``hbm_budget_bytes > 0``) are double-buffered, the
    counterpart of the JAX executor's loop: while segment k's ops are
    dispatched, segment k+1's weights are fetched (in ``stream_entries``
    order, spread over segment k's ops, all before its last op) into one of
    two reused host staging buffers (pinned on CUDA; the native prefetcher
    writes into them directly) and copied to the device on a copy stream of
    their own; the compute stream waits on that copy's event before segment
    k+1's first op. Segment k's weights are released once its last op is
    enqueued (JAX donates them); each was ``record_stream``-ed onto the
    compute stream, and segment k+1's first upload waits until the device
    has finished segment k-1, so at most two segments' weights are alive and
    a staging buffer is never overwritten before its copy ended. On the CPU
    the same schedule runs without streams or events;
  * intermediates are freed after their last use; boundary activations
    after the segment that reads them last.

``hbm_accounting()`` is the counterpart of the JAX executor's: per segment
the weight bytes and the peak bytes of its live activations (from the
plan's shapes), and the streamed bound max_k (activations_k + weights_k +
weights_k+1).

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
(``use_w8a8_dyn_matmul``; the planner uploads such a weight K-major, as
(N, K) through ``WEIGHT_TRANSFORMS["tnk"]``, quantized before the
relayout), ``w8_matmul`` for uint8 weights, from the file
(``uint8[scale,zp]``) or forced (``use_w8_matmul``); the activation is cast
to the compute dtype first. Every other quantized weight is dequantized on
read, per-channel scales broadcasting on the last axis.

Calibrated W8A8 (JAX ``_qlinear_mode``, ``_eval_qlinear``): with
``use_uint8_arithmetic``, a MatMul or group-1 Conv whose weight is uint8 in the
file and whose op has a range in ``config.range_data`` quantizes its input
activation with the producer op's calibrated range and runs through kernel 3
(``kernels/qmatmul.py qmatmul``; a Conv through ``kernels/qconv.py qconv``,
kernel 3 as an implicit GEMM), with a float output in the compute dtype. The
planner uploads such a MatMul's weight K-major, as (N, K)
(``WEIGHT_TRANSFORMS["tnk"]``), for kernel 3's wgmma pipeline, and such a
Conv's weight channels-last (``"ohwi"``) where kernel 4's wgmma variant takes
it, whose input is then quantized channels-last.
This route comes first; then the int8 and uint8 weight routes above, then
dequantize-on-read. ``use_uint8_qdq`` quantize-dequantizes every pushed float
intermediate (``_maybe_qdq``), single-use tensors consumed by the next op
excepted, as the reference does. ``run_eager`` with ``range_data_calibrate``
records per-op ranges (graph inputs under their tensor names, op outputs
before QDQ) into ``Executor.range_data``; the percentiles are taken on the
device.

Synthetic weights (JAX ``_synth_kind``, ``_synthesize_missing``): with
``synthetic_device_weights`` a weight of at least ``synthetic_min_elements``
elements is generated on the device in its upload dtype and shape (after any
relayout) instead of being fetched and uploaded: N(0, ``SYNTH_SCALE``) for a
float weight, uniform s8 in [-127, 127] with a flat per-channel scale for a
force-quantized symmetric int8 weight, uniform u8 for a uint8 weight from
the file (its (scale, zero point) are the file's). Each weight's stream comes
from one ``torch.Generator`` on the device, seeded from the weight's index
among the plan's weights (JAX folds the index into a fixed key), so the
same graph gives the same weights on every fetch and in every session; the
values are not ``jax.random``'s. Smaller weights stay real. Synthesized
weights are cached like uploaded ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import DType, to_torch
from onnxstream_tpu_torch.ir import OpNode
from onnxstream_tpu_torch.kernels.qconv import qconv
from onnxstream_tpu_torch.kernels.qmatmul import qmatmul, quantize_activation, w8_matmul, w8a8_dyn_matmul
from onnxstream_tpu_torch.ops import Ctx, get_impl
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS, Plan, WeightArg, qlinear_mode
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

SYNTH_SCALE = 0.02  # N(0, SYNTH_SCALE) float weights; the s8 scale derives from it


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


def synth_kind(w: WeightArg, config) -> Optional[str]:
    """The kind of device generation that stands in for w under
    ``synthetic_device_weights`` (JAX ``Executor._synth_kind``): ``"normal"``
    for a big float weight, ``"s8"`` for a big force-quantized symmetric int8
    weight, ``"u8"`` for a big uint8 weight from the file; None for the rest
    (small tensors, index tables, masks), which stay real. The size gate is
    on elements, so a weight stored at 1 byte gates as its float form does.
    Unlike JAX, a relayouted weight (``transform``) is synthesized too,
    directly in its upload shape."""
    if math.prod(w.shape) < config.synthetic_min_elements:
        return None
    dt = w.upload_dtype
    if w.quant is None and dt.is_floating_point and w.file_dtype.is_float:
        return "normal"
    if w.symmetric and dt == torch.int8 and w.name in config.force_uint8_storage_set:
        return "s8"
    if w.quant is not None and not w.symmetric and dt == torch.uint8 and w.file_dtype == DType.uint8:
        return "u8"
    return None


def _to_host(v) -> np.ndarray:
    """Fetched output -> numpy: floats as float32 (converted on the device
    first), signed integers as int64 (the wire integer dtype)."""
    t = to_torch(v)
    if t.is_floating_point():
        t = t.float()
    elif t.dtype in (torch.int8, torch.int16, torch.int32):
        t = t.long()
    return t.cpu().numpy()


STAGING_ALIGN = 256  # bytes: each weight's slice of a staging buffer starts on this


def _file_bytes(w: WeightArg) -> int:
    return math.prod(w.file_shape or w.shape) * w.file_dtype.itemsize


def _staged_bytes(w: WeightArg) -> int:
    """w's slice of a staging buffer: its file bytes or its upload bytes,
    whichever cross (the larger), aligned."""
    return -(-max(upload_bytes(w), _file_bytes(w)) // STAGING_ALIGN) * STAGING_ALIGN


class _SegmentFetch:
    """One segment's weights on their way to the device in a streamed run:
    fetched in order into staging buffer ``slot`` and copied on the copy
    stream (CUDA) or into fresh tensors (CPU). ``advance(n)`` fetches up to
    the n-th weight; the first call first waits until the device has
    finished the segment before the one now running (``after``), whose
    weights are then free, as is this slot's staging buffer. ``take()``
    completes the fetch, makes the compute stream wait for its copies and
    hands the weights over."""

    def __init__(self, ex: "Executor", si: int, slot: int, after=None):
        self.ex, self.si, self.slot, self.after = ex, si, slot, after
        # the stream the weights are read on (the fetch runs under the copy stream)
        self.compute = torch.cuda.current_stream(ex.device) if ex._copy_stream is not None else None
        self.args = ex.segments[si].weight_args
        self.weights: Dict[str, torch.Tensor] = {}
        self.done = 0
        self.offset = 0
        self.ready = None

    def advance(self, n: int) -> None:
        ex = self.ex
        if self.done >= n:
            return
        if self.done == 0:
            if self.after is not None:
                self.after.synchronize()
            if ex._staging_free[self.slot] is not None:
                ex._staging_free[self.slot].synchronize()
        stream = ex._copy_stream
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            for w in self.args[self.done:n]:
                self.weights[w.name] = self._fetch(w)
        self.done = n

    def _fetch(self, w: WeightArg) -> torch.Tensor:
        ex = self.ex
        kind = ex._synth_kind(w)
        if kind is not None:
            return self._stream_ordered(w, ex._synthesize(w, kind))
        buf = ex._staging[self.slot][self.offset:]
        self.offset += _staged_bytes(w)
        if ex._crosses_as_file_bytes(w):
            # the file's bytes cross as they are: the provider writes them
            # into the staging buffer (the native prefetcher with no second
            # host copy). A float weight that no provider keeps converted is
            # converted on the card, on the copy stream
            host = buf[:_file_bytes(w)].view(w.file_dtype.torch).view(w.shape)
            ex.provider.get_into(w.name, w.file_dtype, w.shape, host)
        else:
            conv = ex._host_weight(w)
            # the host tensor's layout (channels-last for ohwi) is kept
            host = buf[:upload_bytes(w)].view(w.upload_dtype).as_strided(conv.shape, conv.stride())
            host.copy_(conv)
        dev = torch.empty_strided(host.shape, host.stride(), dtype=host.dtype, device=ex.device)
        dev.copy_(host, non_blocking=True)
        return self._stream_ordered(w, dev.to(w.upload_dtype))

    def _stream_ordered(self, w: WeightArg, dev: torch.Tensor) -> torch.Tensor:
        if self.compute is not None:
            # allocated on the copy stream, read on the compute stream: the
            # allocator must not hand its block out again before the compute
            # stream is done with it
            for t in (dev, *(w.quant or ())):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(self.compute)
        return dev

    def take(self) -> Dict[str, torch.Tensor]:
        self.advance(len(self.args))
        ex = self.ex
        if self.compute is not None:
            self.ready = torch.cuda.Event()
            self.ready.record(ex._copy_stream)
            self.compute.wait_event(self.ready)
        ex._staging_free[self.slot] = self.ready
        weights, self.weights = self.weights, {}
        return weights


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
        self._arg_index = {w.name: i for i, w in enumerate(plan.arg_weights)}
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
        # weights converted to their upload dtype on the host (_host_weight)
        self.host_conversions = 0
        # streamed runs: the two staging buffers and the copy stream
        self._staging: List[Optional[torch.Tensor]] = [None, None]
        self._staging_free: List[Any] = [None, None]
        self._copy_stream = None
        # per segment: activations read by a later segment, dropped after it
        self._drop_after = self._boundary_lifetimes()
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

    def _synthesize(self, w: WeightArg, kind: str) -> torch.Tensor:
        """Generate w on the device in its upload dtype and shape (JAX
        ``_synth_generate``): one generator seeded from w's index in the
        plan. An s8 weight gets a flat per-channel scale on
        the file layout's last axis (JAX ``_stamp_s8_quant``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._arg_index[w.name])
        shape, dev = tuple(w.shape), self.device
        if kind == "s8":
            out = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            n = (w.file_shape or w.shape)[-1]
            w.quant = (torch.full((n,), SYNTH_SCALE / 127.0, dtype=torch.float32, device=dev), 0.0)
            w.symmetric = True
        elif kind == "u8":
            out = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        else:
            out = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).mul_(SYNTH_SCALE)
            out = out.to(w.upload_dtype)
        if w.transform == "ohwi":  # the memory layout the relayout gives
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    def _synth_kind(self, w: WeightArg) -> Optional[str]:
        return synth_kind(w, self.config) if self.config.synthetic_device_weights else None

    def _host_weight(self, w: WeightArg) -> torch.Tensor:
        """Provider fetch in file layout -> quantized for
        force_uint8_storage_set -> the WeightArg's relayout
        (WEIGHT_TRANSFORMS, e.g. (O, C, 3, 3) -> (9, O, C) for the fused
        GroupNorm + SiLU + conv kernel) -> upload dtype, on the host. A
        float weight converted to its upload dtype with no relayout goes
        back through ``provider.update`` (JAX executor.py:531-537), so a
        caching provider hands the converted tensor out from then on."""
        host = self.provider.get(w.name, w.file_dtype, w.file_shape or w.shape)
        # quantized in the file layout first (per output channel), then
        # relayouted: kernel 6's int8 weights (tnk) take both steps
        q = self._maybe_force_quant(w, host)
        conv = host if q is None else q
        if w.transform:
            conv = WEIGHT_TRANSFORMS[w.transform](conv)
        if conv.dtype != w.upload_dtype:
            conv = conv.to(w.upload_dtype)
            self.host_conversions += 1
            if q is None and w.transform is None:
                self.provider.update(w.name, conv)
        return conv

    def _upload(self, w: WeightArg) -> torch.Tensor:
        """A synthesized weight (``synth_kind``) under
        synthetic_device_weights; otherwise ``_host_weight`` -> pinned ->
        device (resident weights and run_eager; streamed runs go through
        ``_SegmentFetch``)."""
        kind = self._synth_kind(w)
        if kind is not None:
            return self._synthesize(w, kind)
        conv = self._host_weight(w)
        if self.device.type != "cuda":
            return conv.to(self.device)
        return conv.pin_memory().to(self.device, non_blocking=True)

    def _cache_slot(self, w: WeightArg):
        """(cache, key) holding w's resident device copy: the shared cache
        for big weights when the config gives one, else this executor's."""
        shared = self.config.shared_device_weight_cache
        if shared is not None and upload_bytes(w) >= SHARED_CACHE_MIN_BYTES:
            return shared, (w.name, w.shape, str(w.upload_dtype), w.transform)
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
        """The calibrated W8A8 route (``planner.qlinear_mode``) of an op whose
        weight is streamed."""
        mode = qlinear_mode(op, self.config)
        return mode if mode and op.inputs[1].name in self._arg_by_name else None

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
            # the planner uploads the weight as (N, K) where kernel 6's K-major forms take it
            return w8a8_dyn_matmul(a, weights_env[w.name], scale, out_dtype=cdt, weight_nk=w.transform == "tnk")
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
            # the planner uploads the weight as (N, K) where kernel 3's wgmma pipeline takes it
            return qmatmul(a_q, weights_env[w.name], a_scale, a_zero, w_scale, w_zero, out_dtype=cdt,
                           weight_nk=w.transform == "tnk")
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
        # a weight uploaded channels-last (ohwi) runs on kernel 4's wgmma
        # variant, which reads the input channels-last too
        a_q = quantize_activation(a, a_scale, a_zero, channels_last=w.transform == "ohwi")
        out = qconv(a_q, w_raw, a_scale, a_zero, w_scale, w_zero,
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
                    w = self._arg_by_name[t.name]
                    if w.quant is not None:
                        # dequantize on read (reference src/onnxstream.cpp:2885-2909)
                        scale, zero = w.quant
                        v = ((v.float() - zero) * scale).to(self.config.torch_compute_dtype)
                    elif w.read_dtype is not None:
                        # float16 storage under float32 compute: one transient
                        # float32 copy a use (torch does not promote a mixed
                        # product as jnp does)
                        v = v.to(w.read_dtype)
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
                     env: Dict[str, torch.Tensor],
                     nxt: Optional[_SegmentFetch] = None) -> Dict[str, torch.Tensor]:
        """Dispatch seg's ops. With ``nxt`` (a streamed run), the next
        segment's weights are fetched between the ops, spread evenly, the
        last of them before seg's last op; seg's weights are released once
        its last op is enqueued."""
        keep = set(seg.out_names)
        n = len(seg.op_indices)
        for j, oi in enumerate(seg.op_indices):
            if nxt is not None:
                nxt.advance(len(nxt.args) if n == 1 else -(-j * len(nxt.args) // (n - 1)))
            op = self.graph.ops[oi]
            for spec, val in zip(op.outputs, self._maybe_qdq(op, self._eval_op(oi, op, env, weights))):
                if spec.name:
                    env[spec.name] = val
            for t in op.inputs:
                if t.name and not t.is_weight and self._last_use.get(t.name) == oi and t.name not in keep:
                    env.pop(t.name, None)
        weights.clear()
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

    @property
    def streamed(self) -> bool:
        return self.config.hbm_budget_bytes > 0

    def _boundary_lifetimes(self) -> List[set]:
        """Per segment, the boundary activations it reads last: a streamed
        run drops them once it has run (fetched outputs excepted)."""
        last: Dict[str, int] = {}
        for si, seg in enumerate(self.segments):
            for n in seg.in_names:
                last[n] = si
        fetched = set(self.plan.fetch_names)
        drop: List[set] = [set() for _ in self.segments]
        for n, si in last.items():
            if n not in fetched and n not in self.plan.input_avals:
                drop[si].add(n)
        return drop

    def _start_streaming(self) -> None:
        """The copy stream (CUDA) and the two staging buffers, each as large
        as the largest segment's staged weights; pinned on CUDA."""
        if self._staging[0] is not None:
            return
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        size = max((sum(_staged_bytes(w) for w in seg.weight_args if self._synth_kind(w) is None)
                    for seg in self.segments), default=0)
        pin = self.device.type == "cuda"
        self._staging = [torch.empty(max(size, 1), dtype=torch.uint8, pin_memory=pin) for _ in range(2)]

    def _crosses_as_file_bytes(self, w: WeightArg) -> bool:
        """Whether a streamed run copies w's file bytes to the card as they
        are (converted there when the dtypes differ) rather than a tensor
        prepared on the host (``_host_weight``)."""
        return (w.transform is None and w.name not in self.config.force_uint8_storage_set
                and (w.file_dtype.torch == w.upload_dtype or not self.provider.keeps_updates))

    def _segment_env(self, si: int, acts, results) -> Dict[str, Any]:
        env = {n: (acts[n] if n in acts else results[n]) for n in self.segments[si].in_names}
        # all graph inputs flow through the first segment's env too
        return {**acts, **env} if si == 0 else env

    def run(self, inputs: Dict[str, Any], device_outputs: bool = False) -> Dict[str, Any]:
        """Segmented run, double-buffered when streamed (see the module
        docstring). Returns float outputs as float32 numpy and integers as
        int64 numpy; with ``device_outputs`` the device tensors as they are
        (outputs folded on the host stay numpy)."""
        if self._first_run_done:
            self.provider.on_restart()
        with reference_precision():
            acts = self._prepare_inputs(inputs)
            results: Dict[str, torch.Tensor] = {}
            if not self.streamed:
                for si, seg in enumerate(self.segments):
                    weights = self._fetch_segment_weights(seg)
                    results.update(self._run_segment(seg, weights, self._segment_env(si, acts, results)))
            elif self.segments:
                self._run_streamed(acts, results)
            out = self._outputs(results, device_outputs)
        self._first_run_done = True
        return out

    def _run_streamed(self, acts, results) -> None:
        self._start_streaming()
        cuda = self._copy_stream is not None
        fetch, done = _SegmentFetch(self, 0, 0), None
        try:
            for si, seg in enumerate(self.segments):
                weights = fetch.take()
                nxt = (_SegmentFetch(self, si + 1, (si + 1) % 2, after=done)
                       if si + 1 < len(self.segments) else None)
                results.update(self._run_segment(seg, weights, self._segment_env(si, acts, results), nxt))
                for n in self._drop_after[si]:
                    results.pop(n, None)
                if cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                fetch = nxt
        except BaseException:
            # a fetch cut short may leave copies in flight from a staging
            # buffer whose free event was never recorded
            if cuda:
                self._copy_stream.synchronize()
            raise

    def _activation_peaks(self) -> List[int]:
        """Per segment, the most bytes of activations alive at once while
        it runs, from the plan's shapes and dtypes: the graph inputs, the
        boundary activations held for later segments, and the segment's own
        intermediates from their op until their last reader (both an op's
        inputs and its outputs count at that op). Scratch inside an op is
        not counted."""
        avals, ins = self.plan.avals, self.plan.input_avals

        def nbytes(name: str) -> int:
            a = avals.get(name) or ins.get(name)
            return math.prod(a.shape) * a.dtype.itemsize if a is not None else 0

        held = {n: nbytes(n) for n in ins}  # graph inputs and boundary results
        peaks = []
        for si, seg in enumerate(self.segments):
            keep = set(seg.out_names)
            live = dict(held)
            total = peak = sum(live.values())
            for oi in seg.op_indices:
                op = self.graph.ops[oi]
                for t in op.outputs:
                    if t.name and t.name not in live:
                        live[t.name] = nbytes(t.name)
                        total += live[t.name]
                peak = max(peak, total)
                for t in op.inputs:
                    if (t.name and not t.is_weight and self._last_use.get(t.name) == oi and t.name not in keep
                            and t.name not in ins and t.name in live):
                        total -= live.pop(t.name)
            peaks.append(peak)
            held.update({n: nbytes(n) for n in seg.out_names})
            for n in self._drop_after[si]:
                held.pop(n, None)
        return peaks

    def _cast_peaks(self) -> List[int]:
        """Per segment, the most bytes of transient read-dtype copies alive at
        once: the float32 copies of one op's float16-stored weights
        (``WeightArg.read_dtype``, force_fp16_storage), made at the op's read
        and freed after it."""
        peaks = []
        for seg in self.segments:
            peak = 0
            for oi in seg.op_indices:
                ws = {t.name for t in self.graph.ops[oi].inputs if t.is_weight and t.name in self._arg_by_name}
                peak = max(peak, sum(math.prod(w.shape) * w.read_dtype.itemsize
                                     for w in map(self._arg_by_name.get, ws) if w.read_dtype is not None))
            peaks.append(peak)
        return peaks

    def hbm_accounting(self) -> Dict[str, Any]:
        """Device-memory estimate of a run (JAX ``Executor.hbm_accounting``):
        per segment its weight bytes and its activation peak
        (``_activation_peaks``, plus the transient copies of ``_cast_peaks``);
        ``peak_bytes`` is one segment's weights and activations when
        resident, and max_k (activations_k + weights_k + weights_k+1 +
        converted_k+1) when streamed, the double buffer holding segment k+1's
        weights while segment k runs, converted_k+1 the file bytes of the
        largest of them converted on the card (alive until its conversion)."""
        wb = [seg.weight_bytes for seg in self.segments]
        act = [a + c for a, c in zip(self._activation_peaks(), self._cast_peaks())]
        conv = [max((_file_bytes(w) for w in seg.weight_args if self._synth_kind(w) is None
                     and self._crosses_as_file_bytes(w) and w.file_dtype.torch != w.upload_dtype), default=0)
                for seg in self.segments]
        nxt = [w + c for w, c in zip(wb[1:], conv[1:])] + [0] if self.streamed else [0] * len(wb)
        return {"mode": "streamed" if self.streamed else "resident", "segments": len(wb),
                "weight_bytes": sum(wb), "segment_weight_bytes": wb, "segment_activation_bytes": act,
                "peak_bytes": max((a + w + n for a, w, n in zip(act, wb, nxt)), default=0)}

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

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
    writes into them directly) and copied on a copy stream of their own into
    one of two **weight slots**, device buffers allocated once, each as
    large as the largest segment's upload bytes: segment k's weights are
    views of slot k % 2 at offsets the plan fixes (``slot_offsets``), the
    same on every run. File bytes converted on the card cross into one fixed
    raw buffer and are converted into their view; synthesized weights are
    generated and copied into theirs. The compute stream waits on the copy's
    event before segment k+1's first op; the copy stream waits, before
    filling a slot, for the end event of the last segment that read it
    (segment k-1), and the host for the last copy out of a staging buffer
    before refilling it. On the CPU the same schedule and the same slots
    run without streams or events;
  * intermediates are freed after their last use; boundary activations
    after the segment that reads them last.

``hbm_accounting()`` is the counterpart of the JAX executor's: per segment
the weight bytes and the peak bytes of its live activations (from the
plan's shapes), and the streamed bound max_k (activations_k + weights_k +
weights_k+1).

Both runs pin the backend's precision flags to the JAX package's numerics:
float32 products and convolutions in full float32 (no TF32), and bf16/fp16
GEMM reductions in float32.

Under ``SessionConfig.mesh`` the plan is this rank's (``parallel/spmd.py``):
its weights are sliced at upload (``WeightArg.shard``; synthesized ones
generated whole, then sliced), its inputs sliced before they cross
(``Plan.mesh_info``), its sharded outputs read from their gathered tensors.
A budget then streams this rank's slices: ``build_segments`` counts them, a
sharded weight is sliced on the host (``_host_weight``) and only its slice
crosses, so the budget, the staging buffers and ``hbm_accounting()`` are per
rank. The calibrated routes see the graph one device runs: a W8A8 op finds
its input's producer through the pass's gathers and slices
(``MeshInfo.pass_ops``), the QDQ skip set is one device's
(``MeshInfo.qdq_skip``) and no output of the pass's ops is quantized or
calibrated; a range taken at run time is the whole tensor's (calibration
gathers each block's extreme values, ``_percentiles``, and QDQ's percentiles
the strided subsample of the whole tensor, ``_global_sample``), so every
rank holds the one-device ranges.
With ``pp_devices`` each segment runs on its stage's device (contiguous
blocks, ``seg_stage``), every stage's weights resident there, a weight of
two stages copied device to device, boundary activations moved to the
stage; nothing is streamed. Beside a mesh the stages win, as in the JAX
package: the planner skips the sharding pass and the rank runs the staged
graph on its whole inputs (its outputs are the unsharded staged run's).

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
from one ``torch.Generator`` on the device, seeded from a CRC-32 of the
weight's name (JAX folds its index among the plan's weights into a fixed
key), so a weight is the same on every fetch, in every session, in every
bucket graph that reads it and on every rank; the values are not
``jax.random``'s. Smaller weights stay real. Synthesized weights are cached
like uploaded ones.

Under a mesh a force-quantized weight is quantized as one device would
quantize it and this rank keeps its slice, bit for bit, its per-channel
scale and zero vectors sliced with it: a per-column scale (symmetric s8,
per-channel u8) over a slice of columns is exact on the slice alone, which
is quantized; a scale over the whole tensor needs the whole weight, which is
quantized first. A K-major relayout (``tnk``) comes after the slice.

``segment_fn(si)`` is the counterpart of JAX's ``_segment_fn``: the
segment's ops as a function of its weights and inputs, which autograd can
differentiate where no op runs a hand-written kernel (the train step of
``parallel/sharding.py``).

Captured segments (JAX ``_compiled``, ``jax.jit`` of every segment
function): on a CUDA device, ``run`` dispatches the segments op by op once
(the warm-up: kernels built at first use, cuBLAS and cuDNN plans chosen,
workspaces and constants sized); on the second run it captures each
segment's ops into a ``torch.cuda.CUDAGraph`` of its own and replays it
(a capture executes nothing), and from then on copies the graph inputs into
static buffers and replays the segments' graphs in order. Every graph of an
executor allocates from one pool (``Session.graph_pool``, or the
executor's own), captured and replayed in run order, so a boundary
activation dropped after its last reader (``_boundary_lifetimes``) leaves
its memory to the later segments. Graph k+1 reads graph k's outputs where
they lie. A streamed segment reads its weights from its slot's views, which
the copy stream refills outside the graphs before each replay: from the
third run on, the host replays segment k, records its end event and then
fetches segment k+1 whole while the card runs k. Pipeline stages capture a
graph a segment on their stage's device over its resident weights; a
boundary activation that changes device is copied into a static buffer
outside the graphs. The outputs are copies, as JAX's are fresh arrays, so a
later replay never overwrites what a caller holds. ``capture_problem``
states why an executor is not captured (the CPU, a mesh, the per-op
interpreter); those run op by op every time. A capture that fails raises,
naming the segment and the op that was dispatching: nothing falls back. A
graph holds what it reads at fixed addresses: the weights (the slot views
or the resident tensors) and their quantization vectors, and the kernels'
workspaces (``kernels.capturing``). The launches the wrappers counted
during a capture are held to the graph's kernel nodes
(``kernels.held_to_graph``, ``graph_launches``), and each replay adds them
to the wrappers' counts. ``memory_analysis(si)`` gives segment si's graph's
bytes. A change of a scalar config option (``use_flash_attention``, ...)
drops the graphs: the next run is a warm-up again; so does ``reset_graph``,
and runs inside ``eager()`` go op by op and leave the graphs as they were.
Sessions whose runs never overlap may share one pool
(``Session.graph_pool``). ``capture_graph`` is the one capture of the port:
the executor's segments and the SD pipeline's device programs
(``models/sd/pipeline.py DeviceProgram``: a step of the denoising loop, the
tiled decode), which call ``segment_fn(0)`` over the resident weights where
``segment_fn_problem`` finds nothing in the way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from onnxstream_tpu_torch import kernels
from onnxstream_tpu_torch.dtypes import DType, to_torch
from onnxstream_tpu_torch.ir import OpNode
from onnxstream_tpu_torch.kernels.qconv import qconv
from onnxstream_tpu_torch.kernels.qmatmul import qmatmul, quantize_activation, w8_matmul, w8a8_dyn_matmul
from onnxstream_tpu_torch.ops import Ctx, get_impl
from onnxstream_tpu_torch.parallel import comm
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS, Plan, WeightArg, qlinear_mode
from onnxstream_tpu_torch.runtime.quantization import (
    RangeData,
    quantize_weight_percentile,
    quantize_weight_percentile_per_channel,
    quantize_weight_symmetric_per_channel,
    qdq_skip,
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
    """Contiguous device ops grouped so that each segment's weight bytes fit
    ``hbm_budget_bytes`` (0: one segment), with each segment's boundary
    inputs and outputs. Under a mesh the bytes are this rank's (a sharded
    weight counts its slice), so the budget is per rank."""
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
    directly in its upload shape. The gate counts the whole weight, also
    where a rank holds a slice of it."""
    if math.prod(w.file_shape or w.shape) < config.synthetic_min_elements:
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


def _take_shard(t: torch.Tensor, shard) -> torch.Tensor:
    """The slice ((axis, start, stop), ...) of t, a view."""
    for axis, start, stop in shard:
        t = t.narrow(axis, start, stop - start)
    return t


def _upload_layout(w: WeightArg) -> tuple:
    """The whole weight's shape in its upload layout and its shard's axes
    mapped there: a K-major weight (``tnk``) is the transpose of its file
    layout, the other relayouts of a sharded weight keep its axes."""
    whole = tuple(w.file_shape or w.shape)
    shard = tuple(w.shard or ())
    if w.transform == "tnk":
        return whole[::-1], tuple((1 - axis, start, stop) for axis, start, stop in shard)
    if shard and w.transform not in (None, "ohwi"):
        raise NotImplementedError(f"{w.name}: a {w.transform} weight is not sliced under a mesh")
    return (whole if shard else tuple(w.shape)), shard


def synth_seed(name: str) -> int:
    """The generator seed of a synthesized weight: a CRC-32 of its name, the
    same in every process (``hash()`` is salted per process)."""
    return zlib.crc32(name.encode())


STAGING_ALIGN = 256  # bytes: each weight's slice of a staging buffer or a slot starts on this


def _aligned(n: int) -> int:
    return -(-n // STAGING_ALIGN) * STAGING_ALIGN


def _file_bytes(w: WeightArg) -> int:
    """The file bytes of what crosses for w: the whole weight, or under a
    mesh this rank's slice of it (a relayout keeps the element count)."""
    return math.prod(w.shape) * w.file_dtype.itemsize


def _upload_strides(w: WeightArg) -> tuple:
    """The strides of w's device tensor: channels-last for an ``ohwi``
    weight (the relayout's memory format), contiguous for the rest."""
    fmt = torch.channels_last if w.transform == "ohwi" else torch.contiguous_format
    return torch.empty(w.shape, device="meta", memory_format=fmt).stride()


class _SegmentFetch:
    """Segment si's weights on their way to its slot (si % 2) in a streamed
    run: fetched in order into the staging buffer of the same index and
    copied into the slot's views on the copy stream (CUDA; on the CPU the
    same copies, in order). ``advance(n)`` fetches up to the n-th weight;
    its first call makes the host wait until the last copy out of this
    staging buffer has ended, and the copy stream until the compute stream
    has finished the last segment that read this slot (``_slot_done``:
    segment si - 2, or the run before's). ``take()`` completes the fetch,
    makes the compute stream wait for its copies and hands the views over."""

    def __init__(self, ex: "Executor", si: int):
        self.ex, self.si, self.slot = ex, si, si % 2
        # the stream the weights are read on (the fetch runs under the copy stream)
        self.compute = torch.cuda.current_stream(ex.device) if ex._copy_stream is not None else None
        self.args = ex.segments[si].weight_args
        self.weights: Dict[str, torch.Tensor] = {}
        self.done = 0
        self.offset = 0

    def advance(self, n: int) -> None:
        ex = self.ex
        if self.done >= n:
            return
        stream = ex._copy_stream
        if self.done == 0:
            if ex._staging_free[self.slot] is not None:
                ex._staging_free[self.slot].synchronize()
            if stream is not None and ex._slot_done[self.slot] is not None:
                stream.wait_event(ex._slot_done[self.slot])
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            for w in self.args[self.done:n]:
                self.weights[w.name] = self._fetch(w)
        self.done = n

    def _fetch(self, w: WeightArg) -> torch.Tensor:
        ex = self.ex
        view = ex.slot_view(self.si, w)
        kind = ex._synth_kind(w)
        if kind is not None:
            view.copy_(ex._synthesize(w, kind))
            return self._stream_ordered(w, view)
        buf = ex._staging[self.slot][self.offset:]
        self.offset += ex._staged_bytes(w)
        if ex._crosses_as_file_bytes(w):
            # the file's bytes cross as they are: the provider writes them
            # into the staging buffer (the native prefetcher with no second
            # host copy). A float weight that no provider keeps converted
            # crosses into the raw buffer and is converted into its view on
            # the card, on the copy stream
            host = buf[:_file_bytes(w)].view(w.file_dtype.torch).view(w.shape)
            ex.provider.get_into(w.name, w.file_dtype, w.shape, host)
            if host.dtype != view.dtype:
                raw = ex._raw[:_file_bytes(w)].view(host.dtype).view(w.shape)
                raw.copy_(host, non_blocking=True)
                host = raw
        else:
            # staged in the view's layout (channels-last for ohwi), so the copy is one memcpy
            host = buf[:upload_bytes(w)].view(w.upload_dtype).as_strided(view.shape, view.stride())
            host.copy_(ex._host_weight(w))
        view.copy_(host, non_blocking=True)
        return self._stream_ordered(w, view)

    def _stream_ordered(self, w: WeightArg, view: torch.Tensor) -> torch.Tensor:
        if self.compute is not None:
            # quantization vectors made on the copy stream and read on the
            # compute stream: the allocator must not hand their blocks out
            # again before the compute stream is done with them
            for t in w.quant or ():
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(self.compute)
        return view

    def take(self) -> Dict[str, torch.Tensor]:
        self.advance(len(self.args))
        ex = self.ex
        ready = None
        if self.compute is not None:
            ready = torch.cuda.Event()
            ready.record(ex._copy_stream)
            self.compute.wait_event(ready)
        ex._staging_free[self.slot] = ready
        weights, self.weights = self.weights, {}
        return weights


def _interpreter_problem(ex: "Executor") -> Optional[str]:
    """What keeps a run of ex op by op on any device: a mesh (its
    collectives), the per-op interpreter's flags, no device ops; or None."""
    config = ex.config
    if config.mesh is not None:
        return "runs under a mesh: its collectives are not captured (gloo gathers cross host memory)"
    for flag in ("ops_printf", "ops_times_printf", "range_data_calibrate"):
        if getattr(config, flag):
            return f"{flag}: Session.run takes the per-op interpreter (run_eager)"
    if not ex.segments:
        return "no device ops"
    return None


def segment_fn_problem(ex: "Executor") -> Optional[str]:
    """Why ``ex.segment_fn(0)`` over the executor's resident weights cannot
    stand for ``ex.run`` (a pipeline's device program calls it directly, as
    JAX's programs call ``_segment_fn``), or None: streamed weights,
    pipeline stages, or ``_interpreter_problem``. Decided from the config
    and the plan alone."""
    config = ex.config
    if ex.streamed:
        return (f"streamed: weights cross to the card on every run (hbm_budget_bytes "
                f"{config.hbm_budget_bytes}, {len(ex.segments)} segments)")
    if config.pp_devices:
        return f"pipeline stages on {len(config.pp_devices)} devices: activations hop between them"
    return _interpreter_problem(ex)


def capture_problem(ex: "Executor") -> Optional[str]:
    """Why ``ex.run`` cannot capture its segments into CUDA graphs and
    replay them, or None: a CPU device, or ``_interpreter_problem``.
    Streamed segments, pipeline stages and QDQ ranges taken from the data
    (sorted on the device, sized from shapes: nothing waits for the card)
    are captured. Decided from the config and the plan alone: nothing is
    asked of a card."""
    if ex.device.type != "cuda":
        return f"runs on {ex.device}: CUDA graphs exist on CUDA devices only"
    return _interpreter_problem(ex)


# config fields that ops read at dispatch time: a captured graph holds the
# values it was captured under (see Executor._dispatch_key)
_SCALARS = (bool, int, float, str, type(None), torch.device)
# device -> the side stream captures run on
_CAPTURE_STREAMS: Dict[torch.device, Any] = {}
# a shared pool that a failed capture left recording -> the pool that
# captures naming it use from then on (capture_graph)
_POOL_AFTER_FAILURE: Dict[tuple, Any] = {}


@dataclasses.dataclass
class CapturedGraph:
    """A CUDA graph made by ``capture_graph``: the graph, what its body
    returned (in the graph's pool: copied out before another graph of the
    pool replays), what the capture recorded of the kernel wrappers (the
    workspaces it holds, the launches one replay makes), its kernel nodes by
    function name and the launches they make by set of entry kernels
    (``kernels.held_to_graph``), anything else it reads (held as long as it
    lives), its memory and the capture's seconds."""
    graph: Any
    outputs: Any
    wrappers: kernels.Captured
    nodes: Dict[str, int]
    launches: Dict[str, int]
    holds: tuple
    memory: Dict[str, Any]
    seconds: float

    def replay(self) -> None:
        """One replay; the wrappers' counts advance by the capture's record."""
        self.graph.replay()
        kernels.add_replay(self.wrappers.launches, self.nodes)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in {id(t): t for t in tensors}.values())


def capture_graph(body, device: torch.device, pool, what: str, failed_at, static=(), holds=()) -> CapturedGraph:
    """Capture ``body()`` into a CUDA graph on ``device``'s side stream, into
    ``pool`` (None: a private one), inside ``kernels.capturing()`` (the
    wrappers' workspaces held, their launches recorded), and hold the
    recorded launches to the graph's kernel nodes. ``static``: the buffers
    the graph reads its inputs from; ``holds``: what else it reads (weights).
    Raises RuntimeError naming ``what`` and ``failed_at()`` (where the body
    was) when the capture fails, and when the graph launches other kernels
    than the wrappers counted: nothing falls back."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # its nodes are read below
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    shared = None if pool is None else tuple(pool)
    try:
        with kernels.capturing() as captured:
            with torch.cuda.graph(graph, pool=_POOL_AFTER_FAILURE.get(shared, pool), stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = body()
        graph.instantiate()
    except Exception as e:
        # an invalidated capture leaves its stream current, and its pool
        # marked as recording in the allocator (CUDAGraph.capture_end raises
        # before it ends either): the stream goes back, and later captures
        # into a shared pool go to a fresh one in its place
        torch.cuda.set_stream(current)
        if shared is not None:
            _POOL_AFTER_FAILURE[shared] = torch.cuda.graph_pool_handle()
        raise RuntimeError(f"CUDA graph capture of {what} failed {failed_at()}: {e}") from e
    outs = (outputs.values() if isinstance(outputs, dict) else
            outputs if isinstance(outputs, (tuple, list)) else [outputs])
    memory = {"pool_bytes": _pool_bytes(graph.pool()), "input_bytes": _nbytes(static),
              "output_bytes": _nbytes(outs), "workspace_bytes": _nbytes(captured.holds),
              "shared_pool": pool is not None}
    nodes = kernels.graph_kernels(graph)
    launches = kernels.held_to_graph(captured.launches, nodes)
    return CapturedGraph(graph, outputs, captured, nodes, launches, tuple(holds), memory, time.perf_counter() - t0)


def graph_launches(g: CapturedGraph) -> Dict[str, int]:
    """What one replay of ``g`` launches, read from its kernel nodes: per set
    of entry kernels, and ``"kernel_nodes"``, every kernel node."""
    return {**g.launches, "kernel_nodes": sum(g.nodes.values())}


def memory_analysis(g: CapturedGraph) -> Dict[str, Any]:
    """``g``'s memory (JAX ``Executor.memory_analysis``, the compiled
    program's buffers): the bytes of its memory pool (``pool_bytes``, the
    allocator's segments of that pool; a pool that graphs share counts
    everything in it), of its static inputs, its outputs and the kernel
    workspaces it holds, and the capture's seconds. The bytes are the
    allocator's, so a program that calls a vmapped segment function
    (``Executor.vmap_segment_fn``) shows its activations at the mapped
    size."""
    return {**g.memory, "capture_seconds": g.seconds}


@dataclasses.dataclass
class _Replay:
    """A captured segment: its graph (``capture_graph``: the outputs, the
    weights and their quantization vectors it reads, the wrappers' record)
    and, under pipeline stages, the boundary activations that change device:
    (the producer's tensor, the static buffer on this stage) pairs, copied
    before each replay."""
    captured: CapturedGraph
    hops: List[tuple]


def _pool_bytes(pool) -> int:
    """Bytes of the device memory segments of a CUDA-graph memory pool, from
    the allocator's snapshot."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class Executor:
    def __init__(self, plan: Plan, provider: WeightsProvider, graph_pool=None):
        self.plan = plan
        self.graph = plan.graph
        self.config = plan.config
        self.device = torch.device(self.config.device)
        self.provider = provider
        # under a mesh a sharded output is fetched from its gathered tensor
        self.mesh_info = plan.mesh_info
        alias = self.mesh_info.fetch_alias if self.mesh_info is not None else {}
        self._fetch = {name: alias.get(name, name) for name in plan.fetch_names}
        self.segments = build_segments(plan, list(self._fetch.values()))
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
        # per op here, not on every run. The sharding pass's gathers and
        # slices move data in its own dtype, whatever their names hold
        upcast = self.config.requires_upcast
        self._upcast = frozenset() if upcast is None else frozenset(
            i for i, op in enumerate(self.graph.ops)
            if upcast(op.op_type, op.name) and not get_impl(op.op_type).internal)
        self._arg_by_name = {w.name: w for w in plan.arg_weights}
        # calibration ranges recorded by run_eager (range_data_calibrate)
        self.range_data = RangeData()
        # under a mesh: the ops the sharding pass put in, and for each tensor
        # one of them made, the graph's tensor it holds all or part of
        self._pass_ops = self.mesh_info.pass_ops if self.mesh_info is not None else frozenset()
        self._origin: Dict[str, str] = {}
        # tensor name -> producing op name: a W8A8 op quantizes its input with
        # the producer's calibrated output range (JAX Executor._producer_op);
        # the graph's own names, looked up through the pass's ops
        self._producer_op: Dict[str, str] = {}
        for op in self.graph.ops:
            for t in op.outputs:
                if not t.name:
                    continue
                if op.name in self._pass_ops:
                    src = op.inputs[0].name
                    self._origin[t.name] = self._origin.get(src, src)
                else:
                    self._producer_op[t.name] = op.name
        # reference QDQ skip rule (src/onnxstream.cpp:3009-3020), on the
        # graph one device runs
        self._qdq_skip = set(self.mesh_info.qdq_skip if self.mesh_info is not None else qdq_skip(self.graph))
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
        # streamed runs: the two staging buffers, the two weight slots and
        # the raw buffer on the device, the copy stream, each staging
        # buffer's last copy and each slot's last reader (events)
        self._staging: List[Optional[torch.Tensor]] = [None, None]
        self._staging_free: List[Any] = [None, None]
        self._slots: List[Optional[torch.Tensor]] = [None, None]
        self._raw: Optional[torch.Tensor] = None
        self._slot_done: List[Any] = [None, None]
        self._copy_stream = None
        self.slot_offsets = self._slot_offsets()
        # per segment: activations read by a later segment, dropped after it
        self._drop_after = self._boundary_lifetimes()
        # plan constants on the other pipeline stages' devices (see _eval_op)
        self._stage_consts: Dict[str, Dict[int, list]] = {}
        provider.on_init(plan.stream_entries())
        self._first_run_done = False
        # captured segments: the pool their graphs allocate from (None: one
        # of the executor's own; Session.graph_pool shares one), the eager
        # warm-up run's config key, once captured a replay a segment, the
        # static buffers of the graph inputs and the key of the capture
        self.graph_pool = graph_pool
        self._warm_key: Optional[tuple] = None
        self._replays: Optional[List[_Replay]] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._replay_key: Optional[tuple] = None
        # the op being dispatched, named when a capture fails
        self._dispatching: Optional[int] = None
        # inside eager(): runs go op by op
        self._eager_only = False

    # ------------------------------------------------------------- weights
    def _maybe_force_quant(self, w: WeightArg, host: torch.Tensor) -> Optional[torch.Tensor]:
        """force_uint8_storage_set: quantize a float weight on the host at
        fetch time and return it (None for any other weight); its (scale,
        zero point) land on the WeightArg, vectors on the device (reference
        storage demotion, src/onnxstream.cpp:3764-3808; JAX
        ``Executor._maybe_force_quant``). ``host`` is the whole weight in its
        file layout; a sharded weight comes back as this rank's slice of the
        one-device quantization (see the module docstring)."""
        if (w.name not in self.config.force_uint8_storage_set or not w.file_dtype.is_float
                or host.dtype in (torch.uint8, torch.int8)):
            return None
        t0 = time.perf_counter()
        shard = tuple(w.shard or ())
        last = host.ndim - 1
        per_column = w.symmetric or (self.config.uint8_per_channel and host.ndim == 2)
        # a per-column scale over a slice of columns: the slice alone
        sliced = per_column and all(axis == last for axis, _, _ in shard)
        a32 = (_take_shard(host, shard) if sliced else host).float().numpy()
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
        q = torch.from_numpy(q)
        if shard and not sliced:
            q = _take_shard(q, shard)
            cols = [(start, stop) for axis, start, stop in shard if axis == last]
            if cols:
                quant = tuple(v[cols[0][0]:cols[0][1]] if isinstance(v, np.ndarray) else v for v in quant)
        self.quantize_seconds += time.perf_counter() - t0
        w.quant = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(self.device) if isinstance(v, np.ndarray)
                        else v for v in quant)
        return q

    def _synthesize(self, w: WeightArg, kind: str, device: Optional[torch.device] = None) -> torch.Tensor:
        """Generate w on the device in its upload dtype and shape (JAX
        ``_synth_generate``): one generator seeded from w's name
        (``synth_seed``). An s8 weight gets a flat per-channel scale on
        the file layout's last axis (JAX ``_stamp_s8_quant``). A weight
        sharded over a mesh is generated whole in its upload layout and this
        rank keeps its slice (and its scale's), so the shards equal the
        one-device weights."""
        dev = self.device if device is None else device
        gen = torch.Generator(device=dev)
        gen.manual_seed(synth_seed(w.name))
        shape, shard = _upload_layout(w)
        if kind == "s8":
            out = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            file_shape = w.file_shape or w.shape
            n, last = file_shape[-1], len(file_shape) - 1
            for axis, start, stop in w.shard or ():
                if axis == last:
                    n = stop - start
            w.quant = (torch.full((n,), SYNTH_SCALE / 127.0, dtype=torch.float32, device=dev), 0.0)
            w.symmetric = True
        elif kind == "u8":
            out = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        else:
            out = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).mul_(SYNTH_SCALE)
            out = out.to(w.upload_dtype)
        if w.transform == "ohwi":  # the memory layout the relayout gives
            out = out.contiguous(memory_format=torch.channels_last)
        if shard:
            out = _take_shard(out, shard).clone()
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
        if w.shard:
            # this rank's slice, then its relayout (in the memory format it
            # gives: channels-last for ohwi), copied: the provider keeps the
            # whole weight
            conv = _take_shard(host, w.shard) if q is None else q
            if w.transform:
                return WEIGHT_TRANSFORMS[w.transform](conv).to(w.upload_dtype, copy=True)
            return conv.to(w.upload_dtype, copy=True).contiguous()
        conv = host if q is None else q
        if w.transform:
            conv = WEIGHT_TRANSFORMS[w.transform](conv)
        if conv.dtype != w.upload_dtype:
            conv = conv.to(w.upload_dtype)
            self.host_conversions += 1
            if q is None and w.transform is None:
                self.provider.update(w.name, conv)
        return conv

    def _upload(self, w: WeightArg, device: Optional[torch.device] = None) -> torch.Tensor:
        """A synthesized weight (``synth_kind``) under
        synthetic_device_weights; otherwise ``_host_weight`` -> pinned ->
        device (resident weights and run_eager; streamed runs go through
        ``_SegmentFetch``)."""
        device = self.device if device is None else device
        kind = self._synth_kind(w)
        if kind is not None:
            return self._synthesize(w, kind, device)
        conv = self._host_weight(w)
        if device.type != "cuda":
            return conv.to(device)
        return conv.pin_memory().to(device, non_blocking=True)

    def _cache_slot(self, w: WeightArg, stage: int = 0):
        """(cache, key) holding w's resident device copy: with pipeline
        stages this executor's, per stage; else the shared cache for big
        weights when the config gives one, else this executor's."""
        if self.config.pp_devices:
            return self._resident, (stage, w.name)
        shared = self.config.shared_device_weight_cache
        # the whole weight's bytes decide, also for a rank's slice of it: the
        # graphs that share a weight then share its slice too
        whole = math.prod(w.file_shape or w.shape) * w.upload_dtype.itemsize
        if shared is not None and whole >= SHARED_CACHE_MIN_BYTES:
            return shared, (w.name, w.shape, str(w.upload_dtype), w.transform, w.shard)
        return self._resident, w.name

    # ------------------------------------------------------ pipeline stages
    def seg_stage(self, si: int) -> int:
        """Segment si's pipeline stage: contiguous blocks (stage = si *
        stages // segments), so a linear graph's boundary activations change
        stage stages - 1 times (JAX ``_seg_device``). Stage identity is the
        index: two stages may share one device."""
        pp = self.config.pp_devices
        return min(si * len(pp) // len(self.segments), len(pp) - 1) if pp else 0

    def seg_device(self, si: int) -> torch.device:
        pp = self.config.pp_devices
        return torch.device(pp[self.seg_stage(si)]) if pp else self.device

    def _stage_copy(self, w: WeightArg, stage: int):
        """A weight a segment of another stage holds already (a tied
        weight): copied device to device, as the provider may have released
        its host copy (JAX executor.py:505-515)."""
        for (s, name), hit in self._resident.items():
            if name == w.name and s != stage:
                dev, quant, symmetric = hit
                return dev.to(torch.device(self.config.pp_devices[stage]), copy=True), quant, symmetric
        return None

    def _fetch_segment_weights(self, seg: Segment, si: int = 0) -> Dict[str, torch.Tensor]:
        resident = self.config.hbm_budget_bytes == 0 or bool(self.config.pp_devices)
        stage, device = self.seg_stage(si), self.seg_device(si)
        out: Dict[str, torch.Tensor] = {}
        for w in seg.weight_args:
            cache, key = self._cache_slot(w, stage)
            hit = cache.get(key)
            if hit is None and self.config.pp_devices:
                hit = self._stage_copy(w, stage)
                if hit is not None:
                    cache[key] = hit
            if hit is None:
                dev = self._upload(w, device)
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
        included, every stage's copy) and their per-channel scales and zero
        points, for counting device memory across sessions."""
        out = []
        stages = range(len(self.config.pp_devices)) if self.config.pp_devices else (0,)
        for w in self.plan.arg_weights:
            for stage in stages:
                cache, key = self._cache_slot(w, stage)
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
        tname = self._origin.get(tname, tname)
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
                      weights_env: Dict[str, Any], device: torch.device) -> torch.Tensor:
        w = self._arg_by_name[op.inputs[1].name]
        aname = op.inputs[0].name
        a = self.plan.static_env.get(aname, env.get(aname))
        if not isinstance(a, torch.Tensor):
            a = self._ctx(op.name, device).tensor(a)
        cdt = self.config.torch_compute_dtype
        if a.is_floating_point() and a.dtype != cdt:
            a = a.to(cdt)
        scale, zero = w.quant
        if route == "w8a8_dyn_matmul":
            # the planner uploads the weight as (N, K) where kernel 6's K-major forms take it
            return w8a8_dyn_matmul(a, weights_env[w.name], scale, out_dtype=cdt, weight_nk=w.transform == "tnk")
        return w8_matmul(a, weights_env[w.name], scale, zero, out_dtype=cdt)

    def _eval_qlinear(self, mode: str, op: OpNode, env: Dict[str, Any],
                      weights_env: Dict[str, Any], device: torch.device) -> torch.Tensor:
        """Quantize the input activation, run kernel 3 (integer products,
        zero-point corrections and dequantization in one launch) and return
        the float result in the compute dtype. Requantizing the output to the
        op's range is left to the QDQ stage (JAX ``_eval_qlinear``)."""
        cdt = self.config.torch_compute_dtype
        ctx = self._ctx(op.name, device)
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

    def _qdq_range(self, op: OpNode, name: str, x: torch.Tensor):
        """(scale, zero) for the QDQ of a pushed tensor: XNNPACK's fixed qu8
        softmax quantization (1/256, 0; reference src/onnxstream.cpp:5862), a
        calibrated range, or the reference's 0.1% percentiles estimated on
        the device from a strided subsample of at most 2^20 values (JAX
        ``_qdq_range``): under a mesh that of the whole tensor, of which x
        is this rank's block (``_global_sample``)."""
        if op.op_type == "Softmax":
            return 1.0 / 256.0, 0.0
        if op.name in self.config.range_data:
            return range_to_scale(*self.config.range_data[op.name])
        if self.mesh_info is not None and self.mesh_info.placements.get(name):
            xs, n = self._global_sample(name, x)
        else:
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

    def _global_sample(self, name: str, x: torch.Tensor):
        """The sorted strided subsample that one device takes of the whole
        tensor ``name`` (``xf[::n // 2^20]`` over its flattening) and its
        size, from this rank's block x: each rank keeps the elements of its
        block whose global flat index is a multiple of the stride, padded
        with NaN to one length (a bound every rank computes alike), and
        gathers them over the mesh dims that shard the tensor. NaN sorts
        last, so the first n sorted values are one device's sample sorted."""
        info = self.mesh_info
        shape = info.whole_shape(name)
        n = math.prod(shape)
        stride = n // (1 << 20) if n > (1 << 20) else 1
        m = -(-n // stride)
        xf = x.float()
        if stride > 1:
            flat = torch.zeros((), dtype=torch.int64, device=x.device)
            step = 1
            starts = {axis: start for axis, start, _ in info.slices(name)}
            for axis in reversed(range(len(shape))):
                idx = torch.arange(x.shape[axis], dtype=torch.int64, device=x.device) + starts.get(axis, 0)
                view = [1] * len(shape)
                view[axis] = -1
                flat = flat + (idx * step % stride).view(view)
                step *= shape[axis]
            xf = xf[flat % stride == 0]
        xf = xf.reshape(-1)
        # the sampled elements of a block: a multiple of the stride in each
        # of its contiguous runs of the whole tensor's flattening
        last = max(info.placements[name])
        run = math.prod(x.shape[last:])
        bound = min(m, x.numel() // run * -(-run // stride))
        pad = torch.full((bound,), float("nan"), dtype=torch.float32, device=x.device)
        pad[:xf.numel()] = xf
        for dim in sorted(set(info.placements[name].values())):
            pad = comm.all_gather(pad, 0, self.config.mesh.get_group(dim), dim)
        return torch.sort(pad).values, m

    def _percentiles(self, name: str, t: torch.Tensor) -> tuple:
        """``percentiles`` of the whole tensor ``name``; under a mesh t is
        this rank's block of it. The k-th smallest of the whole lies among
        each block's k + 1 smallest finite values (and the k-th largest among
        its k + 1 largest), so each rank gathers its count and those values,
        padded with infinities to one length, over the mesh dims that shard
        the tensor, not its block: the same order statistics."""
        pmap = self.mesh_info.placements.get(name) if self.mesh_info is not None else None
        if not pmap:
            return percentiles(t)
        dims = sorted(set(pmap.values()))

        def gather(v: torch.Tensor) -> torch.Tensor:
            for dim in dims:
                v = comm.all_gather(v, 0, self.config.mesh.get_group(dim), dim)
            return v

        flat = t.detach().float().reshape(-1)
        finite = torch.sort(flat[torch.isfinite(flat)]).values
        n = int(gather(torch.tensor([finite.numel()], dtype=torch.int64, device=t.device)).sum())
        if n == 0:
            return 0.0, 0.0
        m = int(n * 0.001) + 1
        ends = torch.cat([torch.full((m,), float("inf"), device=t.device),
                          torch.full((m,), float("-inf"), device=t.device)])
        c = min(m, finite.numel())
        ends[:c] = finite[:c]
        ends[m:m + c] = finite[finite.numel() - c:]
        ends = gather(ends).view(-1, 2, m)
        lo = torch.sort(ends[:, 0].reshape(-1)).values[m - 1]
        hi = torch.sort(ends[:, 1].reshape(-1), descending=True).values[m - 1]
        return min(float(lo), float(hi)), max(float(lo), float(hi))

    def _maybe_qdq(self, op: OpNode, outs: List[Any]) -> List[Any]:
        """use_uint8_qdq: quantize-dequantize each pushed float intermediate
        (reference push_tensor, src/onnxstream.cpp:3022-3034). Single-use
        tensors consumed by the immediately following op are skipped, as in
        the reference (3009-3020); fetched outputs are never degraded; the
        sharding pass's ops are not the graph's and push nothing."""
        if not self.config.use_uint8_qdq or op.name in self._pass_ops:
            return outs
        fetched = set(self.plan.fetch_names)
        res = []
        for spec, o in zip(op.outputs, outs):
            if (spec.name and spec.name not in self._qdq_skip and spec.name not in fetched
                    and isinstance(o, torch.Tensor) and o.is_floating_point()):
                scale, zero = self._qdq_range(op, spec.name, o)
                # a tensor divisor keeps the division IEEE on the card
                s = scale if isinstance(scale, torch.Tensor) else torch.full(
                    (), scale, dtype=torch.float32, device=o.device)
                q = (torch.round(o.float() / s) + zero).clamp(0, 255).to(torch.uint8)
                o = ((q.float() - zero) * s).to(o.dtype)
            res.append(o)
        return res

    def _ctx(self, op_name: str, device: torch.device) -> Ctx:
        """The context of a device op: plan constants cross once per device
        (a pipeline stage on another device keeps its own copies)."""
        consts = self._consts if device == self.device else self._stage_consts.setdefault(str(device), {
            k: [v[0], None] for k, v in self._consts.items() if isinstance(k, int)})
        return Ctx("device", self.config, op_name, device=device, consts=consts)

    def _eval_op(self, oi: int, op: OpNode, env: Dict[str, Any], weights_env: Dict[str, Any],
                 device: Optional[torch.device] = None):
        device = self.device if device is None else device
        qmode = self._qlinear.get(oi)
        if qmode is not None:
            return [self._eval_qlinear(qmode, op, env, weights_env, device)]
        route = self._qroute.get(oi)
        if route is not None:
            return [self._eval_qmatmul(route, op, env, weights_env, device)]
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
        outs = get_impl(op.op_type).fn(self._ctx(op.name, device), op, ins)
        if upcast:
            cdt = self.config.torch_compute_dtype
            outs = [o.to(cdt) if isinstance(o, torch.Tensor) and o.is_floating_point() else o
                    for o in outs]
        return outs

    def _run_segment(self, seg: Segment, weights: Dict[str, torch.Tensor],
                     env: Dict[str, torch.Tensor],
                     nxt: Optional[_SegmentFetch] = None,
                     device: Optional[torch.device] = None,
                     also: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
        """Dispatch seg's ops. With ``nxt`` (a streamed run), the next
        segment's weights are fetched between the ops, spread evenly, the
        last of them before seg's last op; seg's weights are released once
        its last op is enqueued. ``also``: tensors returned beside the
        segment's outputs (kept past their last reader)."""
        keep = set(seg.out_names) | set(also)
        n = len(seg.op_indices)
        for j, oi in enumerate(seg.op_indices):
            if nxt is not None:
                nxt.advance(len(nxt.args) if n == 1 else -(-j * len(nxt.args) // (n - 1)))
            op = self.graph.ops[oi]
            self._dispatching = oi
            outs = self._eval_op(oi, op, env, weights, device)
            for spec, val in zip(op.outputs, self._maybe_qdq(op, outs)):
                if spec.name:
                    env[spec.name] = val
            for t in op.inputs:
                if t.name and not t.is_weight and self._last_use.get(t.name) == oi and t.name not in keep:
                    env.pop(t.name, None)
        self._dispatching = None
        weights.clear()
        return {n: env[n] for n in keep}

    def segment_fn(self, si: int = 0, also: Sequence[str] = ()):
        """Segment si as a function (JAX ``Executor._segment_fn``):
        ``fn(weights, acts) -> {output: tensor}``, weights in the segment's
        ``weight_args`` order (a single-segment plan's ``plan.arg_weights``;
        a rank's slices under a mesh) in their upload dtypes, acts the graph
        inputs (segment 0; sliced to this rank's share under a mesh) or the
        segment's boundary inputs. The outputs are the graph's fetched
        outputs that the segment makes, gathered under a mesh, and the
        tensors named in ``also`` as this rank holds them. The ops run as
        ``run`` dispatches them, under ``reference_precision``; a caller
        that differentiates the result runs the backward under it too."""
        seg = self.segments[si]
        args = seg.weight_args
        fetched = {name: f for name, f in self._fetch.items() if f in seg.out_names}

        def fn(weights: Sequence[torch.Tensor], acts: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            if len(weights) != len(args):
                raise ValueError(f"segment {si} takes {len(args)} weights, got {len(weights)}")
            with reference_precision():
                if si == 0:
                    env = self._prepare_inputs(acts)
                else:
                    env = {n: to_torch(acts[n]).to(self.seg_device(si)) for n in seg.in_names}
                # _run_segment clears the weight dict it is given
                out = self._run_segment(seg, {w.name: t for w, t in zip(args, weights)}, env, also=also)
            return {**{name: out[f] for name, f in fetched.items()}, **{n: out[n] for n in also}}

        return fn

    def vmap_segment_fn(self, in_dims: Dict[str, int], si: int = 0, also: Sequence[str] = ()):
        """``segment_fn(si)`` under ``torch.func.vmap``, the counterpart of
        ``jax.vmap`` over JAX's ``_segment_fn``: ``fn(weights, acts) ->
        {output: tensor}``, each output stacked along dim 0. ``in_dims``
        maps the mapped inputs to their mapped dim; every other input is
        closed over (the same for each example), as the weights always are.
        An example is what ``segment_fn`` takes. The ops' batching rules run,
        the kernel wrappers' among them (the mapped axis folded into the
        kernel's batch: one launch a site); functorch's per-example fallback
        is an error for the call's duration (``kernels.no_vmap_fallback``),
        so an op without a rule raises and names itself, and nothing loops
        per example. Under ``use_uint8_qdq`` a range taken from the data is
        each example's own, as under JAX's vmap. ``hbm_accounting(mapped=,
        size=)`` estimates such a call's device memory."""
        fn = self.segment_fn(si, also)
        names = tuple(n for n, d in in_dims.items() if d is not None)
        inputs = self.plan.input_avals if si == 0 else self.segments[si].in_names
        unknown = [n for n in names if n not in inputs]
        if unknown or not names:
            raise ValueError(f"vmap_segment_fn: segment {si} maps inputs of its own, got {unknown or 'none'}")
        dims = tuple(in_dims[n] for n in names)

        def vfn(weights: Sequence[torch.Tensor], acts: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            fixed = {n: v for n, v in acts.items() if n not in names}

            def example(*mapped):
                return fn(weights, {**fixed, **dict(zip(names, mapped))})

            mapped = [to_torch(acts[n]) for n in names]
            with kernels.no_vmap_fallback():
                return torch.func.vmap(example, in_dims=dims)(*mapped)

        return vfn

    def _mapped_names(self, inputs: Sequence[str]) -> set:
        """The tensors that depend on the given inputs: each op's outputs
        where one of its activation inputs does."""
        mapped = set(inputs)
        for op in self.graph.ops:
            if any(t.name in mapped for t in op.inputs if t.name and not t.is_weight):
                mapped.update(t.name for t in op.outputs if t.name)
        return mapped

    # ------------------------------------------------------------------ runs
    def _prepare_inputs(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Inputs on the device in their plan dtypes; under a mesh this
        rank's slice of each (a ``LocalShard`` of the local shape is taken as
        it is). With pipeline stages they go to the first stage's device."""
        device = self.seg_device(0) if self.segments else self.device
        prepared = {}
        for k, aval in self.plan.input_avals.items():
            if k not in inputs:
                raise KeyError(f"missing graph input {k!r}")
            v = inputs[k]
            if self.mesh_info is not None:
                v = self._local_input(k, v, tuple(aval.shape))
            prepared[k] = to_torch(v).to(device, aval.dtype)
        return prepared

    def _local_input(self, name: str, v, local: tuple):
        """This rank's slice of a graph input: a pushed ``LocalShard``
        already is one (or holds the whole tensor, then sliced); a whole
        array or tensor is sliced here, before it is copied to the device."""
        v = getattr(v, "tensor", v)
        if tuple(v.shape) == local:
            return v
        if tuple(v.shape) != self.mesh_info.input_shapes[name]:
            raise ValueError(f"input {name!r}: shape {tuple(v.shape)} is neither this rank's {local} nor the "
                             f"whole {self.mesh_info.input_shapes[name]}")
        if isinstance(v, np.ndarray):
            for axis, start, stop in self.mesh_info.slices(name):
                v = np.take(v, np.arange(start, stop), axis=axis)
            return v
        return _take_shard(v, self.mesh_info.slices(name))

    def _outputs(self, results: Dict[str, Any], device_outputs: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, fetched in self._fetch.items():
            if fetched in results:
                v = results[fetched]
            elif name in self.plan.static_env:
                v = self.plan.static_env[name]
            else:
                v = self.plan.static_weights[name]
            out[name] = v if device_outputs else _to_host(v)
        return out

    @property
    def streamed(self) -> bool:
        """Weights streamed a segment at a time (pipeline stages keep theirs
        resident)."""
        return self.config.hbm_budget_bytes > 0 and not self.config.pp_devices

    def _boundary_lifetimes(self) -> List[set]:
        """Per segment, the boundary activations it reads last: a run drops
        them once it has run (fetched outputs excepted)."""
        last: Dict[str, int] = {}
        for si, seg in enumerate(self.segments):
            for n in seg.in_names:
                last[n] = si
        fetched = set(self._fetch.values())
        drop: List[set] = [set() for _ in self.segments]
        for n, si in last.items():
            if n not in fetched and n not in self.plan.input_avals:
                drop[si].add(n)
        return drop

    def _slot_offsets(self) -> List[Dict[str, int]]:
        """Per segment, each weight's byte offset in its slot (slot si % 2):
        the segment's weights in ``weight_args`` order, each starting on
        ``STAGING_ALIGN``; the same on every run."""
        plans = []
        for seg in self.segments:
            offsets, end = {}, 0
            for w in seg.weight_args:
                offsets[w.name] = end
                end += _aligned(upload_bytes(w))
            plans.append(offsets)
        return plans

    def slot_view(self, si: int, w: WeightArg) -> torch.Tensor:
        """Segment si's weight w in its slot: a fresh view in w's upload
        dtype, shape and layout at the plan's offset (``slot_offsets``)."""
        off = self.slot_offsets[si][w.name]
        raw = self._slots[si % 2][off:off + upload_bytes(w)]
        return raw.view(w.upload_dtype).as_strided(w.shape, _upload_strides(w))

    def _start_streaming(self) -> None:
        """The copy stream (CUDA), the two staging buffers, each as large as
        the largest segment's staged weights (pinned on CUDA), and on the
        device the two weight slots, each as large as the largest segment's
        upload bytes, and the raw buffer of the largest weight converted on
        the card."""
        if self._staging[0] is not None:
            return
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        real = [[w for w in seg.weight_args if self._synth_kind(w) is None] for seg in self.segments]
        size = max((sum(self._staged_bytes(w) for w in ws) for ws in real), default=0)
        pin = self.device.type == "cuda"
        self._staging = [torch.empty(max(size, 1), dtype=torch.uint8, pin_memory=pin) for _ in range(2)]
        slot = max((sum(_aligned(upload_bytes(w)) for w in seg.weight_args) for seg in self.segments), default=0)
        self._slots = [torch.empty(max(slot, 1), dtype=torch.uint8, device=self.device) for _ in range(2)]
        raw = max((_file_bytes(w) for ws in real for w in ws
                   if self._crosses_as_file_bytes(w) and w.file_dtype.torch != w.upload_dtype), default=0)
        self._raw = torch.empty(max(raw, 1), dtype=torch.uint8, device=self.device)

    def _crosses_as_file_bytes(self, w: WeightArg) -> bool:
        """Whether a streamed run copies w's file bytes to the card as they
        are (converted there when the dtypes differ) rather than a tensor
        prepared on the host (``_host_weight``; a rank's slice of a sharded
        weight is cut there, and only the slice crosses)."""
        return (w.transform is None and not w.shard and w.name not in self.config.force_uint8_storage_set
                and (w.file_dtype.torch == w.upload_dtype or not self.provider.keeps_updates))

    def _staged_bytes(self, w: WeightArg) -> int:
        """w's part of a staging buffer: the bytes that cross, its file bytes
        (``_crosses_as_file_bytes``) or its upload bytes, aligned; under a
        mesh this rank's slice of them."""
        return _aligned(_file_bytes(w) if self._crosses_as_file_bytes(w) else upload_bytes(w))

    def _segment_env(self, si: int, acts, results) -> Dict[str, Any]:
        env = {n: (acts[n] if n in acts else results[n]) for n in self.segments[si].in_names}
        # all graph inputs flow through the first segment's env too
        return {**acts, **env} if si == 0 else env

    def run(self, inputs: Dict[str, Any], device_outputs: bool = False) -> Dict[str, Any]:
        """Segmented run, double-buffered when streamed (see the module
        docstring); from the second run on, each segment's graph captured
        and replayed where ``capture_problem`` finds nothing in the way.
        Returns float outputs as float32 numpy and integers as int64 numpy;
        with ``device_outputs`` the device tensors in their compute dtypes,
        fresh copies when replayed (outputs folded on the host stay
        numpy)."""
        if self._first_run_done:
            self.provider.on_restart()
        key = self._dispatch_key()
        if self._replays is not None and self._replay_key != key:
            self.reset_graph()  # captured under other options: warm up again
        with reference_precision():
            acts = self._prepare_inputs(inputs)
            results: Dict[str, torch.Tensor] = {}
            if not self._eager_only and (
                    self._replays is not None or (self._warm_key == key and capture_problem(self) is None)):
                results = self._run_captured(acts, key)
                if device_outputs:
                    results = {n: t.clone() for n, t in results.items()}
            else:
                results = self._run_segments(acts)
            out = self._outputs(results, device_outputs)
        self._first_run_done = True
        self._warm_key = key
        return out

    # ------------------------------------------------------ captured segments
    def _dispatch_key(self) -> tuple:
        """The config's scalar fields: ops read some of them at dispatch
        time (``use_flash_attention``), so a graph is replayed only under the
        values it was captured with."""
        return tuple((f.name, v) for f in dataclasses.fields(self.config)
                     if isinstance(v := getattr(self.config, f.name), _SCALARS))

    def _segment_done(self, si: int) -> None:
        """Segment si is enqueued on the compute stream: its end event
        guards its slot (``_SegmentFetch``) until the device has run it."""
        if self._copy_stream is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._slot_done[si % 2] = done

    def _run_segments(self, acts: Dict[str, Any], graphs: Optional[List[_Replay]] = None,
                      pool=None) -> Dict[str, torch.Tensor]:
        """Every segment in order, op by op (``graphs`` None) or through its
        graph, captured into ``pool`` first where ``graphs`` has none for it
        yet; the outputs the later segments and the caller read. A streamed
        run fetches segment k+1's weights into its slot while segment k
        runs: spread over k's ops op by op, whole once k's graph is
        enqueued. Under pipeline stages a boundary activation hops onto its
        reader's stage. An activation past its last reader is dropped (from
        its producer's graph outputs too: a later capture of the pool may
        take its memory)."""
        streamed = self.streamed and bool(self.segments)
        if streamed:
            self._start_streaming()
            fetch = _SegmentFetch(self, 0)
        results: Dict[str, torch.Tensor] = {}
        try:
            for si, seg in enumerate(self.segments):
                weights = fetch.take() if streamed else self._fetch_segment_weights(seg, si)
                nxt = _SegmentFetch(self, si + 1) if streamed and si + 1 < len(self.segments) else None
                if graphs is None:
                    env = self._segment_env(si, acts, results)
                    device = self.seg_device(si) if self.config.pp_devices else None
                    if device is not None:
                        env = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in env.items()}
                    results.update(self._run_segment(seg, weights, env, nxt, device))
                else:
                    # a replayed graph reads its inputs where they lay at its
                    # capture: only a capture takes them from the results
                    if len(graphs) == si:
                        graphs.append(self._capture(si, weights, self._segment_env(si, acts, results), pool))
                    for src, buf in graphs[si].hops:
                        buf.copy_(src)
                    with torch.cuda.device(self.seg_device(si)):
                        graphs[si].captured.replay()
                    if nxt is not None:
                        nxt.advance(len(nxt.args))
                    results.update(graphs[si].captured.outputs)
                self._segment_done(si)
                for name in self._drop_after[si]:
                    results.pop(name, None)
                    for rep in graphs or ():
                        rep.captured.outputs.pop(name, None)
                fetch = nxt
        except BaseException:
            # a fetch cut short may leave copies in flight from a staging
            # buffer whose free event was never recorded
            if self._copy_stream is not None:
                self._copy_stream.synchronize()
            raise
        return results

    def _run_captured(self, acts: Dict[str, torch.Tensor], key: tuple) -> Dict[str, torch.Tensor]:
        """The fetched outputs from a replay of every segment's graph
        (``_run_segments``), each captured first on the run that has none,
        over static copies of the graph inputs; they live in the graphs'
        pool until the next replay."""
        if self._replays is not None:
            for name, buf in self._static.items():
                buf.copy_(acts[name])
            return self._run_segments(self._static, self._replays)
        self._static = {name: t.clone() for name, t in acts.items()}
        graphs: List[_Replay] = []
        pool = self.graph_pool if self.graph_pool is not None else torch.cuda.graph_pool_handle()
        results = self._run_segments(self._static, graphs, pool)
        self._replays, self._replay_key = graphs, key
        return results

    def dispatch_site(self) -> Optional[str]:
        """The op a segment dispatch is at (a capture that failed names it),
        or None between dispatches."""
        oi = self._dispatching
        return None if oi is None else f"at op #{oi} {self.graph.ops[oi].op_type} ({self.graph.ops[oi].name})"

    def _capture(self, si: int, weights: Dict[str, torch.Tensor], env: Dict[str, Any], pool) -> _Replay:
        """Capture segment si's ops into a CUDA graph (``capture_graph``) on
        its device, into ``pool``, under the precision flags the warm-up ran
        with, over ``weights`` and ``env`` (the static graph inputs and the
        earlier graphs' outputs, read where they lie; under pipeline stages
        one that lies on another device is copied into a static buffer
        here). Raises, naming the segment and the op that was dispatching,
        when the capture fails, and when the graph launches other kernels
        than the wrappers counted."""
        seg = self.segments[si]
        device = self.seg_device(si)
        hops = []
        if self.config.pp_devices:
            for name, v in env.items():
                if isinstance(v, torch.Tensor) and (moved := v.to(device)) is not v:
                    hops.append((v, moved))
                    env[name] = moved
        stage = device if self.config.pp_devices else None

        def body():
            return self._run_segment(seg, dict(weights), dict(env), device=stage)

        self._dispatching = None
        captured = capture_graph(body, device, pool, f"segment {si}",
                                 lambda: self.dispatch_site() or "at the end of the capture",
                                 static=[*(self._static.values() if si == 0 else ()), *(b for _, b in hops)],
                                 holds=(weights, [w.quant for w in seg.weight_args], [src for src, _ in hops]))
        captured.memory["shared_pool"] = self.graph_pool is not None  # else the executor's own
        return _Replay(captured, hops)

    @property
    def captured(self) -> bool:
        """Whether ``run`` replays captured graphs."""
        return self._replays is not None

    def graph_launches(self, si: Optional[int] = None) -> Optional[Dict[str, int]]:
        """What one replay of segment si's graph launches (every segment's,
        summed, with si None: a run's), read from the kernel nodes: per set
        of entry kernels (``kernels.held_to_graph``), and
        ``"kernel_nodes"``, every kernel node; None before the capture."""
        if self._replays is None:
            return None
        if si is not None:
            return graph_launches(self._replays[si].captured)
        total: Dict[str, int] = {}
        for rep in self._replays:
            for k, n in graph_launches(rep.captured).items():
                total[k] = total.get(k, 0) + n
        return total

    def reset_graph(self) -> None:
        """Drop the captured graphs: the next run warms up op by op and the
        one after captures again."""
        self._replays, self._warm_key, self._replay_key, self._static = None, None, None, {}

    @contextlib.contextmanager
    def eager(self):
        """Runs inside go op by op, as a first run does (a reference for
        the replays): the captured graphs, their weights, static buffers
        and pool are left as they were, and replay again after."""
        self._eager_only = True
        try:
            yield
        finally:
            self._eager_only = False

    def memory_analysis(self, si: int = 0) -> Optional[Dict[str, Any]]:
        """Segment si's captured graph (JAX ``Executor.memory_analysis``, a
        compiled segment's buffers): the bytes of its memory pool
        (``pool_bytes``, the allocator's segments of that pool at its
        capture; the pool is every segment's, and sessions may share it),
        of its static inputs, its outputs and the kernel workspaces it
        holds, and the capture's seconds; None before the capture."""
        if self._replays is None:
            return None
        return memory_analysis(self._replays[si].captured)

    def graph_memory(self) -> Optional[Dict[str, Any]]:
        """The captured graphs' device memory: their pool (``pool``, its id;
        ``pool_bytes``, its size once every segment was captured) and every
        graph's static inputs (``input_bytes``); None before the capture."""
        if self._replays is None:
            return None
        caps = [rep.captured for rep in self._replays]
        return {"pool": tuple(caps[-1].graph.pool()), "pool_bytes": max(c.memory["pool_bytes"] for c in caps),
                "input_bytes": sum(c.memory["input_bytes"] for c in caps)}

    def _activation_peaks(self, mapped: Sequence[str] = (), size: int = 1) -> List[int]:
        """Per segment, the most bytes of activations alive at once while
        it runs, from the plan's shapes and dtypes: the graph inputs, the
        boundary activations held for later segments, and the segment's own
        intermediates from their op until their last reader (both an op's
        inputs and its outputs count at that op). Scratch inside an op is
        not counted. A tensor that depends on one of the ``mapped`` inputs
        counts ``size`` times (a call of ``vmap_segment_fn`` over them)."""
        avals, ins = self.plan.avals, self.plan.input_avals
        mapped = self._mapped_names(mapped)

        def nbytes(name: str) -> int:
            a = avals.get(name) or ins.get(name)
            n = math.prod(a.shape) * a.dtype.itemsize if a is not None else 0
            return n * size if name in mapped else n

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

    def hbm_accounting(self, mapped: Sequence[str] = (), size: int = 1) -> Dict[str, Any]:
        """Device-memory estimate of a run (JAX ``Executor.hbm_accounting``):
        per segment its weight bytes and its activation peak
        (``_activation_peaks``, plus the transient copies of ``_cast_peaks``);
        ``peak_bytes`` is one segment's weights and activations when
        resident, and max_k (activations_k + weights_k + weights_k+1 +
        converted_k+1) when streamed, the double buffer holding segment k+1's
        weights while segment k runs, converted_k+1 the file bytes of the
        largest of them converted on the card (alive until its conversion).
        Under a mesh every byte is this rank's: its slices of the sharded
        weights and its blocks of the activations (the plan's local
        shapes), so the streamed bound is per rank. With ``mapped`` and
        ``size``: a call of ``vmap_segment_fn`` over those inputs at that map
        size, its activations that depend on them counted ``size`` times."""
        wb = [seg.weight_bytes for seg in self.segments]
        act = [a + c for a, c in zip(self._activation_peaks(mapped, size), self._cast_peaks())]
        conv = [max((_file_bytes(w) for w in seg.weight_args if self._synth_kind(w) is None
                     and self._crosses_as_file_bytes(w) and w.file_dtype.torch != w.upload_dtype), default=0)
                for seg in self.segments]
        nxt = [w + c for w, c in zip(wb[1:], conv[1:])] + [0] if self.streamed else [0] * len(wb)
        out = {"mode": "streamed" if self.streamed else "resident", "segments": len(wb),
               "weight_bytes": sum(wb), "segment_weight_bytes": wb, "segment_activation_bytes": act,
               "peak_bytes": max((a + w + n for a, w, n in zip(act, wb, nxt)), default=0)}
        if self.config.pp_devices:
            # every stage holds its segments' weights (a tied weight once a
            # stage) while one segment's activations are alive
            stages = len(self.config.pp_devices)
            names = [dict() for _ in range(stages)]
            for si, seg in enumerate(self.segments):
                names[self.seg_stage(si)].update({w.name: upload_bytes(w) for w in seg.weight_args})
            sw = [sum(n.values()) for n in names]
            out.update(mode="pipeline", stage_weight_bytes=sw,
                       peak_bytes=max((a + sw[self.seg_stage(si)] for si, a in enumerate(act)), default=0))
        graph = self.graph_memory()
        if graph is not None:
            # the captured graphs' pool, once, and their static input buffers, beside the estimate
            out["graph_bytes"] = graph["pool_bytes"] + graph["input_bytes"]
        if self.mesh_info is not None:
            # this rank's bytes: the replicated weights whole, the sharded
            # ones as the slices it holds, beside what one device would hold
            sharded = sum(upload_bytes(w) for w in self.plan.arg_weights if w.shard)
            out.update(replicated_weight_bytes=self.weight_bytes() - sharded, sharded_weight_bytes=sharded,
                       one_device_weight_bytes=self.mesh_info.global_weight_bytes)
        return out

    def run_eager(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Per-op interpreter over every device op with all weights fetched
        up front: ops_printf / ops_times_printf, range calibration
        (reference src/onnxstream.cpp:2983-3004), and the oracle for run().
        Under a mesh calibration records the whole tensors' ranges
        (``_percentiles``) under the graph's own op and input names, the
        same on every rank."""
        if self._first_run_done:
            self.provider.on_restart()
        timed = self.config.ops_times_printf
        calibrate = self.config.range_data_calibrate
        fetched = set(self._fetch.values())
        with reference_precision():
            env: Dict[str, Any] = self._prepare_inputs(inputs)
            if calibrate:
                # graph-input ranges under the tensor name: W8A8 ops whose
                # input has no producer quantize with this range
                for k, v in env.items():
                    if v.is_floating_point():
                        self.range_data.update(k, *self._percentiles(k, v))
            weights_env = {w.name: self._upload(w) for w in self.plan.arg_weights}
            for oi, op in enumerate(self.graph.ops):
                if self.plan.op_modes[oi] != "device":
                    continue
                if self.config.ops_printf:
                    print(f"#{oi}) {op.op_type} ({op.name})")
                t0 = time.perf_counter() if timed else 0.0
                outs = self._eval_op(oi, op, env, weights_env)
                if calibrate and op.name not in self._pass_ops:
                    # calibration observes pre-QDQ values (reference
                    # push_tensor records ranges before conversion)
                    for spec, o in zip(op.outputs, outs):
                        if isinstance(o, torch.Tensor) and o.is_floating_point():
                            self.range_data.update(op.name, *self._percentiles(spec.name, o))
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

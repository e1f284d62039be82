"""Percentile-based asymmetric uint8 and symmetric int8 weight quantization.

Counterpart of ``onnxstream_tpu/runtime/quantization.py``: the same numpy
code, carried here so the port needs nothing of the JAX package. Its outputs
equal the JAX package's bit for bit (``tests/test_torch_qmatmul.py``).

Reproduces the reference's quantization math exactly:

  * percentile range estimation — the reference sorts float bit patterns to
    find the 0.1% tails per chunk (FloatAsUInt::get_percentiles,
    src/onnxstream.cpp:2223-2386). numpy's partition gives the same result
    directly on the host.
  * range_to_scale — forces the range to include zero and derives
    (scale, zero_point) (src/onnxstream.cpp:3234-3245);
  * quantize/dequantize — asymmetric uint8 (src/onnxstream.cpp:3247, 3353);
  * calibration persistence — range_data.txt CSV, one `op_name,min,max` per
    line (read_range_data/write_range_data, src/onnxstream.cpp:3436-3479);
  * the QDQ skip rule — which activations QDQ leaves alone
    (src/onnxstream.cpp:3009-3020).

The per-channel forms quantize each column on its own, so a large weight is
cut into column blocks quantized on the host's cores at once
(``_by_columns``): the same bits as one pass.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np

PARALLEL_MIN_ELEMENTS = 1 << 20  # a per-channel weight this large is quantized in column blocks
_POOL: Optional[ThreadPoolExecutor] = None


def _by_columns(fn: Callable[[np.ndarray], tuple], a: np.ndarray) -> tuple:
    """``fn`` of a 2-D weight whose outputs are per column ((K, N) arrays
    and (N,) vectors), computed over blocks of its columns on the host's
    cores (numpy releases the GIL in its loops) and joined: the same bits as
    ``fn(a)``."""
    global _POOL
    workers = os.cpu_count() or 1
    if a.size < PARALLEL_MIN_ELEMENTS or workers == 1:
        return fn(a)
    if _POOL is None:
        _POOL = ThreadPoolExecutor(workers, thread_name_prefix="quantize")
    step = -(-a.shape[1] // workers)
    parts = list(_POOL.map(lambda j: fn(a[:, j:j + step]), range(0, a.shape[1], step)))
    return tuple(np.concatenate([p[i] for p in parts], axis=-1) for i in range(len(parts[0])))


def get_percentiles(arr: np.ndarray, from_left: float = 0.001, from_right: float = 0.001) -> Tuple[float, float]:
    """Return (low, high) percentile values, ignoring non-finite entries.

    Matches the converter/runtime convention: index len*from_left from the
    left and len*from_right+1 from the right of the sorted finite values
    (reference src/onnxstream.cpp:3104-3232 and onnx2txt.ipynb quantize()).
    """
    flat = np.asarray(arr, dtype=np.float32).reshape(-1)
    finite = flat[np.isfinite(flat)]
    if finite.size == 0:
        return 0.0, 0.0
    if finite.size == 1:
        v = float(finite[0])
        return v, v
    k_lo = int(finite.size * from_left)
    k_hi = finite.size - 1 - int(finite.size * from_right)
    k_hi = max(k_hi, k_lo)
    lo = float(np.partition(finite, k_lo)[k_lo])
    hi = float(np.partition(finite, k_hi)[k_hi])
    if hi < lo:
        lo, hi = hi, lo
    return lo, hi


def range_to_scale(lo: float, hi: float) -> Tuple[float, int]:
    """(min,max) -> (scale, zero_point), forcing the range to include 0
    (reference src/onnxstream.cpp:3234-3245)."""
    if lo > 0 and hi > 0:
        lo = 0.0
    elif lo < 0 and hi < 0:
        hi = 0.0
    if hi <= lo:
        return abs(hi) or 1.0, 0
    scale = (hi - lo) / 255.0
    if scale == 0.0:
        return 1.0, 0
    zero = int(round(abs(lo) / scale))
    return scale, min(zero, 255)


def quantize(arr: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    q = np.asarray(arr, dtype=np.float32) / scale + zero_point
    return np.clip(np.rint(q), 0, 255).astype(np.uint8)


def dequantize(arr: np.ndarray, scale: float, zero_point: int, dtype=np.float32) -> np.ndarray:
    return ((np.asarray(arr, dtype=np.float32) - zero_point) * scale).astype(dtype)


def quantize_weight_percentile(arr: np.ndarray) -> Tuple[np.ndarray, float, int]:
    """Offline percentile quantization of one weight tensor, matching the
    converter's quantize() (onnx2txt.ipynb) and force_uint8_storage."""
    lo, hi = get_percentiles(arr)
    scale, zero = range_to_scale(lo, hi)
    return quantize(arr, scale, zero), scale, zero


def quantize_weight_percentile_per_channel(
    arr: np.ndarray, axis: int = -1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-channel percentile quantization of a 2-D weight: one
    (scale, zero) pair per column. Beyond-reference (the reference quantizes
    per tensor, onnx2txt.ipynb quantize()); per-channel ranges cut the
    round-trip error roughly by the spread of per-column magnitudes, which
    is what makes weight-only int8 usable on real LLM checkpoints. Returns
    (u8 weight, scale (N,) f32, zero (N,) f32)."""
    a = np.asarray(arr, np.float32)
    if a.ndim != 2:
        raise ValueError(f"per-channel quantization expects 2-D, got {a.shape}")
    if axis in (0, -2):
        qt, s, z = quantize_weight_percentile_per_channel(a.T, axis=-1)
        return qt.T, s, z
    return _by_columns(_percentile_columns, a)


def _percentile_columns(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    k, n = a.shape
    # vectorized per-column percentiles (same index convention as
    # get_percentiles; weights are finite so the finite filter is skipped)
    k_lo = int(k * 0.001)
    k_hi = max(k - 1 - int(k * 0.001), k_lo)
    part = np.partition(a, (k_lo, k_hi), axis=0)
    lo = np.minimum(part[k_lo], part[k_hi])
    hi = np.maximum(part[k_lo], part[k_hi])
    # range_to_scale vectorized: force 0 into the range
    lo = np.minimum(lo, 0.0)
    hi = np.maximum(hi, 0.0)
    scales = (hi - lo) / 255.0
    degenerate = scales <= 0.0
    scales = np.where(degenerate, np.where(np.abs(hi) > 0, np.abs(hi), 1.0), scales)
    zeros = np.where(degenerate, 0.0, np.clip(np.round(np.abs(lo) / scales), 0, 255))
    # in-place f32 reciprocal-multiply (the broadcast f32 division was the
    # hot spot when quantizing a whole LLM's matmul weights at session
    # setup); a*(1/s) can differ from a/s by 1 LSB at exact-half ties, well
    # under the u8 rounding step, and the f32 temp keeps peak host memory at
    # 1x the weight size
    qf = a * (np.float32(1.0) / scales.astype(np.float32))
    qf += zeros.astype(np.float32)
    np.rint(qf, out=qf)
    np.clip(qf, 0, 255, out=qf)
    q = qf.astype(np.uint8)
    return q, scales.astype(np.float32), zeros.astype(np.float32)


def quantize_weight_symmetric_per_channel(
    arr: np.ndarray, axis: int = -1
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantization of a 2-D weight:
    scale[j] = (99.9th percentile of |col j|) / 127, zero point 0. This is
    the storage form for the s8 x s8 decode matmul
    (kernels/qmatmul.w8a8_dyn_matmul) — no zero-point correction term, so the
    integer dot needs no epilogue beyond the (row x col) scales. Returns
    (s8 weight, scale (N,) f32)."""
    a = np.asarray(arr, np.float32)
    if a.ndim != 2:
        raise ValueError(f"per-channel quantization expects 2-D, got {a.shape}")
    if axis in (0, -2):
        qt, s = quantize_weight_symmetric_per_channel(a.T, axis=-1)
        return qt.T, s
    return _by_columns(_symmetric_columns, a)


def _symmetric_columns(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    k, n = a.shape
    k_hi = max(k - 1 - int(k * 0.001), 0)
    amax = np.partition(np.abs(a), k_hi, axis=0)[k_hi]
    scales = amax / 127.0
    scales = np.where(scales <= 0.0, 1.0, scales)
    qf = a * (np.float32(1.0) / scales.astype(np.float32))
    np.rint(qf, out=qf)
    np.clip(qf, -127, 127, out=qf)
    return qf.astype(np.int8), scales.astype(np.float32)


class RangeData:
    """Calibration ranges per op name, with the reference's CSV persistence."""

    def __init__(self) -> None:
        self.data: Dict[str, Tuple[float, float]] = {}

    def observe(self, op_name: str, arr) -> None:
        self.update(op_name, *get_percentiles(np.asarray(arr)))

    def update(self, op_name: str, lo: float, hi: float) -> None:
        """Widen op_name's range to include (lo, hi)."""
        if op_name in self.data:
            plo, phi = self.data[op_name]
            lo, hi = min(lo, plo), max(hi, phi)
        self.data[op_name] = (lo, hi)

    def scale_zp(self, op_name: str) -> Tuple[float, int]:
        lo, hi = self.data[op_name]
        return range_to_scale(lo, hi)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for name, (lo, hi) in self.data.items():
                f.write(f"{name},{lo:.9g},{hi:.9g}\n")

    @classmethod
    def read(cls, path: str) -> "RangeData":
        rd = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, lo, hi = line.rsplit(",", 2)
                rd.data[name] = (float(lo), float(hi))
        return rd


def qdq_skip(graph) -> set:
    """The reference's QDQ skip rule (src/onnxstream.cpp:3009-3020; JAX
    ``Executor._qdq_skip``): a pushed tensor consumed only by the
    immediately next op is not quantized."""
    refs: Dict[str, int] = {}
    for op in graph.ops:
        for t in op.inputs:
            if t.name and not t.is_weight:
                refs[t.name] = refs.get(t.name, 0) + 1
    return {op.outputs[0].name for op, nxt in zip(graph.ops, graph.ops[1:])
            if len(op.outputs) == 1 and op.outputs[0].name and refs.get(op.outputs[0].name, 0) == 1
            and any(t.name == op.outputs[0].name for t in nxt.inputs if not t.is_weight)}

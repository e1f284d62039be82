"""Quantized matrix products: the hand-written CUDA kernels, their wrappers and twins.

``csrc/qlinear.cu`` replaces the TPU kernel ``qmatmul`` of
``onnxstream_tpu/kernels/qmatmul.py`` (the ``_qmm_kernel`` pallas_call):

  * ``qmatmul``: calibrated W8A8, uint8 (..., M, K) x uint8 (K, N) with
    per-tensor (scale, zero point) on both sides, rank-1 zero-point
    corrections and an optional bias in exact int32, then a float output
    (``float(acc) * a_scale * w_scale``) or a requantized uint8 one. The
    calibrated VAE decoder runs its attention projections through it, and
    ``kernels/qconv.py qconv`` runs every group-1 Conv through the same
    launch as an implicit GEMM. ``quantize_activation`` is the runtime's
    float -> uint8 step in front of it (plain torch ops, as JAX keeps it
    outside Pallas). A MatMul whose weight comes K-major as (N, K)
    (``weight_nk``; the executor uploads the calibrated MatMul weights so)
    runs on the u8 ``wgmma`` pipeline of ``csrc/gemm_sm90.cuh``; every other
    call on the ``mma.sync`` kernel (``qgemm_variant``).

``csrc/qmatmul.cu`` replaces two more TPU kernels of the same file:

  * ``w8a8_dyn_matmul`` (the ``_w8a8_dyn_kernel`` pallas_call and its XLA
    form ``w8a8_dyn_matmul_xla``): float (..., M, K) x symmetric int8 (K, N).
    A is quantized per row inside the launch (``sa = max(amax, 1e-12) / 127``,
    round half to even, clip to +-127), the dot runs s8 x s8 -> s32 and the
    epilogue is ``acc * sa * w_scale``. The int8 TinyLlama route runs every
    weight MatMul through it, its weights uploaded K-major as (N, K)
    (``weight_nk``; the planner's ``tnk`` transform after the per-channel
    quantization): a GEMV over the weight's rows for M <= 16 and the s8
    ``wgmma`` pipeline for larger M, tiled and split along K by ``dyn_plan``
    (``dyn_variant``); that form quantizes an activation once for the
    consecutive calls that read it unchanged. A (K, N) weight (tied, or
    passed directly) keeps the GEMV with a K split over blocks and the
    ``mma.sync`` tiles;
  * ``w8_matmul`` (the ``_w8mm_kernel`` pallas_call): float (..., M, K) x
    uint8 (K, N) -> ``w_scale * (a @ w - w_zero * rowsum(a))``, the uint8
    weight converted in shared memory and never copied to a float tensor in
    device memory. MatMuls whose weight is 2-D uint8 (``--quantize-uint8``
    graphs, forced asymmetric storage) run through it. Which variant runs is
    a function of dtype, shape and alignment only (``w8_variant``): 16-bit A
    with 16-byte granular rows takes the ``wgmma`` pipeline shared with
    ``kernels/matmul.py``, tiled and split along K by ``w8_plan``; the
    split's partial sums meet in a workspace in a fixed order.

Scales and zero points are Python numbers (per tensor) or (N,) float32
tensors (per output channel), which live on the device beside the weight.
See the source for the kernels' design and what bounds them.

The plain PyTorch twins (``qmatmul_reference``, ``w8a8_dyn_matmul_reference``,
``w8_matmul_reference``) follow the kernels' order of operations: the
integer dots of the 8-bit twins are exact in float64 (|acc| <= 255^2 K
< 2^53; integer ``torch.matmul`` does not run on CUDA), so ``qmatmul`` and
``w8a8_dyn_matmul`` agree with their twins bit for bit; the weight-only twin
accumulates in float32 in another order.

On CUDA tensors a wrapper launches its kernel on the current stream or
raises; on CPU tensors it computes the twin. Every launch adds one to the
wrapper's ``launches``. Each wrapper's batching rule moves a
``torch.func.vmap``'s mapped axis to the front of A's leading axes, whose
rows the kernel flattens: one launch over the stacked rows (exact, as
kernel 6 quantizes A per row). Each wrapper is a ``kernels.KernelFunction``
(a ``torch.autograd.Function``) with a ``vmap`` rule; the ``*_impl``
functions launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from onnxstream_tpu_torch.kernels import KernelFunction, build, closed_over, count, hold, register
from onnxstream_tpu_torch.kernels.matmul import SMS, split_plan

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
GEMV_MAX_M = 16  # rows up to which w8a8_dyn_matmul runs as a GEMV (csrc kGemvMaxM)
GEMV_COLS = 128  # columns per GEMV block of a (K, N) weight (csrc kGemvCols)
DYN_TILE_N = 128  # output tile width of w8a8_dyn_matmul's wgmma pipeline (csrc DynWgCfg::kBN)
DYN_TILE_K = 128  # its k-tile: 128 s8 values, one 128-byte row (csrc gemm90::kBK8)
W8_TILE_N = 160  # output tile width of w8_matmul's wgmma pipeline (csrc W8Cfg::kBN)

Scale = Union[float, torch.Tensor, np.ndarray]

# device -> zeroed int32 workspace of the dynamic GEMV's K split (M <= 16);
# every launch leaves it zeroed again. Launches are ordered on one stream.
_WORKSPACE: Dict[torch.device, torch.Tensor] = {}
# device -> (A, its version counter, the scratch holding A quantized): the
# last A that w8a8_dyn_matmul's wgmma form quantized. A call on the same
# tensor, unchanged since (the q / k / v and the gate / up projections read
# one activation), reuses the scratch and launches only the product. A CUDA
# graph capture starts and ends with it empty (``kernels.capturing``), so a
# graph reuses only an A quantized inside it.
_QUANTIZED_A: Dict[torch.device, Tuple[torch.Tensor, int, torch.Tensor]] = {}
_FUNCS: Dict[str, object] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # a, w, bias, out, out_kind, M, K, N, za, zw, alpha, beta, conv, w_nk, za16, stream
    "ostt_qgemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P, _P],
    # dtype, a, w, ws, ws_scalar, out, workspace, M, K, N, w_nk, bm, splits, part, quantize, stream
    "ostt_w8a8_dyn_matmul": [_I, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    # dtype, a, w, sw, zw, sw_scalar, zw_scalar, out, M, K, N, bm, splits, workspace, stream
    "ostt_w8_matmul": [_I, _P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _I, _P, _P],
}


def _per_channel(s: Scale, n: int, device: torch.device) -> Union[float, torch.Tensor]:
    """A scale or zero point as a Python float, or as an (N,) float32 tensor
    on ``device`` (a host array costs a copy per call: keep them on the
    device)."""
    if isinstance(s, torch.Tensor):
        if s.ndim == 0:
            raise ValueError("pass a per-tensor scale as a Python number, not a 0-d tensor")
        t = s.reshape(-1)
    elif np.ndim(s) > 0:
        t = torch.as_tensor(np.asarray(s, np.float32).reshape(-1))
    else:
        return float(s)
    if t.numel() != n:
        raise ValueError(f"per-channel vector of {t.numel()} values for {n} columns")
    return t.to(device=device, dtype=torch.float32)


def _flatten(a: torch.Tensor, w: torch.Tensor, wdtype: torch.dtype, name: str,
             weight_nk: bool = False) -> Tuple[torch.Tensor, int, int]:
    if w.dtype != wdtype or w.ndim != 2:
        raise TypeError(f"{name}: the weight must be a 2-D {wdtype} tensor, got {w.dtype} {tuple(w.shape)}")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported activation dtype {a.dtype}")
    n, k = w.shape if weight_nk else w.shape[::-1]
    if a.ndim < 1 or a.shape[-1] != k:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} x {tuple(w.shape)} do not chain")
    return a.reshape(-1, k), k, n


# --------------------------------------------------------------------- twins
def dyn_takes_kmajor(k: int) -> bool:
    """Whether an int8 weight of K rows may be given K-major, as (N, K): the
    GEMV and the wgmma pipeline read 16-byte pieces of its rows, so K must be
    a multiple of 16. The planner uploads the int8 MatMul weights so where
    this holds."""
    return k % 16 == 0


def w8a8_dyn_matmul_reference(a: torch.Tensor, w_s8: torch.Tensor, w_scale: Scale,
                              out_dtype: Optional[torch.dtype] = None, weight_nk: bool = False) -> torch.Tensor:
    """Plain twin of the dynamic int8 kernel: per-row symmetric s8 quant of
    A, exact integer dot, ``acc * sa * w_scale`` in float32. The weight is
    (K, N), or (N, K) with ``weight_nk``: the same bits either way."""
    a2, k, n = _flatten(a, w_s8, torch.int8, "w8a8_dyn_matmul", weight_nk)
    x = a2.float()
    sa = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    aq = torch.round(x / sa).clamp(-127, 127)
    acc = (aq.double() @ (w_s8.t() if weight_nk else w_s8).double()).float()
    out = acc * sa * _per_channel(w_scale, n, a.device)
    return out.to(out_dtype or a.dtype).reshape(*a.shape[:-1], n)


def w8_matmul_reference(a: torch.Tensor, w_q: torch.Tensor, w_scale: Scale, w_zero: Scale,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin of the weight-only kernel: float32 products of A with the
    uint8 weight, float32 row sums, ``(acc - w_zero * rowsum) * w_scale``."""
    a2, k, n = _flatten(a, w_q, torch.uint8, "w8_matmul")
    x = a2.float()
    acc = x @ w_q.float()
    rs = x.sum(dim=1, keepdim=True)
    out = (acc - _per_channel(w_zero, n, a.device) * rs) * _per_channel(w_scale, n, a.device)
    return out.to(out_dtype or a.dtype).reshape(*a.shape[:-1], n)


# ------------------------------------------------------------------ launches
def _func(name: str):
    """The C entry point, built and loaded at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(build.load("qlinear" if name == "ostt_qgemm" else "qmatmul"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FUNCS[name] = fn
    return fn


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every operand must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _ptr_or_scalar(s) -> Tuple[Optional[int], float]:
    return (s.data_ptr(), 0.0) if isinstance(s, torch.Tensor) else (None, s)


def _workspace(device: torch.device, ints: int) -> torch.Tensor:
    ws = _WORKSPACE.get(device)
    if ws is None or ws.numel() < ints:
        ws = torch.zeros(max(ints, 2 * (0 if ws is None else ws.numel())), dtype=torch.int32, device=device)
        _WORKSPACE[device] = ws
    return hold(ws)


def dyn_plan(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(bm, bn, splits): the output tile and the K split ``w8a8_dyn_matmul``
    gives its wgmma pipeline (a K-major weight, M > 16) for this shape. The
    product reads its tiles from L2 at about the rate L2 delivers them, so
    the tallest tile that still fills the card wins: 256 rows where such
    tiles alone make two waves (the LM head of a 1024-token prefill), 128
    where they occupy three quarters of the SMs, else 64. The int32 partials
    of a K split cost more than they save unless the 64-row tiles leave half
    the SMs idle (the k / v projections: 32 tiles x 4 splits at M = 1024);
    then kernel 9's ``split_plan`` rule sizes it. The split's workspace is
    splits * M * N int32."""
    tiles = lambda bm: -(-m // bm) * -(-n // DYN_TILE_N)
    if tiles(256) >= 2 * SMS:
        return 256, DYN_TILE_N, 1
    if 4 * tiles(128) >= 3 * SMS:
        return 128, DYN_TILE_N, 1
    if 2 * tiles(64) >= SMS:
        return 64, DYN_TILE_N, 1
    nkt = -(-k // DYN_TILE_K)
    splits = max(1, min(SMS // tiles(64), nkt // 4))
    return 64, DYN_TILE_N, -(-nkt // -(-nkt // splits))  # no empty split


def _quant_bytes(m: int, k: int) -> int:
    """Bytes of the quantized A scratch: M x K s8 (16-byte padded), then the
    row scales (M float32, padded to 4)."""
    return -(-m * k // 16) * 16 + 16 * -(-m // 4)


def dyn_variant(m: int, k: int, n: int, weight_nk: bool = False, w_ptr: int = 0) -> str:
    """Which kernel of ``csrc/qmatmul.cu`` a ``w8a8_dyn_matmul`` call runs
    on, as its dispatcher decides from the weight's layout, M, K and the
    weight's alignment (``dyn_nk_ok`` there): for a K-major (N, K) weight
    with ``dyn_takes_kmajor(k)`` and 16-byte aligned rows, ``"gemv_nk"`` (M
    <= 16) or ``"wgmma"``; an (N, K) weight that misses that is
    ``"refused"``; a (K, N) weight takes ``"gemv"`` (M <= 16, K split over
    blocks) or ``"mma"``."""
    if weight_nk:
        if not (dyn_takes_kmajor(k) and w_ptr % 16 == 0):
            return "refused"
        return "gemv_nk" if m <= GEMV_MAX_M else "wgmma"
    return "gemv" if m <= GEMV_MAX_M else "mma"


def w8a8_dyn_matmul_impl(a: torch.Tensor, w_s8: torch.Tensor, w_scale: Scale,
                         out_dtype: Optional[torch.dtype] = None, weight_nk: bool = False) -> torch.Tensor:
    """``w8a8_dyn_matmul`` on real tensors: the launch."""
    a2, k, n = _flatten(a, w_s8, torch.int8, "w8a8_dyn_matmul", weight_nk)
    if weight_nk and not dyn_takes_kmajor(k):
        raise ValueError(f"w8a8_dyn_matmul: an (N, K) weight needs K % 16 == 0, got K = {k}")
    if not a.is_cuda:
        if a.device.type == "cpu":
            return w8a8_dyn_matmul_reference(a, w_s8, w_scale, out_dtype, weight_nk)
        raise ValueError(f"w8a8_dyn_matmul runs on CUDA or CPU tensors, not {a.device}")
    ws = _per_channel(w_scale, n, a.device)
    _check_cuda("w8a8_dyn_matmul", a2, w_s8, *([ws] if isinstance(ws, torch.Tensor) else []))
    a2 = a2.contiguous()
    w_s8 = w_s8.contiguous()
    m = a2.shape[0]
    variant = dyn_variant(m, k, n, weight_nk, w_s8.data_ptr())
    if variant == "refused":
        raise ValueError(f"w8a8_dyn_matmul: an (N, K) weight needs 16-byte aligned rows (W at "
                         f"{w_s8.data_ptr() % 16} mod 16)")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel():
        bm, splits, work, part, quantize = 0, 1, None, None, True
        if variant == "gemv":
            work = _workspace(a.device, -(-n // GEMV_COLS) + m * n)
        elif variant in ("mma", "wgmma"):
            last = _QUANTIZED_A.get(a.device)
            if variant == "wgmma" and last is not None and last[0] is a and last[1] == a._version:
                work, quantize = last[2], False
            else:  # the quantized A and its row scales
                work = torch.empty(_quant_bytes(m, k), dtype=torch.uint8, device=a.device)
            if variant == "wgmma":
                bm, _, splits = dyn_plan(m, k, n)
                if splits > 1:
                    part = torch.empty(splits * m * n, dtype=torch.int32, device=a.device)
        ws_ptr, ws_scalar = _ptr_or_scalar(ws)
        fn = _func("ostt_w8a8_dyn_matmul")
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(_DTYPE_CODE[a.dtype], a2.data_ptr(), w_s8.data_ptr(), ws_ptr, ws_scalar,
                    out.data_ptr(), None if work is None else work.data_ptr(), m, k, n, int(weight_nk),
                    bm, splits, None if part is None else part.data_ptr(), int(quantize), stream)
        if rc != 0:
            raise RuntimeError(f"w8a8_dyn_matmul: kernel launch failed with CUDA error {rc}")
        if variant == "wgmma":
            _QUANTIZED_A[a.device] = (a, a._version, work)
        count("w8a8_dyn_matmul")
    out = out.reshape(*a.shape[:-1], n)
    return out if out_dtype in (None, a.dtype) else out.to(out_dtype)


class _DynMatmul(KernelFunction):
    """``w8a8_dyn_matmul`` with a batching rule (``vmap``): the mapped axis
    moves to the front of A, one launch over its rows. No backward."""

    @staticmethod
    def forward(a, w_s8, w_scale, out_dtype, weight_nk):
        return w8a8_dyn_matmul_impl(a, w_s8, w_scale, out_dtype, weight_nk)

    @staticmethod
    def vmap(info, in_dims, a, w_s8, w_scale, out_dtype, weight_nk):
        closed_over("w8a8_dyn_matmul", in_dims[1:3], ("the weight", "its scale"))
        return _DynMatmul.apply(a.movedim(in_dims[0], 0), w_s8, w_scale, out_dtype, weight_nk), 0


def w8a8_dyn_matmul(a: torch.Tensor, w_s8: torch.Tensor, w_scale: Scale,
                    out_dtype: Optional[torch.dtype] = None, weight_nk: bool = False) -> torch.Tensor:
    """float (..., M, K) x int8 (K, N) -> (..., M, N), per-row dynamic s8
    activations; ``w_scale`` a number or an (N,) vector. Output in
    ``out_dtype`` (default A's dtype). With ``weight_nk`` the weight is given
    K-major as (N, K), the form the executor uploads for the int8 route; it
    then needs K a multiple of 16 on either device (``dyn_takes_kmajor``),
    and on the card 16-byte aligned rows (``dyn_variant``).

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``w8a8_dyn_matmul.launches``; under ``torch.func.vmap``, one launch a
    call over the examples' rows."""
    return _DynMatmul.apply(a, w_s8, w_scale, out_dtype, weight_nk)


def w8_plan(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(bm, bn, splits): the output tile and the K split ``w8_matmul`` gives
    the wgmma pipeline for this shape. The split's workspace is splits *
    (M * N + M) float32 values (partial sums and partial row sums)."""
    bm, splits = split_plan(m, k, n, W8_TILE_N)
    return bm, W8_TILE_N, splits


def w8_variant(dtype: torch.dtype, m: int, k: int, n: int, a_ptr: int = 0, w_ptr: int = 0) -> str:
    """Which kernel of ``csrc/qmatmul.cu`` a weight-only product runs on, as
    its dispatcher decides from dtype, shape and pointer alignment
    (``w8_use_wgmma`` there): ``"wgmma"`` for 16-bit A with K a multiple of 8,
    N a multiple of 16 and 16-byte aligned A and W, else ``"mma"`` (16-bit,
    masked) or ``"fma"`` (float32)."""
    if dtype == torch.float32:
        return "fma"
    if k % 8 == 0 and n % 16 == 0 and a_ptr % 16 == 0 and w_ptr % 16 == 0:
        return "wgmma"
    return "mma"


def w8_matmul_impl(a: torch.Tensor, w_q: torch.Tensor, w_scale: Scale, w_zero: Scale,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``w8_matmul`` on real tensors: the launch."""
    if not a.is_cuda:
        if a.device.type == "cpu":
            return w8_matmul_reference(a, w_q, w_scale, w_zero, out_dtype)
        raise ValueError(f"w8_matmul runs on CUDA or CPU tensors, not {a.device}")
    a2, k, n = _flatten(a, w_q, torch.uint8, "w8_matmul")
    sw = _per_channel(w_scale, n, a.device)
    zw = _per_channel(w_zero, n, a.device)
    _check_cuda("w8_matmul", a2, w_q, *[v for v in (sw, zw) if isinstance(v, torch.Tensor)])
    a2 = a2.contiguous()
    w_q = w_q.contiguous()
    m = a2.shape[0]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel():
        sw_ptr, sw_scalar = _ptr_or_scalar(sw)
        zw_ptr, zw_scalar = _ptr_or_scalar(zw)
        fn = _func("ostt_w8_matmul")
        bm, splits, work = 64, 1, None
        if w8_variant(a.dtype, m, k, n, a2.data_ptr(), w_q.data_ptr()) == "wgmma":
            bm, _, splits = w8_plan(m, k, n)
            if splits > 1:
                work = torch.empty(splits * (m * n + m), dtype=torch.float32, device=a.device)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(_DTYPE_CODE[a.dtype], a2.data_ptr(), w_q.data_ptr(), sw_ptr, zw_ptr, sw_scalar,
                    zw_scalar, out.data_ptr(), m, k, n, bm, splits,
                    None if work is None else work.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"w8_matmul: kernel launch failed with CUDA error {rc}")
        count("w8_matmul")
    out = out.reshape(*a.shape[:-1], n)
    return out if out_dtype in (None, a.dtype) else out.to(out_dtype)


class _W8Matmul(KernelFunction):
    """``w8_matmul`` with a batching rule (``vmap``): the mapped axis moves
    to the front of A, one launch over its rows. No backward."""

    @staticmethod
    def forward(a, w_q, w_scale, w_zero, out_dtype):
        return w8_matmul_impl(a, w_q, w_scale, w_zero, out_dtype)

    @staticmethod
    def vmap(info, in_dims, a, w_q, w_scale, w_zero, out_dtype):
        closed_over("w8_matmul", in_dims[1:4], ("the weight", "its scale", "its zero point"))
        return _W8Matmul.apply(a.movedim(in_dims[0], 0), w_q, w_scale, w_zero, out_dtype), 0


def w8_matmul(a: torch.Tensor, w_q: torch.Tensor, w_scale: Scale, w_zero: Scale,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """float (..., M, K) x uint8 (K, N) -> (..., M, N) = ``w_scale * (a @ w -
    w_zero * rowsum(a))``; scale and zero point numbers or (N,) vectors.
    Output in ``out_dtype`` (default A's dtype).

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``w8_matmul.launches``; under ``torch.func.vmap``, one launch a call
    over the examples' rows."""
    return _W8Matmul.apply(a, w_q, w_scale, w_zero, out_dtype)


# the product kernel of a launch (beside the rows' quantization and a split-K reduction)
register("w8a8_dyn_matmul", w8a8_dyn_matmul,
         ("dyn_gemv_kernel", "dyn_gemv_nk_kernel", "dyn_mma_kernel", "dyn_wgmma_kernel"))
register("w8_matmul", w8_matmul, ("w8_wgmma_kernel", "w8_mma_kernel", "w8_fma_kernel"))


# ------------------------------------------------------ calibrated W8A8 (kernel 3)
_OUT_KIND = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.uint8: 3}
QGEMM_MAX_K = 33025  # the int32 accumulator is exact while 255^2 K < 2^31 (csrc kMaxK)


def quantize_activation(x: torch.Tensor, scale: float, zero: int, channels_last: bool = False) -> torch.Tensor:
    """float -> uint8 with the runtime's quantize math (onnxstream.cpp:3247),
    as JAX ``quantize_activation``: round half to even of ``x / scale`` in
    float32, plus the zero point, clipped to 0..255. The divisor is a tensor
    on x's device, so the division is IEEE on the card too (PyTorch's CUDA
    kernel turns a CPU-scalar divisor into a multiply by its reciprocal).
    The result is contiguous: an activation that arrives M-major (the VAE's
    attention projections get a transposed view) is laid out row-major by the
    float32 conversion the step makes anyway, not by a copy of the uint8
    tensor in front of every kernel 3 launch. With ``channels_last`` a 4-D
    (B, C, H, W) input comes out in ``torch.channels_last`` (the shape and
    the values unchanged), the layout of kernel 4's wgmma variant, laid out
    by the same conversion."""
    s = torch.full((), float(scale), dtype=torch.float32, device=x.device)
    # channels-last as a permuted contiguous (B, H, W, C), which an example
    # under vmap keeps too; one pass for a 16-bit input; .to returns a
    # float32 input as it is, whatever its strides, so .contiguous() lays
    # that one out
    xf = x.permute(0, 2, 3, 1) if channels_last else x
    xf = xf.to(torch.float32, memory_format=torch.contiguous_format).contiguous()
    if channels_last:
        xf = xf.permute(0, 3, 1, 2)
    q = torch.round(xf / s).add_(float(zero))
    return q.clamp(0, 255).to(torch.uint8)


def _zero_point(z, what: str) -> int:
    zi = int(round(float(z)))
    if zi != float(z) or not 0 <= zi <= 255:
        raise ValueError(f"{what} must be a whole number in 0..255, got {z}")
    return zi


def _scales(a_scale, a_zero, w_scale, w_zero, out_scale, out_zero) -> Tuple[int, int, float, float]:
    """(za, zw, alpha, beta) of a W8A8 product. ``alpha`` is the JAX
    kernel's ``sa * sw (/ out_scale)``, computed in double on the host."""
    for v, what in ((a_scale, "a_scale"), (w_scale, "w_scale")):
        if np.ndim(v) or isinstance(v, torch.Tensor):
            raise TypeError(f"qmatmul: {what} is per tensor (a Python number), got {type(v).__name__}")
    out_u8 = out_scale is not None
    alpha = float(a_scale * w_scale) * (1.0 / float(out_scale) if out_u8 else 1.0)
    beta = float(_zero_point(out_zero, "out_zero")) if out_u8 else 0.0
    return _zero_point(a_zero, "a_zero"), _zero_point(w_zero, "w_zero"), alpha, beta


def _check_k(k: int, name: str) -> None:
    if k > QGEMM_MAX_K:
        raise ValueError(f"{name}: K = {k} above {QGEMM_MAX_K}, where the int32 accumulator could overflow")


def _qparams(a_q, w_q, a_scale, a_zero, w_scale, w_zero, out_scale, out_zero, weight_nk=False):
    """(K, N, za, zw, alpha, beta) of a W8A8 product; raises on what the
    kernel does not take."""
    if a_q.dtype != torch.uint8 or w_q.dtype != torch.uint8 or w_q.ndim != 2:
        raise TypeError(f"qmatmul: uint8 (..., M, K) x 2-D uint8 weight, got {a_q.dtype} "
                        f"{tuple(a_q.shape)} x {w_q.dtype} {tuple(w_q.shape)}")
    n, k = w_q.shape if weight_nk else w_q.shape[::-1]
    if a_q.ndim < 1 or a_q.shape[-1] != k:
        raise ValueError(f"qmatmul: shapes {tuple(a_q.shape)} x {tuple(w_q.shape)} do not chain")
    _check_k(k, "qmatmul")
    return (k, n, *_scales(a_scale, a_zero, w_scale, w_zero, out_scale, out_zero))


def _acc_bias(bias, n: int, device: torch.device) -> Optional[torch.Tensor]:
    """A bias given in accumulator units as an (N,) int32 tensor on
    ``device``, truncated toward zero."""
    if bias is None:
        return None
    b = torch.as_tensor(bias, device=device).reshape(-1)
    if b.numel() != n:
        raise ValueError(f"bias of {b.numel()} values for {n} columns")
    return b if b.dtype == torch.int32 else b.float().to(torch.int32)


def _qepilogue(acc: torch.Tensor, alpha: float, beta: float, out_u8: bool,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's epilogue on an exact float64 accumulator: one rounding to
    float32, ``* alpha`` in float32, then the cast (or ``+ beta``, round half
    to even and clip for a uint8 output)."""
    y = acc.float() * alpha
    if out_u8:
        return torch.round(y + beta).clamp(0, 255).to(torch.uint8)
    return y.to(out_dtype)


def qmatmul_reference(a_q: torch.Tensor, w_q: torch.Tensor, a_scale: float, a_zero: int,
                      w_scale: float, w_zero: int, out_scale: Optional[float] = None,
                      out_zero: Optional[int] = None, bias=None,
                      out_dtype: torch.dtype = torch.float32, weight_nk: bool = False) -> torch.Tensor:
    """Plain twin of kernel 3: the zero-point-shifted integer product in
    float64 (exact), the int32 bias, then the kernel's epilogue. The weight
    is (K, N), or (N, K) with ``weight_nk``: the same bits either way."""
    k, n, za, zw, alpha, beta = _qparams(a_q, w_q, a_scale, a_zero, w_scale, w_zero, out_scale, out_zero,
                                         weight_nk)
    wk = w_q.t() if weight_nk else w_q
    acc = (a_q.reshape(-1, k).double() - za) @ (wk.double() - zw)
    b = _acc_bias(bias, n, a_q.device)
    if b is not None:
        acc += b.double()
    out = _qepilogue(acc, alpha, beta, out_scale is not None, out_dtype)
    return out.reshape(*a_q.shape[:-1], n)


def qgemm_takes_kmajor(k: int) -> bool:
    """Whether a MatMul weight of K rows may be given K-major, as (N, K): the
    wgmma pipeline reads 16-byte pieces of its rows and of A's, so K must be
    a multiple of 16. The planner uploads the calibrated MatMul weights so
    where this holds."""
    return k % 16 == 0


def qconv_takes_nhwc(c: int) -> bool:
    """Whether a W8A8 conv of ``c`` input channels runs on the u8 wgmma
    pipeline, its input quantized channels-last and its weight uploaded so
    (``WEIGHT_TRANSFORMS["ohwi"]``): the gather copies 16 channels of one tap
    at a time (C % 16 == 0). Every SD VAE decoder conv qualifies but conv_in
    (C = 4), conv_out (O = 3) included: its 128-row channel tile is mostly
    zeros, and still it runs several times faster than on the mma.sync
    kernel (PERF.md)."""
    return c % 16 == 0


def qgemm_variant(m: int, k: int, n: int, weight_nk: bool, a_ptr: int = 0, w_ptr: int = 0,
                  conv: bool = False, nhwc: bool = False, c: int = 0) -> str:
    """Which kernel of ``csrc/qlinear.cu`` a W8A8 product runs on, as its
    dispatcher decides from the operands' layouts, K and pointer alignment
    (``use_wgmma`` there): ``"wgmma"`` for a MatMul whose weight is given
    K-major as (N, K), with ``qgemm_takes_kmajor(k)`` and 16-byte aligned A
    and W (ragged M and N are zero-filled by the copies), and for a conv
    (``conv``, ``c`` input channels) whose input and weight are both
    channels-last (``nhwc``), C a multiple of 16 and 16-byte aligned starts;
    else ``"mma"`` (NCHW convs, every (K, N) weight). An
    (N, K) weight or a channels-last conv that misses the wgmma predicate is
    refused."""
    aligned = a_ptr % 16 == 0 and w_ptr % 16 == 0
    if conv:
        return "wgmma" if nhwc and c % 16 == 0 and aligned else "mma"
    if weight_nk and qgemm_takes_kmajor(k) and aligned:
        return "wgmma"
    return "mma"


def _za_pieces(device: torch.device) -> torch.Tensor:
    """256 pieces of 16 bytes on ``device``, piece z holding the byte z: the
    conv gather copies piece za where a window leaves the input. Made once
    per device."""
    t = _ZA_PIECES.get(device)
    if t is None:
        t = _ZA_PIECES[device] = torch.arange(256, dtype=torch.uint8, device=device).repeat_interleave(16)
    return hold(t)


_ZA_PIECES: Dict[torch.device, torch.Tensor] = {}


def _qgemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], out: torch.Tensor,
           m: int, k: int, n: int, za: int, zw: int, alpha: float, beta: float,
           conv: Optional[Tuple[int, ...]] = None, weight_nk: bool = False) -> None:
    """One launch of ``csrc/qlinear.cu`` on the current stream: a MatMul of
    a (K, N) weight (or of an (N, K) one with ``weight_nk``), or with
    ``conv`` (the geometry and the layout flag, 14 ints) a convolution that
    writes NCHW, of the NCHW input and the OIHW weight as (N, K), or of both
    channels-last. Raises when CUDA refuses it. Adds one to
    ``qmatmul.launches``."""
    _check_cuda("qmatmul", a, w, out, *([bias] if bias is not None else []))
    geo = None if conv is None else (ctypes.c_int * 14)(*conv)
    za16 = _za_pieces(a.device).data_ptr() + 16 * za if conv is not None and conv[13] else None
    fn = _func("ostt_qgemm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
                _OUT_KIND[out.dtype], m, k, n, za, zw, alpha, beta,
                None if geo is None else ctypes.addressof(geo), int(weight_nk), za16, stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul: kernel launch failed with CUDA error {rc}")
    count("qmatmul")


def qmatmul_impl(a_q: torch.Tensor, w_q: torch.Tensor, a_scale: float, a_zero: int, w_scale: float,
                 w_zero: int, out_scale: Optional[float] = None, out_zero: Optional[int] = None, bias=None,
                 out_dtype: torch.dtype = torch.float32, weight_nk: bool = False) -> torch.Tensor:
    """``qmatmul`` on real tensors: the launch."""
    k, n, za, zw, alpha, beta = _qparams(a_q, w_q, a_scale, a_zero, w_scale, w_zero, out_scale, out_zero,
                                         weight_nk)
    if weight_nk and not qgemm_takes_kmajor(k):
        raise ValueError(f"qmatmul: an (N, K) weight needs K % 16 == 0, got K = {k}")
    if not a_q.is_cuda:
        if a_q.device.type == "cpu":
            return qmatmul_reference(a_q, w_q, a_scale, a_zero, w_scale, w_zero, out_scale,
                                     out_zero, bias, out_dtype, weight_nk)
        raise ValueError(f"qmatmul runs on CUDA or CPU tensors, not {a_q.device}")
    a2 = a_q.reshape(-1, k).contiguous()
    w2 = w_q.contiguous()
    m = a2.shape[0]
    if weight_nk and qgemm_variant(m, k, n, True, a2.data_ptr(), w2.data_ptr()) != "wgmma":
        raise ValueError(f"qmatmul: an (N, K) weight needs 16-byte aligned rows "
                         f"(A at {a2.data_ptr() % 16}, W at {w2.data_ptr() % 16} mod 16)")
    out = torch.empty((m, n), dtype=torch.uint8 if out_scale is not None else out_dtype,
                      device=a_q.device)
    if out.numel():
        _qgemm(a2, w2, _acc_bias(bias, n, a_q.device), out, m, k, n, za, zw, alpha, beta,
               weight_nk=weight_nk)
    return out.reshape(*a_q.shape[:-1], n)


class _QMatmul(KernelFunction):
    """``qmatmul`` with a batching rule (``vmap``): the mapped axis moves to
    the front of A, one launch over its rows. No backward."""

    @staticmethod
    def forward(*args):
        return qmatmul_impl(*args)

    @staticmethod
    def vmap(info, in_dims, a_q, w_q, *rest):
        closed_over("qmatmul", (in_dims[1], in_dims[8]), ("the weight", "the bias"))
        return _QMatmul.apply(a_q.movedim(in_dims[0], 0), w_q, *rest), 0


def qmatmul(a_q: torch.Tensor, w_q: torch.Tensor, a_scale: float, a_zero: int, w_scale: float,
            w_zero: int, out_scale: Optional[float] = None, out_zero: Optional[int] = None, bias=None,
            out_dtype: torch.dtype = torch.float32, weight_nk: bool = False) -> torch.Tensor:
    """Calibrated W8A8: uint8 (..., M, K) x uint8 (K, N) -> (..., M, N), K
    at most ``QGEMM_MAX_K``. With ``weight_nk`` the weight is given K-major
    as (N, K), the form the executor uploads for calibrated MatMuls
    (``WEIGHT_TRANSFORMS["tnk"]``), and runs on the wgmma pipeline; it then
    needs K a multiple of 16 on either device (``qgemm_takes_kmajor``), and
    on the card 16-byte aligned rows (``qgemm_variant``).
    Scales and zero points are per tensor (numbers). ``bias`` is an (N,)
    vector in accumulator units (``b / (a_scale * w_scale)``), truncated
    toward zero to int32 as ``qconv`` passes it. With ``out_scale``/
    ``out_zero`` the output is requantized uint8, else float in
    ``out_dtype``.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``qmatmul.launches``; under ``torch.func.vmap``, one launch a call over
    the examples' rows."""
    return _QMatmul.apply(a_q, w_q, a_scale, a_zero, w_scale, w_zero, out_scale, out_zero, bias, out_dtype,
                          weight_nk)


register("qmatmul", qmatmul, ("qgemm_kernel", "qgemm_wgmma_kernel"))

"""Tiled matrix product with float32 accumulation, and the im2col 3x3 convolution built on it: the wrapper of the hand-written CUDA kernel and its twin.

Replaces the TPU kernel ``matmul_pallas`` of ``onnxstream_tpu/kernels/matmul.py``
and its caller ``conv3x3_im2col_pallas``: C = A @ B (+ bias) with A (M, K) and
B (K, N) in one dtype, float32 accumulation over the whole K sweep, the bias
added in float32 and one rounding to ``out_dtype``. ``conv3x3_im2col`` turns a
3x3 stride-1 pad-1 convolution of an NHWC input into that product: the nine
shifted windows concatenated along the channel axis (tap-major) times the
weight in its (9 C, O) upload form. The concat is a plain PyTorch op, as the
JAX package leaves it to XLA; the weight's relayout happens once, at upload
(``oihw_to_w9co``, the ``t9co`` entry of ``runtime/planner.WEIGHT_TRANSFORMS``,
set by ``runtime/fusion.rewrite_smallconv``); the product is the kernel's.
``SessionConfig.use_pallas_smallconv`` sends the SD UNet's small-spatial 3x3
convolutions (``smallconv_eligible``: C and O multiples of 128, H W <= 1024)
through it.

``matmul_reference`` is the plain twin: the product in float32 and one
rounding. The kernel (``csrc/matmul.cu``) sums in another order: it agrees
with the twin within rtol 1e-5 / atol 1e-4 sqrt(K / 128) for a float32 output
and 2e-2 for a 16-bit one, the bars of the JAX package's own kernel tests.
Which of its variants runs is a function of dtype, shape and alignment only
(``matmul_variant``): 16-bit operands with 16-byte granular rows take the
``wgmma`` pipeline, tiled and split along K by ``matmul_plan`` so that the
blocks fill the card; the split's float32 partials meet in a workspace in a
fixed order, so a call gives the same bits every time. Everything else takes
the masked ``mma.sync`` tiles (16-bit) or float32 FMAs.

``matmul_supported`` keeps the shapes the path gives the kernel (K and N
multiples of 128, M a multiple of 16, or of 8 up to 1024); the CUDA kernel
masks ragged edges itself and takes any positive M, K, N.

On CUDA tensors ``matmul`` launches the kernel on the current stream, or
raises; on CPU tensors it computes the twin. Every launch adds one to
``matmul.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.kernels import KernelFunction, build, closed_over, count, folded, register, unfolded

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, a, b, bias, bias_dtype, out, out_dtype, M, K, N, bm, splits, workspace, stream
_ARGTYPES = [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P]
SMS = 132      # streaming multiprocessors of an H100: what a plan fills
TILE_K = 64    # k-tile of the wgmma pipeline (csrc/gemm_sm90.cuh kBK)
TILE_N = 128   # its output tile width for this kernel (csrc/matmul.cu WgCfg::kBN)
_FUNC = []


def _func():
    """The C entry point of ``csrc/matmul.cu``, built and loaded at first use."""
    if not _FUNC:
        fn = build.load("matmul").ostt_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
        _FUNC.append(fn)
    return _FUNC[0]


def matmul_supported(m: int, k: int, n: int) -> bool:
    """The shapes of the small-conv path: K and N multiples of 128, M a
    multiple of 16, or of 8 and at most 1024."""
    return k % 128 == 0 and n % 128 == 0 and (m % 16 == 0 or (m % 8 == 0 and m <= 1024))


def split_plan(m: int, k: int, n: int, bn: int, tile_k: int = TILE_K) -> Tuple[int, int]:
    """(bm, splits) of the wgmma pipeline for an (M, K) x (K, N) product with
    ``bn``-wide tiles and ``tile_k``-deep k-tiles: 64 or 128 rows per tile and
    the number of K splits, from the shape alone. A split is taken only where
    the tiles leave SMs idle, never so many that the blocks exceed the SMs,
    and never finer than 4 k-tiles a split. 128-row tiles (a B tile staged once serves twice the
    rows, which halves the traffic from L2) are taken where they alone occupy
    three quarters of the SMs; else the height whose blocks keep the larger
    share of the SMs busy over their waves wins, on a tie again the taller
    one, though it splits further."""
    nkt = -(-k // tile_k)
    best = None
    for bm in (128, 64):
        if bm == 128 and m <= 64:
            continue
        tiles = -(-m // bm) * -(-n // bn)
        if bm == 128 and 4 * tiles >= 3 * SMS:
            return 128, 1
        splits = max(1, min(SMS // tiles, nkt // 4))
        splits = -(-nkt // -(-nkt // splits))  # no empty split
        blocks = tiles * splits
        busy = blocks / (-(-blocks // SMS) * SMS)  # 160 blocks are two waves: 61 %
        key = (busy, bm, splits)
        if best is None or key > best:
            best = key
    return best[1], best[2]


def matmul_plan(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(bm, bn, splits): the output tile and the K split ``matmul`` gives the
    wgmma pipeline for this shape (M = 64, N = 1280 -> 10 tiles x 13 splits).
    The split's workspace is splits * M * N float32 values."""
    bm, splits = split_plan(m, k, n, TILE_N)
    return bm, TILE_N, splits


def matmul_variant(dtype: torch.dtype, m: int, k: int, n: int, a_ptr: int = 0, b_ptr: int = 0) -> str:
    """Which kernel of ``csrc/matmul.cu`` a product runs on, as its dispatcher
    decides from dtype, shape and pointer alignment (``use_wgmma`` there):
    ``"wgmma"`` for 16-bit operands with K and N multiples of 8 and 16-byte
    aligned A and B, else ``"mma"`` (16-bit, masked) or ``"fma"`` (float32)."""
    if dtype == torch.float32:
        return "fma"
    if k % 8 == 0 and n % 8 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0:
        return "wgmma"
    return "mma"


def _check(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} x {tuple(b.shape)} do not chain")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"matmul: A and B in one of float32 / float16 / bfloat16, got {a.dtype} and {b.dtype}")
    if bias is not None and bias.numel() != b.shape[1]:
        raise ValueError(f"matmul: bias of {bias.numel()} values for {b.shape[1]} columns")


def matmul_reference(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin: A @ B in float32, + bias in float32, one rounding."""
    _check(a, b, bias)
    acc = a.float() @ b.float()
    if bias is not None:
        acc = acc + bias.float().reshape(1, -1)
    return acc.to(out_dtype or a.dtype)


def matmul_impl(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The implementation of ``matmul`` (``_Matmul``'s forward) on real
    tensors."""
    if not a.is_cuda:
        if a.device.type == "cpu":
            return matmul_reference(a, b, bias, out_dtype=out_dtype)
        raise ValueError(f"matmul runs on CUDA or CPU tensors, not {a.device}")
    _check(a, b, bias)
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul: unsupported output dtype {out_dtype}")
    others = [b] + ([bias] if bias is not None else [])
    if any(t.device != a.device for t in others):
        raise ValueError(f"matmul: every operand must be on {a.device}, got {[str(t.device) for t in others]}")
    bcode = 0
    if bias is not None:
        if bias.dtype not in _DTYPE_CODE:
            bias = bias.float()
        bias = bias.reshape(-1).contiguous()
        bcode = _DTYPE_CODE[bias.dtype]
    a, b = a.contiguous(), b.contiguous()
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        raise ValueError("matmul: K = 0")
    fn = _func()
    bm, splits, work = 64, 1, None
    if matmul_variant(a.dtype, m, k, n, a.data_ptr(), b.data_ptr()) == "wgmma":
        bm, _, splits = matmul_plan(m, k, n)
        if splits > 1:
            work = torch.empty(splits * m * n, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
                bcode, out.data_ptr(), _DTYPE_CODE[out_dtype], m, k, n, bm, splits,
                None if work is None else work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"matmul: kernel launch failed with CUDA error {rc}")
    count("matmul")
    return out


class _Matmul(KernelFunction):
    """``matmul`` with a batching rule (``vmap``): the mapped axis folded
    into M, (V, M, K) -> (V M, K); one launch."""

    @staticmethod
    def forward(a, b, bias, out_dtype):
        return matmul_impl(a, b, bias, out_dtype=out_dtype)

    @staticmethod
    def vmap(info, in_dims, a, b, bias, out_dtype):
        closed_over("matmul", in_dims[1:3], ("B", "the bias"))
        (a,) = folded(info.batch_size, in_dims[:1], a)
        return unfolded(_Matmul.apply(a, b, bias, out_dtype), info.batch_size)


def matmul(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A (M, K) @ B (K, N) + bias (N,) -> (M, N) in ``out_dtype`` (default A's).

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``matmul.launches``. Under ``torch.func.vmap`` the mapped axis folds
    into M, one launch a call."""
    return _Matmul.apply(a, b, bias, out_dtype)


register("matmul", matmul, ("mm_wgmma_kernel", "mm_mma_kernel", "mm_fma_kernel"))


def smallconv_eligible(x_shape, w_shape, group: int = 1, strides=(1, 1), dilations=(1, 1),
                       pads=(1, 1, 1, 1)) -> bool:
    """Whether a Conv of an NCHW input of ``x_shape`` with an OIHW weight of
    ``w_shape`` takes the im2col route under ``use_pallas_smallconv``: 3x3,
    stride 1, pad 1, one group, C and O multiples of 128, at most 1024 pixels
    a sample and a multiple of 8 rows (the JAX executor's gate)."""
    return (len(x_shape) == 4 and len(w_shape) == 4 and group == 1 and tuple(w_shape[2:]) == (3, 3)
            and w_shape[1] == x_shape[1] and tuple(strides) == (1, 1) and tuple(dilations) == (1, 1)
            and tuple(pads) == (1, 1, 1, 1) and x_shape[1] % 128 == 0 and w_shape[0] % 128 == 0
            and x_shape[2] * x_shape[3] <= 1024 and (x_shape[0] * x_shape[2] * x_shape[3]) % 8 == 0)


def oihw_to_w9co(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) -> (9 C, O): the ``t9co`` upload transform (host side),
    rows tap-major as ``conv3x3_im2col`` concatenates its windows."""
    o, c, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw * c, o).contiguous()


def conv3x3_im2col_impl(x_nhwc: torch.Tensor, w9co: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The implementation of ``conv3x3_im2col`` (``_Conv3x3Im2col``'s
    forward) on real tensors."""
    n, h, w, c = x_nhwc.shape
    if w9co.ndim != 2 or w9co.shape[0] != 9 * c:
        raise ValueError(f"conv3x3_im2col: a (9 C, O) weight for C = {c}, got {tuple(w9co.shape)}")
    o = w9co.shape[1]
    xp = F.pad(x_nhwc, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w, :].reshape(n * h * w, c) for i in range(3) for j in range(3)]
    a2 = torch.cat(cols, dim=1)  # (M, 9 C)
    y = matmul(a2, w9co.to(a2.dtype), bias, out_dtype=out_dtype or x_nhwc.dtype)
    return y.reshape(n, h, w, o)


class _Conv3x3Im2col(KernelFunction):
    """``conv3x3_im2col`` with a batching rule (``vmap``): the mapped axis
    folded into N before the im2col, (V, N, H, W, C) -> (V N, H, W, C): one
    ``matmul`` launch over every example's rows."""

    @staticmethod
    def forward(x_nhwc, w9co, bias, out_dtype):
        return conv3x3_im2col_impl(x_nhwc, w9co, bias, out_dtype=out_dtype)

    @staticmethod
    def vmap(info, in_dims, x_nhwc, w9co, bias, out_dtype):
        closed_over("conv3x3_im2col", in_dims[1:3], ("the weight", "the bias"))
        (x_nhwc,) = folded(info.batch_size, in_dims[:1], x_nhwc)
        return unfolded(_Conv3x3Im2col.apply(x_nhwc, w9co, bias, out_dtype), info.batch_size)


def conv3x3_im2col(x_nhwc: torch.Tensor, w9co: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3x3 stride-1 pad-1 convolution as im2col + ``matmul``.

    x: (N, H, W, C), w9co: (9 C, O) (``oihw_to_w9co`` of the OIHW weight),
    bias: (O,) -> (N, H, W, O). The nine shifted windows concatenate along
    the channel axis, tap-major like the weight's rows. Under
    ``torch.func.vmap`` the mapped axis folds into N before the im2col, one
    ``matmul`` launch a call."""
    return _Conv3x3Im2col.apply(x_nhwc, w9co, bias, out_dtype)

"""Tiled matrix product with float32 accumulation, and the im2col 3x3 convolution built on it: the wrapper of the hand-written CUDA kernel and its twin.

Replaces the TPU kernel ``matmul_pallas`` of ``onnxstream_tpu/kernels/matmul.py``
and its caller ``conv3x3_im2col_pallas``: C = A @ B (+ bias) with A (M, K) and
B (K, N) in one dtype, float32 accumulation over the whole K sweep, the bias
added in float32 and one rounding to ``out_dtype``. ``conv3x3_im2col`` turns a
3x3 stride-1 pad-1 convolution of an NHWC input into that product: the nine
shifted windows concatenated along the channel axis (tap-major) times the
weight transposed to (9 C, O). The concat and the transpose are plain PyTorch
ops, as the JAX package leaves them to XLA; the product is the kernel's.
``SessionConfig.use_pallas_smallconv`` sends the SD UNet's small-spatial 3x3
convolutions (C and O multiples of 128, H W <= 1024) through it.

``matmul_reference`` is the plain twin: the product in float32 and one
rounding. The kernel (``csrc/matmul.cu``: ``mma.sync`` tiles for bfloat16 /
float16, float32 FMAs for float32) sums in another order: it agrees with the
twin within rtol 1e-5 / atol 1e-4 sqrt(K / 128) for a float32 output and 2e-2
for a 16-bit one, the bars of the JAX package's own kernel tests.

``matmul_supported`` keeps the shapes the path gives the kernel (K and N
multiples of 128, M a multiple of 16, or of 8 up to 1024); the CUDA kernel
masks ragged edges itself and takes any positive M, K, N.

On CUDA tensors ``matmul`` launches the kernel on the current stream, or
raises; on CPU tensors it computes the twin. Every launch adds one to
``matmul.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, a, b, bias, bias_dtype, out, out_dtype, M, K, N, stream
_ARGTYPES = [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P]
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


def matmul(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A (M, K) @ B (K, N) + bias (N,) -> (M, N) in ``out_dtype`` (default A's).

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``matmul.launches``."""
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
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
                bcode, out.data_ptr(), _DTYPE_CODE[out_dtype], m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"matmul: kernel launch failed with CUDA error {rc}")
    matmul.launches += 1
    return out


matmul.launches = 0


def conv3x3_im2col(x_nhwc: torch.Tensor, w_oihw: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3x3 stride-1 pad-1 convolution as im2col + ``matmul``.

    x: (N, H, W, C), w: (O, C, 3, 3), bias: (O,) -> (N, H, W, O). The nine
    shifted windows concatenate along the channel axis (tap-major, matching w
    transposed to (3, 3, C, O) -> (9 C, O))."""
    n, h, w, c = x_nhwc.shape
    o = w_oihw.shape[0]
    xp = F.pad(x_nhwc, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w, :].reshape(n * h * w, c) for i in range(3) for j in range(3)]
    a2 = torch.cat(cols, dim=1)  # (M, 9 C)
    w2 = w_oihw.permute(2, 3, 1, 0).reshape(9 * c, o).to(a2.dtype)
    y = matmul(a2, w2, bias, out_dtype=out_dtype or x_nhwc.dtype)
    return y.reshape(n, h, w, o)

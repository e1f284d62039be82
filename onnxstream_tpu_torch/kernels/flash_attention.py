"""Flash attention over packed heads: the hand-written CUDA kernel and its twin.

``flash_attention_packed`` replaces the TPU kernel
``onnxstream_tpu/kernels/flash_attention.py`` ``flash_attention_packed``
(``_flash_call_packed`` -> ``_fa_kernel``). The kernel, ``csrc/flash_attention.cu``,
reads each head straight from the packed ``(B, L, H*D)`` projections through
strides, so unlike the TPU wrapper it makes no padded copy of Q, K or V. See
the source for its design and what bounds it.

``flash_attention_packed_reference`` is its plain PyTorch twin: the same
function computed in float32 with materialized scores, with the same
convention that a row with no valid key (causal, M > N) is exactly 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from onnxstream_tpu_torch.kernels import build

LOG2_E = 1.4426950408889634
MAX_HEAD_DIM = 256  # largest head dim the kernel's tile shapes cover

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def flash_attention_packed_reference(q, k, v, heads: int, scale: Optional[float] = None,
                                     causal: bool = False) -> torch.Tensor:
    """Plain twin of the kernel: q (B, M, H*D), k (B, N, Hkv*D), v (B, N,
    Hkv*Dv) -> (B, M, H*Dv) in q's dtype, computed in float32."""
    b, m, hd = q.shape
    d = hd // heads
    n = k.shape[1]
    hkv = k.shape[-1] // d
    dv = v.shape[-1] // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qh = q.float().reshape(b, m, heads, d).transpose(1, 2)
    kh = k.float().reshape(b, n, hkv, d).transpose(1, 2).repeat_interleave(heads // hkv, dim=1)
    vh = v.float().reshape(b, n, hkv, dv).transpose(1, 2).repeat_interleave(heads // hkv, dim=1)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        row = torch.arange(m, device=q.device)[:, None]
        col = torch.arange(n, device=q.device)[None, :]
        keep = col <= row + (n - m)
    else:
        keep = torch.ones(m, n, dtype=torch.bool, device=q.device)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    p = torch.where(keep.any(dim=-1, keepdim=True), p, torch.zeros((), device=q.device))
    out = torch.matmul(p, vh)
    return out.transpose(1, 2).reshape(b, m, heads * dv).to(q.dtype)


def _check(q, k, v, heads: int):
    """Shapes the kernel takes; raises on anything else. Returns (d, hkv, dv)."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention_packed: q, k, v must be (B, L, heads*D)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_packed: unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_packed: q, k, v on different devices")
    b, m, hd = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1]:
        raise ValueError(f"flash_attention_packed: shapes {q.shape}, {k.shape}, {v.shape}")
    if hd % heads:
        raise ValueError(f"packed q width {hd} not divisible by heads {heads}")
    d = hd // heads
    if d == 0 or k.shape[-1] % d:
        raise ValueError("packed k width inconsistent with the head dim")
    hkv = k.shape[-1] // d
    if hkv == 0 or heads % hkv or v.shape[-1] % hkv:
        raise ValueError("GQA requires q_heads % kv_heads == 0 and v divisible by kv_heads")
    dv = v.shape[-1] // hkv
    if d % 8 or dv % 8 or d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims must be multiples of 8 up to {MAX_HEAD_DIM}, got {d}, {dv}")
    return d, hkv, dv


def _bind(lib: ctypes.CDLL):
    fn = lib.ostt_flash_attention_packed
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def flash_attention_packed(q, k, v, heads: int, scale: Optional[float] = None,
                           causal: bool = False) -> torch.Tensor:
    """Flash SDPA over packed projections: q (B, M, H*D), k (B, N, Hkv*D),
    v (B, N, Hkv*Dv) -> (B, M, H*Dv) in q's dtype. Also accepts 2-D (L, H*D).

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``flash_attention_packed.launches``."""
    if q.ndim == 2:
        return flash_attention_packed(q[None], k[None], v[None], heads, scale=scale, causal=causal)[0]
    d, hkv, dv = _check(q, k, v, heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed runs on CUDA or CPU tensors, not {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_packed: the last dim of q, k, v must be contiguous")
    b, m, _ = q.shape
    n = k.shape[1]
    out = torch.empty((b, m, heads * dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _bind(build.load("flash_attention"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, m, n, heads, hkv, d, dv,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale) * LOG2_E, int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_packed: kernel launch failed with CUDA error {rc}")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0

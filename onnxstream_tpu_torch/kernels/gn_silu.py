"""Fused GroupNorm + affine + optional SiLU (NCHW): the wrapper of the hand-written CUDA kernel and its twin.

Replaces the TPU kernel ``gn_silu_pallas`` of ``onnxstream_tpu/kernels/gn_silu.py``.
The converter decomposes GroupNorm into Reshape(N, G, -1) ->
InstanceNormalization(eps) -> Reshape -> Mul(gamma) -> Add(beta) [-> Sigmoid +
Mul]; ``runtime/fusion.fuse_groupnorm`` collapses that chain into one
``ostpu.gn_silu`` op, which lands here. All four parameter tensors are
honoured: the per-group InstanceNormalization scale and bias ``sg`` / ``sb``
(G,) and the per-channel ``gamma`` / ``beta`` ((C,) or (C, 1, 1)):

    mean, var = moments of x over each (n, group), var = max(E[x^2] - mean^2, 0)
    y = ((x - mean) * rsqrt(var + eps) * sg + sb) * gamma + beta
    y = y * sigmoid(y)          if silu

with the moments and the arithmetic in float32 and one cast to x's dtype.

``gn_silu_reference`` is the plain twin. The kernel (``csrc/gn_conv.cu``: a
moments pass that splits a group over blocks, a finalize pass, an apply pass,
launched back to back by one call) folds the affine into ``y = x * A_c + B_c``
and sums in another order; it agrees with the twin within 2e-5 (float32) and
2e-2 (bfloat16 / float16), the bars of the JAX package's own kernel tests.

On CUDA tensors ``gn_silu`` launches the kernel on the current stream, or
raises; on CPU tensors it computes the twin. Every launch adds one to
``gn_silu.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from onnxstream_tpu_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# elements a block of the moments pass sums (csrc/gn_conv.cu: a multiple of 8)
MOMENT_CHUNK = 8192

_FUNCS: Dict[str, object] = {}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    # dtype, x, out, sg, sb, gamma, beta, pdtype, partial, ab, N, C, HW, G, eps, silu, chunk, stream
    "ostt_gn_silu": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _L, _I, _F, _I, _I, _P],
    # dtype, x, out, sg, sb, gamma, beta, pdtype, w9, bias, bias_dtype, partial, ab, N, C, H, W, O, G,
    # eps, chunk, stream
    "ostt_gn_silu_conv": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                          _F, _I, _P],
}


def func(name: str):
    """A C entry point of ``csrc/gn_conv.cu``, built and loaded at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(build.load("gn_conv"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FUNCS[name] = fn
    return fn


def gn_silu_problem(shape: Sequence[int], groups: int, dtype: torch.dtype) -> Optional[str]:
    """Why the kernel cannot take an x of this shape and dtype, or None. It
    takes every (N, C, *spatial) with C % groups == 0 in float32, float16 or
    bfloat16 whose sizes fit its 32-bit indices."""
    if dtype not in DTYPE_CODE:
        return f"dtype {dtype}"
    if len(shape) < 3 or groups <= 0 or shape[1] % groups:
        return f"shape {tuple(shape)} with {groups} groups"
    n, c = shape[0], shape[1]
    hw = 1
    for d in shape[2:]:
        hw *= d
    if min(n, c, hw) <= 0 or hw >= 2**31 or n * c >= 2**31:
        return f"shape {tuple(shape)}"
    if -(-(c // groups) * hw // MOMENT_CHUNK) > 65535:
        return f"groups of {(c // groups) * hw} elements"
    return None


def gn_silu_reference(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """Plain twin. x: (N, C, H, W)."""
    n, c = x.shape[0], x.shape[1]
    xf = x.float().reshape(n, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    norm = (xf - mean) * torch.rsqrt(var + eps)
    norm = norm * sg.float().reshape(1, groups, 1) + sb.float().reshape(1, groups, 1)
    sh = (1, c) + (1,) * (x.ndim - 2)
    y = norm.reshape(x.shape) * gamma.float().reshape(sh) + beta.float().reshape(sh)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def norm_operands(name: str, x: torch.Tensor, params: Sequence[Optional[torch.Tensor]],
                  sizes: Sequence[int]) -> Tuple[list, int]:
    """The parameter vectors of a launch (None for an absent one) as flat
    contiguous tensors on x's device in one dtype the kernel reads (theirs
    when they share one, else float32), and that dtype's code. Raises on a
    wrong size or device."""
    present = [p for p in params if p is not None]
    for p, size in zip(params, sizes):
        if p is None:
            continue
        if p.device != x.device:
            raise ValueError(f"{name}: every operand must be on {x.device}, got {p.device}")
        if p.numel() != size:
            raise ValueError(f"{name}: a parameter of {p.numel()} values where {size} are needed")
    dt = present[0].dtype if present else torch.float32
    if dt not in DTYPE_CODE or any(p.dtype != dt for p in present):
        dt = torch.float32
    flat = [None if p is None else p.to(dt).reshape(-1).contiguous() for p in params]
    return flat, DTYPE_CODE[dt]


def workspaces(x: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chunk sums, (A_c, B_c) pairs) scratch of one launch, float32."""
    n, c = x.shape[0], x.shape[1]
    span = (c // groups) * (x.numel() // (n * c))
    splits = -(-span // MOMENT_CHUNK)
    return (torch.empty(n * groups * splits * 2, dtype=torch.float32, device=x.device),
            torch.empty(n * c * 2, dtype=torch.float32, device=x.device))


def gn_silu(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """x (N, C, *spatial), sg / sb (G,), gamma / beta C values -> x's shape and
    dtype. Requires C % groups == 0.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``gn_silu.launches``."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return gn_silu_reference(x, sg, sb, gamma, beta, groups, eps, silu)
        raise ValueError(f"gn_silu runs on CUDA or CPU tensors, not {x.device}")
    problem = gn_silu_problem(x.shape, groups, x.dtype)
    if problem is not None:
        raise ValueError(f"gn_silu: the kernel does not take {problem}")
    n, c = x.shape[0], x.shape[1]
    (sg, sb, gamma, beta), pcode = norm_operands("gn_silu", x, (sg, sb, gamma, beta),
                                                 (groups, groups, c, c))
    x = x.contiguous()
    out = torch.empty_like(x)
    partial, ab = workspaces(x, groups)
    fn = func("ostt_gn_silu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), sg.data_ptr(), sb.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), pcode, partial.data_ptr(), ab.data_ptr(),
                n, c, x.numel() // (n * c), groups, float(eps), int(bool(silu)), MOMENT_CHUNK, stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu: kernel launch failed with CUDA error {rc}")
    gn_silu.launches += 1
    return out


gn_silu.launches = 0

"""Fused GroupNorm + affine + SiLU + 3x3 convolution (NCHW): the wrapper of the hand-written CUDA kernel and its twin.

Replaces the TPU kernel ``gn_silu_conv_pallas`` of
``onnxstream_tpu/kernels/gn_conv.py``: the whole GroupNorm -> affine -> SiLU ->
Conv 3x3 (stride 1, pad 1, group 1) chain of a resnet block in one op
(``ostpu.gn_silu_conv``, produced by ``runtime/fusion.fuse_gn_conv``). The
normalised, activated slab is rounded once to the compute dtype and never
written to device memory; the convolution pads with zeros of the *activated*
tensor, accumulates in float32, adds the bias and casts.

The weight arrives tap-major, ``w9`` (9, O, C): the ``t9oc`` upload transform
(``runtime/planner.WEIGHT_TRANSFORMS``, ``oihw_to_w9`` here) relayouts the
(O, C, 3, 3) file weight once on the host, so each tap's (O, C) slice is a
row-major matrix operand as it lies.

``gn_silu_conv_reference`` is the plain twin (``kernels/gn_silu.gn_silu_reference``,
then a convolution of the ``w9_to_oihw`` weight with float32 accumulation).
The kernel (``csrc/gn_conv.cu``: the moments passes of ``gn_silu``, then an
implicit GEMM that normalises and activates as it stages) agrees with it
within 1e-4 of max|twin| in float32 and 2e-2 in bfloat16 / float16 (other
summation orders; a 16-bit activation may round the other way).

``gn_conv_problem`` is the predicate ``fuse_gn_conv`` asks before it fuses a
chain: it refuses only what the kernel cannot take, by shape and dtype.

On CUDA tensors ``gn_silu_conv`` launches the kernel on the current stream, or
raises; on CPU tensors it computes the twin. Every launch adds one to
``gn_silu_conv.launches``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.kernels.gn_silu import (
    DTYPE_CODE,
    MOMENT_CHUNK,
    func,
    gn_silu_problem,
    gn_silu_reference,
    norm_operands,
    workspaces,
)

CONV_BLOCK_O = 64  # output channels per block (csrc/gn_conv.cu kCvBM)


def w9_to_oihw(w9: torch.Tensor) -> torch.Tensor:
    """(9, O, C) upload layout -> (O, C, 3, 3) ONNX layout (the twin's form)."""
    nine, o, c = w9.shape
    if nine != 9:
        raise ValueError(f"w9 must be (9, O, C), got {tuple(w9.shape)}")
    return w9.reshape(3, 3, o, c).permute(2, 3, 0, 1)


def oihw_to_w9(w: np.ndarray) -> np.ndarray:
    """(O, C, 3, 3) -> (9, O, C): the ``t9oc`` upload transform (host side)."""
    o, c = w.shape[0], w.shape[1]
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1).reshape(9, o, c))


def gn_conv_problem(c: int, o: int, h: int, w: int, dtype: torch.dtype, groups: int = 1,
                    n: int = 1) -> Optional[str]:
    """Why the kernel cannot take a (n, c, h, w) slab convolved to o channels
    in this dtype, or None. Ragged O, C, H and W are masked inside the kernel,
    so only the dtype and the sizes of its 32-bit indices and grid refuse."""
    problem = gn_silu_problem((n, c, h, w), groups, dtype)
    if problem is not None:
        return problem
    if o <= 0 or -(-o // CONV_BLOCK_O) > 65535 or n * o >= 2**31:
        return f"{o} output channels"
    if n * (-(-h // 4)) * (-(-w // 8)) >= 2**31:
        return f"{n} x {h} x {w} output pixels"
    return None


def gn_silu_conv_reference(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, w9: torch.Tensor, bias: Optional[torch.Tensor],
                           groups: int, eps: float) -> torch.Tensor:
    """Plain twin. x: (N, C, H, W), w9: (9, O, C), bias: (O,) or None. The
    activated slab is rounded to x's dtype, as the kernel stages it; the
    convolution then runs in float32 on those values (the products of two
    16-bit numbers are exact in float32, so this is float32 accumulation)."""
    y = gn_silu_reference(x, sg, sb, gamma, beta, groups, eps, silu=True)
    w = w9_to_oihw(w9).to(y.dtype)
    out = F.conv2d(y.float(), w.float(), None, padding=1)
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out.to(x.dtype)


def gn_silu_conv(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, w9: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 groups: int, eps: float) -> torch.Tensor:
    """x (N, C, H, W), w9 (9, O, C) in x's dtype, bias (O,) or None ->
    (N, O, H, W) in x's dtype.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``gn_silu_conv.launches``."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return gn_silu_conv_reference(x, sg, sb, gamma, beta, w9, bias, groups, eps)
        raise ValueError(f"gn_silu_conv runs on CUDA or CPU tensors, not {x.device}")
    if x.ndim != 4 or w9.ndim != 3 or w9.shape[0] != 9 or w9.shape[2] != x.shape[1]:
        raise ValueError(f"gn_silu_conv: x (N, C, H, W) and w9 (9, O, C), got {tuple(x.shape)} and "
                         f"{tuple(w9.shape)}")
    n, c, h, w = x.shape
    o = w9.shape[1]
    problem = gn_conv_problem(c, o, h, w, x.dtype, groups, n)
    if problem is not None:
        raise ValueError(f"gn_silu_conv: the kernel does not take {problem}")
    if w9.device != x.device:
        raise ValueError(f"gn_silu_conv: every operand must be on {x.device}, got {w9.device}")
    (sg, sb, gamma, beta), pcode = norm_operands("gn_silu_conv", x, (sg, sb, gamma, beta),
                                                 (groups, groups, c, c))
    (bias,), bcode = norm_operands("gn_silu_conv", x, (bias,), (o,))
    x = x.contiguous()
    w9 = w9.to(x.dtype).contiguous()
    out = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device)
    partial, ab = workspaces(x, groups)
    fn = func("ostt_gn_silu_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), sg.data_ptr(), sb.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), pcode, w9.data_ptr(),
                None if bias is None else bias.data_ptr(), bcode, partial.data_ptr(), ab.data_ptr(),
                n, c, h, w, o, groups, float(eps), MOMENT_CHUNK, stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_conv: kernel launch failed with CUDA error {rc}")
    gn_silu_conv.launches += 1
    return out


gn_silu_conv.launches = 0

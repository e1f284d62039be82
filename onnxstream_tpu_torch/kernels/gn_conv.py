"""Fused GroupNorm + affine + SiLU + 3x3 convolution (NCHW): the wrapper of the hand-written CUDA kernel and its twin.

Replaces the TPU kernel ``gn_silu_conv_pallas`` of
``onnxstream_tpu/kernels/gn_conv.py``: the whole GroupNorm -> affine -> SiLU ->
Conv 3x3 (stride 1, pad 1, group 1) chain of a resnet block in one op
(``ostpu.gn_silu_conv``, produced by ``runtime/fusion.fuse_gn_conv``). The
normalised, activated slab is rounded once to the compute dtype; the
convolution pads with zeros of the *activated* tensor, accumulates in float32,
adds the bias and casts.

The weight arrives tap-major, ``w9`` (9, O, C): the ``t9oc`` upload transform
(``runtime/planner.WEIGHT_TRANSFORMS``, ``oihw_to_w9`` here) relayouts the
(O, C, 3, 3) file weight once on the host, so each tap's (O, C) slice is a
row-major matrix operand as it lies, K-major for the tensor cores.

Which variant of ``csrc/gn_conv.cu`` runs is a function of dtype, C and the
weight's alignment only (``gn_conv_variant``). 16-bit x with C % 8 == 0 takes
the ``wgmma`` pipeline of ``csrc/gemm_sm90.cuh``: the activated slab is first
written channels-last (N, H, W, C) into a workspace that this module
allocates once per device and grows (``_slab``; launches are ordered on one
stream). That is the one deliberate change from the TPU kernel, which never
writes the activated slab to device memory: here it is 2.6 - 5.2 MB at the
SD UNet's sites (it stays in L2) and one extra write and read at the VAE's
512 x 512 sites. The product then runs tiled and, where the tiles alone leave
SMs idle, split along K (``gn_conv_plan``: kernel 9's ``split_plan``); the
split's float32 partials meet in a workspace in a fixed order, so a call
gives the same bits every time. Other 16-bit shapes take the ``mma.sync``
kernel, float32 the full-float32 FMA kernel.

``gn_silu_conv_reference`` is the plain twin (``kernels/gn_silu.gn_silu_reference``,
then a convolution of the ``w9_to_oihw`` weight with float32 accumulation).
The kernel agrees with it within 1e-4 of max|twin| in float32 and 2e-2 in
bfloat16 / float16 (other summation orders; a 16-bit activation may round
the other way).

``gn_conv_problem`` is the predicate ``fuse_gn_conv`` asks before it fuses a
chain: it refuses only what no variant takes, by shape and dtype.

On CUDA tensors ``gn_silu_conv`` launches the kernel on the current stream, or
raises; on CPU tensors it computes the twin. Every launch adds one to
``gn_silu_conv.launches``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.kernels import KernelFunction, closed_over, count, folded, hold, register, unfolded
from onnxstream_tpu_torch.kernels.gn_silu import DTYPE_CODE, func, gn_silu_reference, norm_operands, norm_problem
from onnxstream_tpu_torch.kernels.matmul import split_plan

CONV_BLOCK_O = 64  # output channels per block of the mma.sync variant (csrc/gn_conv.cu kCvBM)
CONV_TILE_PIXELS = 128  # output pixels per tile of the wgmma variant (csrc/gn_conv.cu CvWgCfg::kBN)
CONV_TILE_C = 64  # input channels per k-tile of the wgmma variant, one tap's
# elements a block of the moments pass sums (csrc/gn_conv.cu: a multiple of 8)
MOMENT_CHUNK = 8192

# device -> the wgmma variant's channels-last slab workspace (bytes), grown as needed
_SLAB: Dict[torch.device, torch.Tensor] = {}


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
    in this dtype, or None. Ragged O, C, H and W are masked inside the
    kernels, so only the dtype and the sizes of their 32-bit indices and grids
    refuse."""
    problem = norm_problem((n, c, h, w), groups, dtype)
    if problem is not None:
        return problem
    if -(-(c // groups) * h * w // MOMENT_CHUNK) > 65535:
        return f"groups of {(c // groups) * h * w} elements"
    if o <= 0 or -(-o // CONV_BLOCK_O) > 65535 or n * o >= 2**31:
        return f"{o} output channels"
    if n * (-(-h // 4)) * (-(-w // 8)) >= 2**31:
        return f"{n} x {h} x {w} output pixels"
    if gn_conv_variant(dtype, c) == "wgmma" and (n > 65535 or n * h * w >= 2**31):
        return f"{n} x {h} x {w} output pixels"
    return None


def gn_conv_variant(dtype: torch.dtype, c: int, w9_ptr: int = 0) -> str:
    """Which convolution of ``csrc/gn_conv.cu`` a call runs on, as its
    dispatcher decides from dtype, C and the weight's alignment
    (``use_conv_wgmma`` there): ``"wgmma"`` for 16-bit x with C a multiple of
    8 (whole 16-byte pieces of the channels-last slab and of the weight's
    rows) and a 16-byte aligned w9, else ``"mma"`` (16-bit, masked) or
    ``"fma"`` (float32)."""
    if dtype == torch.float32:
        return "fma"
    if c % 8 == 0 and w9_ptr % 16 == 0:
        return "wgmma"
    return "mma"


def gn_conv_plan(n: int, c: int, h: int, w: int, o: int) -> Tuple[int, int]:
    """(bm, splits) of the wgmma variant: output channels a tile (64 or 128)
    and the K split, from the shape alone. The product is O x (N H W) with K
    = 9 taps x ceil(C / 64) k-tiles of 64 channels; kernel 9's ``split_plan``
    splits it where the tiles leave SMs idle. The split's workspace is splits
    * O * N H W float32 values."""
    return split_plan(o, 9 * -(-c // CONV_TILE_C) * CONV_TILE_C, n * h * w, CONV_TILE_PIXELS)


def workspaces(x: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chunk sums, (A_c, B_c) pairs) scratch of the moments passes of one
    launch, float32."""
    n, c = x.shape[0], x.shape[1]
    span = (c // groups) * (x.numel() // (n * c))
    splits = -(-span // MOMENT_CHUNK)
    return (torch.empty(n * groups * splits * 2, dtype=torch.float32, device=x.device),
            torch.empty(n * c * 2, dtype=torch.float32, device=x.device))


def _slab(x: torch.Tensor) -> torch.Tensor:
    """The wgmma variant's channels-last slab for x: x's element count in
    x's dtype, carved from a per-device byte workspace that only grows."""
    ws = _SLAB.get(x.device)
    nbytes = x.numel() * x.element_size()
    if ws is None or ws.numel() < nbytes:
        ws = _SLAB[x.device] = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    return hold(ws)


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


def gn_silu_conv_impl(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w9: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                      groups: int, eps: float) -> torch.Tensor:
    """The implementation of ``gn_silu_conv`` (``_GnSiluConv``'s forward) on
    real tensors."""
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
    slab, bm, splits, part = None, 0, 1, None
    if gn_conv_variant(x.dtype, c, w9.data_ptr()) == "wgmma":
        slab = _slab(x)
        bm, splits = gn_conv_plan(n, c, h, w, o)
        if splits > 1:
            part = torch.empty(splits * o * n * h * w, dtype=torch.float32, device=x.device)
    fn = func("ostt_gn_silu_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), sg.data_ptr(), sb.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), pcode, w9.data_ptr(),
                None if bias is None else bias.data_ptr(), bcode, partial.data_ptr(), ab.data_ptr(),
                n, c, h, w, o, groups, float(eps), MOMENT_CHUNK, None if slab is None else slab.data_ptr(),
                bm, splits, None if part is None else part.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_conv: kernel launch failed with CUDA error {rc}")
    count("gn_silu_conv")
    return out


class _GnSiluConv(KernelFunction):
    """``gn_silu_conv`` with a batching rule (``vmap``): the mapped axis
    folded into N, (V, N, C, H, W) -> (V N, C, H, W): exact, as the
    statistics are per sample; the workspaces and the slab are sized by the
    folded N. One launch."""

    @staticmethod
    def forward(x, sg, sb, gamma, beta, w9, bias, groups, eps):
        return gn_silu_conv_impl(x, sg, sb, gamma, beta, w9, bias, groups=groups, eps=eps)

    @staticmethod
    def vmap(info, in_dims, x, sg, sb, gamma, beta, w9, bias, groups, eps):
        closed_over("gn_silu_conv", in_dims[1:7], ("sg", "sb", "gamma", "beta", "w9", "the bias"))
        (x,) = folded(info.batch_size, in_dims[:1], x)
        return unfolded(_GnSiluConv.apply(x, sg, sb, gamma, beta, w9, bias, groups, eps), info.batch_size)


def gn_silu_conv(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, w9: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 groups: int, eps: float) -> torch.Tensor:
    """x (N, C, H, W), w9 (9, O, C) in x's dtype, bias (O,) or None ->
    (N, O, H, W) in x's dtype.

    On CUDA tensors it launches the kernel on the current stream, or raises;
    on CPU tensors it computes the plain twin. Every launch adds one to
    ``gn_silu_conv.launches``. Under ``torch.func.vmap`` the mapped axis
    folds into N, one launch a call."""
    return _GnSiluConv.apply(x, sg, sb, gamma, beta, w9, bias, groups, eps)


# one conv kernel a launch, after the moments passes (and the channels-last slab)
register("gn_silu_conv", gn_silu_conv,
         ("gn_conv_wgmma_kernel", "gn_conv_mma_kernel", "gn_conv_fma_kernel"))

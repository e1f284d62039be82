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

``gn_silu_reference`` is the plain twin. The kernel (``csrc/gn_conv.cu``
``gn_silu_cluster_kernel``) is one launch: a thread-block cluster of K CTAs per
(n, group) holds the group's span in shared memory, the CTAs exchange their
partial sums through distributed shared memory and apply from shared memory,
so x is read once and y written once, with no workspace. ``gn_silu_plan``
chooses K and how much of its piece a CTA keeps resident from the shape
alone; where a piece is larger than that, its rest is streamed for the sums
and read again for the apply. The kernel folds the affine
into ``y = x * A_c + B_c`` and sums in another order; it agrees with the twin
within 2e-5 (float32) and 2e-2 (bfloat16 / float16), the bars of the JAX
package's own kernel tests, and a second call gives the same bits.

On CUDA tensors ``gn_silu`` launches the kernel on the current stream, or
raises; on CPU tensors it computes the twin. Every launch adds one to
``gn_silu.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from onnxstream_tpu_torch.kernels import KernelFunction, build, closed_over, count, folded, register, unfolded

DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
CLUSTER_MAX = 16           # CTAs of a group at most (above 8 a non-portable cluster size; csrc kGnMaxCluster)
RESIDENT_BYTES = 229376    # dynamic shared memory of a CTA at most (csrc kGnResidentBytes)
PIECE_RESIDENT_BYTES = 32768  # of its piece a CTA keeps at most in shared memory: several CTAs an SM
GROUP_CHANNELS_MAX = 4096  # C / G at most: the group's (A_c, B_c) table (csrc kGnMaxGroupChannels)
ONE_CTA_BYTES = 24576      # a group no larger than this takes one CTA
MIN_PIECE_BYTES = 4096     # a split group's pieces no smaller than this

_FUNCS: Dict[str, object] = {}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    # dtype, x, out, sg, sb, gamma, beta, pdtype, N, C, HW, G, eps, silu, cluster, resident, stream
    "ostt_gn_silu": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _F, _I, _I, _I, _P],
    # dtype, silu, cluster, smem_bytes
    "ostt_gn_silu_active_clusters": [_I, _I, _I, _I],
    # dtype, x, out, sg, sb, gamma, beta, pdtype, w9, bias, bias_dtype, partial, ab, N, C, H, W, O, G,
    # eps, chunk, slab, bm, splits, part, stream
    "ostt_gn_silu_conv": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                          _F, _I, _P, _I, _I, _P, _P],
}


class GnSiluPlan(NamedTuple):
    """How the kernel lays one launch out: ``cluster`` CTAs per (n, group),
    each keeping up to ``resident`` 16-byte vectors of its piece in shared
    memory (``smem_bytes`` of it with the group's channel table)."""

    cluster: int
    resident: int
    smem_bytes: int


def func(name: str):
    """A C entry point of ``csrc/gn_conv.cu``, built and loaded at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(build.load("gn_conv"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FUNCS[name] = fn
    return fn


def norm_problem(shape: Sequence[int], groups: int, dtype: torch.dtype) -> Optional[str]:
    """What kernels 7 and 8 both refuse: a dtype other than float32, float16
    and bfloat16, C % groups != 0, no spatial axis, sizes past 32-bit
    indices."""
    if dtype not in DTYPE_CODE:
        return f"dtype {dtype}"
    if len(shape) < 3 or groups <= 0 or shape[1] % groups:
        return f"shape {tuple(shape)} with {groups} groups"
    n, c, hw = shape[0], shape[1], math.prod(shape[2:])
    if min(n, c, hw) <= 0 or hw >= 2**31 or n * c >= 2**31:
        return f"shape {tuple(shape)}"
    return None


def gn_silu_problem(shape: Sequence[int], groups: int, dtype: torch.dtype) -> Optional[str]:
    """Why the kernel cannot take an x of this shape and dtype, or None. It
    takes every (N, C, *spatial) with C % groups == 0 in float32, float16 or
    bfloat16 whose groups hold at most 4096 channels (their (A_c, B_c) table
    lives in shared memory) and fewer than 2^31 elements."""
    problem = norm_problem(shape, groups, dtype)
    if problem is not None:
        return problem
    n, c = shape[0], shape[1]
    span = (c // groups) * math.prod(shape[2:])
    if c // groups > GROUP_CHANNELS_MAX:
        return f"groups of {c // groups} channels"
    if span >= 2**31 or n * groups * CLUSTER_MAX >= 2**31:
        return f"groups of {span} elements"
    return None


def gn_silu_plan(n: int, c: int, hw: int, groups: int, dtype: torch.dtype) -> GnSiluPlan:
    """The launch of one call, from the shape alone (the C entry takes it
    as given and refuses a plan it cannot run). A group of at most 24 KB is
    one CTA: the UNet's 8 x 8 and 16 x 16 levels, where the latency of one
    CTA's load, sum and store is the cost. A larger group is split into the
    most CTAs, a power of two up to 16, whose pieces keep at least 4 KB. A
    CTA keeps up to 32 KB of its piece resident, so that many CTAs share an
    SM; the rest of a larger piece (the VAE's 1 to 4 MB groups) is streamed
    for the sums and read again, mostly from L2, for the apply. K halves
    while a piece would be empty. (Chosen by device time at every site of
    the UNet's and the VAE's GroupNorm routes on an H100, against the
    alternatives that tools/torch_gn_silu_plans.py times.)"""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    v, cg = 16 // itemsize, c // groups
    length = cg * hw
    nbytes = length * itemsize
    nv = length // v  # vectors of a group's body: this many, or one fewer where it starts off a boundary
    table = -(-cg * 8 // 16) * 16
    k = 1
    if nbytes > ONE_CTA_BYTES:
        while 2 * k <= CLUSTER_MAX and nbytes // (2 * k) >= MIN_PIECE_BYTES:
            k *= 2
    while k > 1 and nv - 1 < k:
        k //= 2
    resident = min(-(-nv // k), PIECE_RESIDENT_BYTES // 16)
    return GnSiluPlan(k, resident, resident * 16 + table)


def active_clusters(plan: GnSiluPlan, dtype: torch.dtype, silu: bool = True) -> int:
    """Clusters of this plan's shape the card holds at once (CUDA's
    cudaOccupancyMaxActiveClusters on the current device), -1 if the query
    fails. Builds the kernel."""
    return func("ostt_gn_silu_active_clusters")(DTYPE_CODE[dtype], int(bool(silu)), plan.cluster, plan.smem_bytes)


def gn_silu_pieces(plan: GnSiluPlan, length: int, start: int, itemsize: int) -> List[Tuple[int, int, int]]:
    """(first element, end, resident vectors) of each CTA's piece of a group
    of ``length`` elements that starts at element ``start`` of a 16-byte
    aligned x, as the kernel cuts it: the group's whole 16-byte vectors in K
    runs, rank 0 also taking the ragged head and rank K - 1 the tail."""
    v, k = 16 // itemsize, plan.cluster
    end = start + length
    gb = min(end, -(-start // v) * v)
    ge = max(gb, end // v * v)
    nv = (ge - gb) // v
    pieces = []
    for r in range(k):
        v0, v1 = nv * r // k, nv * (r + 1) // k
        pieces.append((start if r == 0 else gb + v0 * v, end if r == k - 1 else gb + v1 * v,
                       min(plan.resident, v1 - v0)))
    return pieces


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


def launch(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           groups: int, eps: float, silu: bool, plan: Optional[GnSiluPlan] = None) -> torch.Tensor:
    """The kernel on CUDA tensors under the given plan, ``gn_silu_plan``'s by
    default; raises where the kernel refuses the shape or the C entry the
    plan. Counts no launch."""
    problem = gn_silu_problem(x.shape, groups, x.dtype)
    if problem is not None:
        raise ValueError(f"gn_silu: the kernel does not take {problem}")
    n, c = x.shape[0], x.shape[1]
    plan = plan or gn_silu_plan(n, c, x.numel() // (n * c), groups, x.dtype)
    (sg, sb, gamma, beta), pcode = norm_operands("gn_silu", x, (sg, sb, gamma, beta),
                                                 (groups, groups, c, c))
    x = x.contiguous()
    if x.data_ptr() % 16:  # the bulk copies start on 16-byte boundaries of x
        x = x.clone()
    out = torch.empty_like(x)
    fn = func("ostt_gn_silu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), sg.data_ptr(), sb.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), pcode, n, c, x.numel() // (n * c), groups, float(eps),
                int(bool(silu)), plan.cluster, plan.resident, stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu: kernel launch failed with CUDA error {rc}")
    return out


def gn_silu_impl(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The implementation of ``gn_silu`` (``_GnSilu``'s forward) on real
    tensors."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return gn_silu_reference(x, sg, sb, gamma, beta, groups, eps, silu)
        raise ValueError(f"gn_silu runs on CUDA or CPU tensors, not {x.device}")
    out = launch(x, sg, sb, gamma, beta, groups, eps, silu)
    count("gn_silu")
    return out


class _GnSilu(KernelFunction):
    """``gn_silu`` with a batching rule (``vmap``): the mapped axis folded
    into N, (V, N, C, ...) -> (V N, C, ...): exact, as the statistics are per
    sample; one launch."""

    @staticmethod
    def forward(x, sg, sb, gamma, beta, groups, eps, silu):
        return gn_silu_impl(x, sg, sb, gamma, beta, groups, eps, silu)

    @staticmethod
    def vmap(info, in_dims, x, sg, sb, gamma, beta, groups, eps, silu):
        closed_over("gn_silu", in_dims[1:5], ("sg", "sb", "gamma", "beta"))
        (x,) = folded(info.batch_size, in_dims[:1], x)
        return unfolded(_GnSilu.apply(x, sg, sb, gamma, beta, groups, eps, silu), info.batch_size)


def gn_silu(x: torch.Tensor, sg: torch.Tensor, sb: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """x (N, C, *spatial), sg / sb (G,), gamma / beta C values -> x's shape and
    dtype. Requires C % groups == 0.

    On CUDA tensors it launches the kernel on the current stream under
    ``gn_silu_plan``, or raises; on CPU tensors it computes the plain twin.
    Every launch adds one to ``gn_silu.launches``. Under ``torch.func.vmap``
    the mapped axis folds into N, one launch a call."""
    return _GnSilu.apply(x, sg, sb, gamma, beta, groups, eps, silu)


register("gn_silu", gn_silu, ("gn_silu_cluster_kernel",))

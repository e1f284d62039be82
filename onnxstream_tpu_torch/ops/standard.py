"""The standard operator library (the UNet and TinyLlama slices).

Counterpart of ``onnxstream_tpu/ops/standard.py`` for the op types of the
fused SD UNet graph: Add, Concat, Conv, Cos, Div, Erf, InstanceNormalization,
MatMul, Mul, Pow, ReduceMean, Reshape, Resize, Sigmoid, Sin, Split, Sqrt, Sub,
Transpose, Unsqueeze; of the fused llama graph beyond those: ArgMax, Expand,
Gather, Identity, Less, Neg, ScatterND, Where (this file); the fused
GroupNorm ops ``ostpu.gn_silu`` and ``ostpu.gn_silu_conv`` (this file, through
the kernels of ``kernels/gn_silu.py`` and ``kernels/gn_conv.py``); and
``ostpu.sdpa`` (``ops/attention.py``). Any other op type raises
``NotImplementedError`` from the registry.

Device integers are 32-bit, as in the JAX package: int64 graph inputs arrive
as int32 and ``_align_binary`` narrows int64 in device ops. torch's indexing
(Gather, ScatterND) takes int64 indices, so those two widen their index
operand on the device right where they index, and nothing else changes.

The bodies are written once in torch and serve three callers: the planner's
shape inference on ``meta`` tensors, host folding on CPU tensors, and the
executor on ``SessionConfig.device``. Operands that are statically known
arrive as numpy arrays and are placed on ``ctx.device`` where an op computes
with them. The dtype policy is the JAX package's: ``_align_binary`` for
elementwise operands, float32 islands for reductions and normalisation, and
float32 accumulation for matrix products (``runtime/executor.py`` pins the
backend precision flags for the whole run).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.dtypes import dtype_name, to_torch, torch_dtype
from onnxstream_tpu_torch.kernels.gn_conv import gn_silu_conv, gn_silu_conv_reference
from onnxstream_tpu_torch.kernels.gn_silu import gn_silu, gn_silu_reference
from onnxstream_tpu_torch.kernels.matmul import conv3x3_im2col
from onnxstream_tpu_torch.ops import Ctx, register

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_FLOAT_ORDER = {"float16": 0, "bfloat16": 0, "float32": 1, "float64": 2}


def _dt(x) -> str:
    return dtype_name(x.dtype)


def _is_float(x) -> bool:
    return _dt(x) in _FLOAT_ORDER


def _is_static(x) -> bool:
    return isinstance(x, np.ndarray)


def _tensor(ctx: Ctx, x) -> torch.Tensor:
    """A static numpy operand becomes a tensor on the op's device."""
    return ctx.tensor(x)


def _astype(ctx: Ctx, x, dtype) -> torch.Tensor:
    return _tensor(ctx, x).to(torch_dtype(dtype))


def _align_binary(ctx: Ctx, a, b):
    """Align dtypes of two operands for an elementwise op; returns tensors.

    Policy (the JAX package's): a static (host-constant) operand adopts the
    dtype of the other one; two floats of different width promote to the
    wider; int+float promotes to the float dtype; bool+int promotes to the
    int dtype; device integers are 32-bit.
    """
    da, db = _dt(a), _dt(b)
    if da == db:
        return _tensor(ctx, a), _tensor(ctx, b)
    fa, fb = da in _FLOAT_ORDER, db in _FLOAT_ORDER
    if fa and fb:
        if _is_static(a) and not _is_static(b):
            return _astype(ctx, a, b.dtype), b
        if _is_static(b) and not _is_static(a):
            return a, _astype(ctx, b, a.dtype)
        if _FLOAT_ORDER[da] >= _FLOAT_ORDER[db]:
            return _tensor(ctx, a), _astype(ctx, b, a.dtype)
        return _astype(ctx, a, b.dtype), _tensor(ctx, b)
    if fa and not fb:
        return _tensor(ctx, a), _astype(ctx, b, a.dtype)
    if fb and not fa:
        return _astype(ctx, a, b.dtype), _tensor(ctx, b)
    # both integral / bool
    if da == "bool":
        return _astype(ctx, a, b.dtype), _tensor(ctx, b)
    if db == "bool":
        return _tensor(ctx, a), _astype(ctx, b, a.dtype)
    wider = a.dtype if torch_dtype(a.dtype).itemsize >= torch_dtype(b.dtype).itemsize else b.dtype
    if ctx.mode == "device" and torch_dtype(wider) == torch.int64:
        wider = torch.int32  # device integers are 32-bit
    return _astype(ctx, a, wider), _astype(ctx, b, wider)


def _binary(fn):
    def impl(ctx: Ctx, op, ins):
        a, b = _align_binary(ctx, ins[0], ins[1])
        return [fn(a, b)]

    return impl


def _f32_island(x: torch.Tensor, body):
    """Run `body` in float32 and cast back to x's dtype (if x is a
    low-precision float)."""
    if _is_float(x) and x.dtype != torch.float32:
        return body(x.float()).to(x.dtype)
    return body(x)


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------


def _div(a, b):
    if a.is_floating_point():
        return a / b
    # ONNX integer Div truncates toward zero (C semantics)
    return torch.div(a, b, rounding_mode="trunc")


register("Mul", host=True)(_binary(lambda a, b: a * b))
register("Add", host=True)(_binary(lambda a, b: a + b))
register("Sub", host=True)(_binary(lambda a, b: a - b))
register("Div", host=True)(_binary(_div))
register("Less", host=True)(_binary(lambda a, b: a < b))


@register("Pow", host=True)
def _pow(ctx: Ctx, op, ins):
    a, b = ins
    if _is_float(a) and not _is_float(b):
        b = _astype(ctx, b, a.dtype)
    a, b = _align_binary(ctx, a, b)
    return [torch.pow(a, b)]


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------


def _unary(fn):
    def impl(ctx: Ctx, op, ins):
        return [fn(_tensor(ctx, ins[0]))]

    return impl


register("Neg", host=True)(_unary(torch.neg))
register("Identity", host=True)(_unary(lambda x: x))
register("Sqrt", host=True)(_unary(torch.sqrt))
register("Cos", host=True)(_unary(torch.cos))
register("Sin", host=True)(_unary(torch.sin))
register("Sigmoid")(_unary(torch.sigmoid))
register("Erf")(_unary(lambda x: _f32_island(x, torch.erf)))


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def _axes_from(ctx: Ctx, op, ins, index: int, attr_name: str = "axes"):
    """axes come from an attr (opset<13) or a static int64 input (opset>=13)."""
    if attr_name in op.attrs:
        return list(op.attr_ints(attr_name))
    if len(ins) > index and ins[index] is not None:
        return [int(v) for v in ctx.static(ins, index, attr_name).reshape(-1)]
    return None


@register("Unsqueeze", host=True)
def _unsqueeze(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    axes = _axes_from(ctx, op, ins, 1)
    out_rank = x.ndim + len(axes)
    for a in sorted(a % out_rank for a in axes):
        x = x.unsqueeze(a)
    return [x]


@register("Reshape", host=True)
def _reshape(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    shape = [int(v) for v in ctx.static(ins, 1, "Reshape.shape").reshape(-1)]
    allowzero = op.attr_int("allowzero", 0)
    out = [x.shape[i] if d == 0 and not allowzero else d for i, d in enumerate(shape)]
    return [x.reshape(out)]


@register("Transpose", host=True)
def _transpose(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    perm = op.attr_ints("perm")
    if perm is None:
        perm = tuple(reversed(range(x.ndim)))
    return [x.permute(*perm)]


@register("Expand", host=True)
def _expand(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    shape = [int(v) for v in ctx.static(ins, 1, "Expand.shape").reshape(-1)]
    # ONNX Expand uses bidirectional broadcast: out dim = max(in, requested)
    rank = max(x.ndim, len(shape))
    in_shape = (1,) * (rank - x.ndim) + tuple(x.shape)
    shape = [1] * (rank - len(shape)) + shape
    target = tuple(max(a, b) for a, b in zip(in_shape, shape))
    return [x.reshape(in_shape).expand(target)]


@register("Concat", host=True)
def _concat(ctx: Ctx, op, ins):
    axis = op.attr_int("axis")
    vals = [v for v in ins if v is not None]
    # align dtypes pairwise against the first non-static operand
    ref = next((v for v in vals if not _is_static(v)), vals[0])
    aligned = []
    for v in vals:
        if _dt(v) != _dt(ref):
            v, _ = _align_binary(ctx, v, ref)
        aligned.append(_tensor(ctx, v))
    return [torch.cat(aligned, dim=axis)]


@register("Split", host=True)
def _split(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    axis = op.attr_int("axis", 0) % x.ndim
    sizes = None
    if "split" in op.attrs:
        sizes = list(op.attr_ints("split"))
    elif len(ins) > 1 and ins[1] is not None:
        sizes = [int(v) for v in ctx.static(ins, 1, "Split.split").reshape(-1)]
    n_out = len(op.outputs)
    if sizes is None:
        d = x.shape[axis]
        base = -(-d // n_out)
        sizes = [base] * n_out
        sizes[-1] = d - base * (n_out - 1)
        if sizes[-1] < 0:
            raise ValueError(f"Split: axis dim {d} cannot make {n_out} even chunks")
    outs = []
    off = 0
    for s in sizes:
        outs.append(x.narrow(axis, off, s))
        off += s
    return outs


# ---------------------------------------------------------------------------
# data movement / indexing
# ---------------------------------------------------------------------------


@register("Gather", host=True)
def _gather(ctx: Ctx, op, ins):
    x, idx = _tensor(ctx, ins[0]), _tensor(ctx, ins[1])
    axis = op.attr_int("axis", 0) % x.ndim
    dim = x.shape[axis]
    idx = idx.long()  # torch indexes with int64; device ids arrive as int32
    idx = torch.where(idx < 0, idx + dim, idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return [out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))]


@register("Where", host=True)
def _where(ctx: Ctx, op, ins):
    cond, a, b = ins
    cond = _tensor(ctx, cond)
    if cond.dtype != torch.bool:
        cond = cond != 0
    a, b = _align_binary(ctx, a, b)
    return [torch.where(cond, a, b)]


@register("ScatterND")
def _scatternd(ctx: Ctx, op, ins):
    """Out of place, as ``.at[].set`` in the JAX package: the data operand
    (a KV cache fed back by the caller) is not written."""
    data, indices, updates = (_tensor(ctx, v) for v in ins)
    depth = indices.shape[-1]
    idx = indices.reshape(-1, depth).long()
    upd = updates.reshape((-1,) + tuple(data.shape[depth:])).to(data.dtype)
    return [data.index_put(tuple(idx[:, j] for j in range(depth)), upd)]


# ---------------------------------------------------------------------------
# reductions & normalization
# ---------------------------------------------------------------------------


@register("ReduceMean", host=True)
def _reduce_mean(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    axes = _axes_from(ctx, op, ins, 1)
    keepdims = bool(op.attr_int("keepdims", 1))
    ax = tuple(a % x.ndim for a in axes) if axes else tuple(range(x.ndim))
    return [_f32_island(x, lambda v: v.mean(dim=ax, keepdim=keepdims))]


@register("ArgMax", host=True)
def _argmax(ctx: Ctx, op, ins):
    """The first maximum, as ``jnp.argmax`` (the last with
    ``select_last_index``); int64 on the host, int32 on the device."""
    x = _tensor(ctx, ins[0])
    axis = op.attr_int("axis", 0) % x.ndim
    keepdims = bool(op.attr_int("keepdims", 1))
    if op.attr_int("select_last_index", 0):
        idx = x.shape[axis] - 1 - torch.argmax(torch.flip(x, dims=(axis,)), dim=axis, keepdim=keepdims)
    else:
        idx = torch.argmax(x, dim=axis, keepdim=keepdims)
    return [idx.to(torch.int64 if ctx.mode == "host" else torch.int32)]


@register("InstanceNormalization")
def _instance_norm(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    scale, bias = _tensor(ctx, ins[1]), _tensor(ctx, ins[2])
    eps = op.attr_float("epsilon", 1e-5)
    xf = x.float()
    red = tuple(range(2, x.ndim))
    # one-pass statistics: E[x] and E[x^2], both accumulated in float32
    mean = xf.mean(dim=red, keepdim=True)
    mean2 = (xf * xf).mean(dim=red, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    norm = (xf - mean) * torch.rsqrt(var + eps)
    sh = (1, -1) + (1,) * (x.ndim - 2)
    out = norm * scale.float().reshape(sh) + bias.float().reshape(sh)
    return [out.to(x.dtype)]


@register("ostpu.gn_silu")
def _gn_silu_op(ctx: Ctx, op, ins):
    """Fused GroupNorm + per-channel affine + optional SiLU (NCHW), produced
    by runtime/fusion.fuse_groupnorm from the converter's Reshape ->
    InstanceNormalization -> Reshape -> Mul -> Add [-> Sigmoid + Mul] chain.
    The CUDA kernel of kernels/gn_silu.py on the card, its plain twin on the
    CPU and for the planner's meta tensors."""
    x, sg, sb, gamma, beta = (_tensor(ctx, v) for v in ins[:5])
    groups = op.attr_int("groups")
    eps = op.attr_float("epsilon", 1e-5)
    silu = bool(op.attr_int("silu", 0))
    fn = gn_silu_reference if x.device.type == "meta" else gn_silu
    return [fn(x, sg, sb, gamma, beta, groups, eps, silu)]


@register("ostpu.gn_silu_conv")
def _gn_silu_conv_op(ctx: Ctx, op, ins):
    """Fused GroupNorm + affine + SiLU + Conv3x3 (s1 p1 g1), produced by
    runtime/fusion.fuse_gn_conv; the weight arrives in the (9, O, C) upload
    transform and the optional 7th input is the bias. The CUDA kernel of
    kernels/gn_conv.py on the card, its plain twin on the CPU and for the
    planner's meta tensors."""
    x, sg, sb, gamma, beta, w9 = (_tensor(ctx, v) for v in ins[:6])
    bias = _tensor(ctx, ins[6]) if len(ins) > 6 and ins[6] is not None else None
    groups = op.attr_int("groups")
    eps = op.attr_float("epsilon", 1e-5)
    x, w9 = _align_binary(ctx, x, w9)
    if x.device.type == "meta":
        return [gn_silu_conv_reference(x, sg, sb, gamma, beta, w9, bias, groups, eps)]
    return [gn_silu_conv(x, sg, sb, gamma, beta, w9, bias, groups=groups, eps=eps)]


# ---------------------------------------------------------------------------
# matmul & convolution
# ---------------------------------------------------------------------------


@register("MatMul")
def _matmul(ctx: Ctx, op, ins):
    # float32 accumulation for every float dtype: cuBLAS accumulates bf16/fp16
    # products in float32 once reduced-precision reductions are off, which
    # the executor pins for the run
    a, b = _align_binary(ctx, ins[0], ins[1])
    return [torch.matmul(a, b)]


@register("Conv")
def _conv(ctx: Ctx, op, ins):
    x, w = _tensor(ctx, ins[0]), ins[1]
    b = ins[2] if len(ins) > 2 and ins[2] is not None else None
    if x.ndim != 4:
        raise NotImplementedError(f"Conv of rank {x.ndim} is not ported (2-D NCHW only)")
    group = op.attr_int("group", 1)
    strides = list(op.attr_ints("strides", [1, 1]))
    dilations = list(op.attr_ints("dilations", [1, 1]))
    pt, pl, pb, pr = op.attr_ints("pads", [0, 0, 0, 0])
    x, w = _align_binary(ctx, x, w)
    if (
        group == 1
        and ctx.mode == "device"
        and x.device.type != "meta"
        and _is_float(x)
        and getattr(ctx.config, "use_pallas_smallconv", False)
        and tuple(w.shape[2:]) == (3, 3)
        and strides == [1, 1]
        and dilations == [1, 1]
        and (pt, pl, pb, pr) == (1, 1, 1, 1)
        and x.shape[1] % 128 == 0
        and w.shape[0] % 128 == 0
        and x.shape[2] * x.shape[3] <= 1024
        and (x.shape[0] * x.shape[2] * x.shape[3]) % 8 == 0
    ):
        # small-spatial 3x3 convs as im2col + the tiled matmul kernel
        # (kernels/matmul.py); the planner's meta tensors take the plain
        # convolution below, whose output has the same shape and dtype
        bb = None if b is None else _astype(ctx, b, x.dtype)
        y = conv3x3_im2col(x.permute(0, 2, 3, 1), w, bb)
        return [y.permute(0, 3, 1, 2)]
    if (pt, pl) == (pb, pr):
        padding = (pt, pl)
    else:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = (0, 0)
    bb = None if b is None else _astype(ctx, b, x.dtype)
    return [F.conv2d(x, w, bb, stride=strides, padding=padding, dilation=dilations, groups=group)]


# ---------------------------------------------------------------------------
# Resize (nearest + linear). Index vectors are computed on the host from the
# static scales/sizes, so on the device the op is index_select gathers.
# ---------------------------------------------------------------------------


def _resize_coords(out_dim: int, in_dim: int, scale: float, mode: str) -> np.ndarray:
    x_out = np.arange(out_dim, dtype=np.float64)
    if mode == "half_pixel":
        return (x_out + 0.5) / scale - 0.5
    if mode == "pytorch_half_pixel":
        return (x_out + 0.5) / scale - 0.5 if out_dim > 1 else np.zeros(out_dim)
    if mode == "align_corners":
        if out_dim == 1:
            return np.zeros(out_dim)
        return x_out * (in_dim - 1) / (out_dim - 1)
    if mode == "asymmetric":
        return x_out / scale
    raise NotImplementedError(f"Resize coordinate_transformation_mode {mode!r}")


@register("Resize")
def _resize(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    # inputs: X, roi?, scales?, sizes?
    scales = None
    sizes = None
    if len(ins) > 2 and ins[2] is not None:
        s = ctx.static(ins, 2, "Resize.scales").reshape(-1)
        if s.size:
            scales = [float(v) for v in s]
    if len(ins) > 3 and ins[3] is not None:
        s = ctx.static(ins, 3, "Resize.sizes").reshape(-1)
        if s.size:
            sizes = [int(v) for v in s]
    mode = op.attr("mode", "nearest")
    coord = op.attr("coordinate_transformation_mode", "half_pixel")
    nearest_mode = op.attr("nearest_mode", "round_prefer_floor")

    in_shape = list(x.shape)
    if sizes is not None:
        out_shape = sizes
        scales = [o / i for o, i in zip(out_shape, in_shape)]
    else:
        out_shape = [int(math.floor(i * s)) for i, s in zip(in_shape, scales)]

    def index(idx: np.ndarray) -> torch.Tensor:
        return ctx.derived(idx.astype(np.int64))

    out = x
    for axis in range(x.ndim):
        if out_shape[axis] == in_shape[axis] and scales[axis] == 1.0:
            continue
        coords = _resize_coords(out_shape[axis], in_shape[axis], scales[axis], coord)
        if mode == "nearest":
            if nearest_mode == "floor":
                idx = np.floor(coords)
            elif nearest_mode == "ceil":
                idx = np.ceil(coords)
            elif nearest_mode == "round_prefer_floor":
                idx = np.ceil(coords - 0.5)
            else:  # round_prefer_ceil
                idx = np.floor(coords + 0.5)
            idx = np.clip(idx, 0, in_shape[axis] - 1)
            out = torch.index_select(out, axis, index(idx))
        elif mode == "linear":
            lo = np.clip(np.floor(coords), 0, in_shape[axis] - 1).astype(np.int64)
            hi = np.clip(lo + 1, 0, in_shape[axis] - 1)
            frac = np.clip(coords - lo, 0.0, 1.0).astype(np.float32)
            shape = [1] * out.ndim
            shape[axis] = out_shape[axis]
            w = ctx.derived(frac.reshape(shape))
            g_lo = torch.index_select(out, axis, index(lo)).float()
            g_hi = torch.index_select(out, axis, index(hi)).float()
            out = (g_lo * (1.0 - w) + g_hi * w).to(out.dtype)
        else:
            raise NotImplementedError(f"Resize mode {mode!r}")
    return [out]

"""The standard operator library.

Counterpart of ``onnxstream_tpu/ops/standard.py``: every op type of the JAX
registry, with the same attribute defaults, float32 islands and refusals. It
holds the op types of the fused SD UNet, llama, Whisper and YOLO graphs and
of converted ONNX graphs (elementwise, shape and index math, reductions,
normalisation, Gemm, Conv of rank 3 and 4, pooling, Resize); the fused
GroupNorm ops ``ostpu.gn_silu`` and ``ostpu.gn_silu_conv`` (through the
kernels of ``kernels/gn_silu.py`` and ``kernels/gn_conv.py``); the small-conv
rewrite's ``ostpu.conv3x3_im2col``; ``ostpu.sdpa`` (``ops/attention.py``); and
what the channel-last layout pass (``runtime/layout.py``) emits: the
``layout:NHWC`` forms of Conv, MaxPool, AveragePool, GlobalAveragePool and
Resize, ``ostpu.groupnorm`` and ``ostpu.reshape``. An NHWC activation is a
contiguous (N, H, W, C) tensor. Any other op type raises
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
register("Greater", host=True)(_binary(lambda a, b: a > b))
register("Equal", host=True)(_binary(lambda a, b: a == b))
register("And", host=True)(_binary(lambda a, b: a.bool() & b.bool()))
register("Or", host=True)(_binary(lambda a, b: a.bool() | b.bool()))
register("Min", host=True)(_binary(torch.minimum))
register("Max", host=True)(_binary(torch.maximum))


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
register("Exp")(_unary(torch.exp))
register("Log")(_unary(torch.log))
register("Abs", host=True)(_unary(torch.abs))
register("Tanh")(_unary(torch.tanh))
register("Relu")(_unary(lambda x: torch.clamp_min(x, 0)))
register("Not", host=True)(_unary(lambda x: ~x.bool()))
# integers are their own floor and ceiling, as in numpy
register("Floor", host=True)(_unary(lambda x: torch.floor(x) if x.is_floating_point() else x))
register("Ceil", host=True)(_unary(lambda x: torch.ceil(x) if x.is_floating_point() else x))


def _scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    """An attribute constant in x's dtype (rounded to it first, as
    ``jnp.asarray(v, x.dtype)``), made by a fill on x's device: no
    host-to-device copy, so a CUDA graph can capture it."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


@register("LeakyRelu")
def _leaky_relu(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    return [torch.where(x >= 0, x, x * _scalar(x, op.attr_float("alpha", 0.01)))]


@register("Gelu")
def _gelu(ctx: Ctx, op, ins):
    approx = "tanh" if op.attr("approximate", "none") == "tanh" else "none"
    return [_f32_island(_tensor(ctx, ins[0]), lambda v: F.gelu(v, approximate=approx))]


@register("HardSigmoid")
def _hard_sigmoid(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    y = x * _scalar(x, op.attr_float("alpha", 0.2)) + _scalar(x, op.attr_float("beta", 0.5))
    return [torch.clamp(y, 0, 1)]


@register("Clip")
def _clip(ctx: Ctx, op, ins):
    """min and max are optional inputs (opset >= 11), each in x's dtype."""
    x = _tensor(ctx, ins[0])
    lo = ins[1] if len(ins) > 1 and ins[1] is not None else None
    hi = ins[2] if len(ins) > 2 and ins[2] is not None else None
    if lo is not None:
        x = torch.maximum(x, _astype(ctx, lo, x.dtype))
    if hi is not None:
        x = torch.minimum(x, _astype(ctx, hi, x.dtype))
    return [x]


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


@register("Squeeze", host=True)
def _squeeze(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    axes = _axes_from(ctx, op, ins, 1)
    if axes is None:
        return [x.squeeze()]
    return [x.squeeze(tuple(a % x.ndim for a in axes))]


@register("Flatten", host=True)
def _flatten(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    axis = op.attr_int("axis", 1)
    if axis < 0:
        axis += x.ndim  # axis in [-r, r]; -1 is the last axis
    if not 0 <= axis <= x.ndim:
        raise ValueError(f"Flatten: axis {op.attr_int('axis', 1)} out of range for rank {x.ndim}")
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return [x.reshape(lead, -1)]


@register("Slice", host=True)
def _slice(ctx: Ctx, op, ins):
    """numpy's slice semantics, as the JAX op: negative starts and ends wrap,
    ends beyond the dim (INT64_MAX) clamp, steps may be negative; starts,
    ends, axes and steps are static inputs."""
    x = _tensor(ctx, ins[0])
    starts = [int(v) for v in ctx.static(ins, 1, "Slice.starts").reshape(-1)]
    ends = [int(v) for v in ctx.static(ins, 2, "Slice.ends").reshape(-1)]
    axes = None
    if len(ins) > 3 and ins[3] is not None:
        axes = [int(v) for v in ctx.static(ins, 3, "Slice.axes").reshape(-1)]
    steps = None
    if len(ins) > 4 and ins[4] is not None:
        steps = [int(v) for v in ctx.static(ins, 4, "Slice.steps").reshape(-1)]
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.ndim
        dim = x.shape[ax]
        r = range(dim)[slice(min(st, dim), min(en, dim), sp)]
        if sp > 0:
            x = x[(slice(None),) * ax + (slice(r.start, r.stop, r.step),)]
        else:  # torch slices take no negative step: gather the indices numpy's slice picks
            x = torch.index_select(x, ax, ctx.derived(np.asarray(r, np.int64)))
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


def shape_slice(shape, op):
    """opset-15 start/end attrs: a [start:end) window of the shape vector,
    negative values wrapping on the rank (spec Shape-15). The planner folds
    Shape with it from the input's shape, device tensors included."""
    r = len(shape)
    start = op.attr_int("start", 0)
    end = op.attr_int("end", r)
    if start < 0:
        start += r
    if end < 0:
        end += r
    start = min(max(start, 0), r)
    end = min(max(end, 0), r)
    return tuple(shape)[start:max(start, end)]


@register("Shape", host=True)
def _shape(ctx: Ctx, op, ins):
    return [torch.tensor(shape_slice(tuple(ins[0].shape), op), dtype=torch.int64)]


@register("Trilu", host=True)
def _trilu(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    k = 0
    if len(ins) > 1 and ins[1] is not None:
        k = int(ctx.static(ins, 1, "Trilu.k").reshape(-1)[0])
    return [torch.triu(x, k) if op.attr_int("upper", 1) else torch.tril(x, k)]


def _made_on_host(ctx: Ctx, arr: np.ndarray) -> torch.Tensor:
    """An op's result made with numpy from static operands: a CPU tensor when
    folded, and on the op's device when the planner had to pin a weight or an
    input for it (a device op), where integers are 32-bit."""
    if ctx.mode == "host":
        return torch.from_numpy(arr)
    return ctx.derived(arr.astype(np.int32) if arr.dtype == np.int64 else arr)


@register("ConstantOfShape", host=True)
def _constant_of_shape(ctx: Ctx, op, ins):
    """The value attribute as the converter writes it, with its dtype
    ("int64:0", "float32:0.0"); a bare scalar (reference-converted models)
    is float32 whatever its spelling, as the reference's std::stof."""
    shape = [int(v) for v in ctx.static(ins, 0, "ConstantOfShape.shape").reshape(-1)]
    value = op.attr("value", "0")
    dtype, sep, scalar = value.partition(":")
    if sep and dtype in ("float32", "float16", "int64", "int32", "uint8", "bool"):
        dt = np.dtype(dtype)
        arr = np.full(shape, dt.type(float(scalar) if dt.kind == "f" else int(scalar)))
    else:
        arr = np.full(shape, float(value), dtype=np.float32)
    return [_made_on_host(ctx, arr)]


@register("Range", host=True)
def _range(ctx: Ctx, op, ins):
    start = ctx.static(ins, 0, "Range.start").reshape(-1)[0]
    limit = ctx.static(ins, 1, "Range.limit").reshape(-1)[0]
    delta = ctx.static(ins, 2, "Range.delta").reshape(-1)[0]
    return [_made_on_host(ctx, np.arange(start, limit, delta))]


# ONNX TensorProto.DataType ids
_CAST_TO = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 6: torch.int32, 7: torch.int64, 9: torch.bool,
            10: torch.float16, 11: torch.float64, 16: torch.bfloat16}


@register("Cast", host=True)
def _cast(ctx: Ctx, op, ins):
    to = op.attr_int("to")
    if to not in _CAST_TO:
        raise NotImplementedError(f"Cast to={to} not supported")
    dt = _CAST_TO[to]
    if ctx.mode == "device" and dt == torch.int64:
        dt = torch.int32  # device integers are 32-bit
    x = _tensor(ctx, ins[0])
    if x.dtype != torch.bool and dt == torch.bool:
        return [x != 0]
    return [x.to(dt)]


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


@register("ReduceSum", host=True)
def _reduce_sum(ctx: Ctx, op, ins):
    """An integer sum keeps its dtype, as jnp.sum (torch.sum widens to int64)."""
    x = _tensor(ctx, ins[0])
    axes = _axes_from(ctx, op, ins, 1)
    keepdims = bool(op.attr_int("keepdims", 1))
    ax = tuple(a % x.ndim for a in axes) if axes else tuple(range(x.ndim))
    out = _f32_island(x, lambda v: v.sum(dim=ax, keepdim=keepdims))
    return [out if x.is_floating_point() or x.dtype == torch.bool else out.to(x.dtype)]


@register("ReduceMax", host=True)
def _reduce_max(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    axes = _axes_from(ctx, op, ins, 1)
    keepdims = bool(op.attr_int("keepdims", 1))
    ax = tuple(a % x.ndim for a in axes) if axes else tuple(range(x.ndim))
    return [torch.amax(x, dim=ax, keepdim=keepdims)]


@register("Softmax")
def _softmax(ctx: Ctx, op, ins):
    axis = op.attr_int("axis", -1)
    return [_f32_island(_tensor(ctx, ins[0]), lambda v: torch.softmax(v, dim=axis))]


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


@register("ostpu.groupnorm")
def _ostpu_groupnorm(ctx: Ctx, op, ins):
    """Channel-last GroupNorm, the layout pass's form of the converter's
    Reshape(N,G,-1) > InstanceNormalization > Reshape chain: x (N, H, W, C),
    per-group scale and bias (G,) (the InstanceNormalization affine). The
    statistics are per-channel sums first, then the group fold on the small
    (N, G, C/G) sums, all in float32 (the JAX op's order)."""
    x, scale, bias = (_tensor(ctx, v) for v in ins[:3])
    g = op.attr_int("groups")
    eps = op.attr_float("epsilon", 1e-5)
    if x.ndim != 4 or g <= 0 or x.shape[3] % g:
        raise ValueError(f"ostpu.groupnorm takes (N, H, W, C) with C a multiple of groups={g}, "
                         f"got {tuple(x.shape)}")
    n, h, w, c = x.shape
    cg = c // g
    xf = x.float().reshape(n, h * w, c)
    s1 = xf.sum(dim=1)  # (n, c)
    s2 = (xf * xf).sum(dim=1)
    cnt = float(h * w * cg)
    mean = s1.reshape(n, g, cg).sum(dim=2) / cnt  # (n, g)
    mean2 = s2.reshape(n, g, cg).sum(dim=2) / cnt
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps) * scale.float()
    shift = bias.float() - mean * inv
    mul_c = inv.repeat_interleave(cg, dim=1)[:, None, :]  # (n, 1, c)
    add_c = shift.repeat_interleave(cg, dim=1)[:, None, :]
    return [(xf * mul_c + add_c).reshape(n, h, w, c).to(x.dtype)]


@register("ostpu.reshape", host=True)
def _ostpu_reshape(ctx: Ctx, op, ins):
    """Reshape to the ``shape`` attribute (no shape-constant input): what the
    layout pass emits where a Reshape's target changes. A view where the
    strides allow it."""
    shape = [int(v) for v in op.attr("shape").split(",")]
    return [torch.reshape(_tensor(ctx, ins[0]), shape)]


@register("LayerNormalization")
def _layer_norm(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    scale = _tensor(ctx, ins[1])
    bias = _tensor(ctx, ins[2]) if len(ins) > 2 and ins[2] is not None else None
    axis = op.attr_int("axis", -1)
    eps = op.attr_float("epsilon", 1e-5)
    xf = x.float()
    red = tuple(range(axis % x.ndim, x.ndim))
    # one-pass E[x] / E[x^2] statistics, as InstanceNormalization
    mean = xf.mean(dim=red, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=red, keepdim=True) - mean * mean, min=0.0)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
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


@register("ostpu.conv3x3_im2col")
def _conv3x3_im2col_op(ctx: Ctx, op, ins):
    """A small-spatial 3x3 Conv (s1 p1 g1) as im2col + the tiled matmul kernel
    (kernels/matmul.py), produced by runtime/fusion.rewrite_smallconv under
    use_pallas_smallconv; the weight arrives in the (9 C, O) upload transform
    and the optional 3rd input is the bias. The CUDA kernel on the card, its
    plain twin on the CPU; the planner's meta tensors get the output's shape."""
    x = _tensor(ctx, ins[0])
    b = ins[2] if len(ins) > 2 and ins[2] is not None else None
    x, w = _align_binary(ctx, x, ins[1])
    if x.device.type == "meta":
        return [x.new_empty((x.shape[0], w.shape[1], x.shape[2], x.shape[3]))]
    bb = None if b is None else _astype(ctx, b, x.dtype)
    y = conv3x3_im2col(x.permute(0, 2, 3, 1), w, bb)
    return [y.permute(0, 3, 1, 2)]


# ---------------------------------------------------------------------------
# matmul family & convolution
# ---------------------------------------------------------------------------


@register("MatMul")
def _matmul(ctx: Ctx, op, ins):
    # float32 accumulation for every float dtype: cuBLAS accumulates bf16/fp16
    # products in float32 once reduced-precision reductions are off, which
    # the executor pins for the run
    a, b = _align_binary(ctx, ins[0], ins[1])
    return [torch.matmul(a, b)]


@register("Gemm")
def _gemm(ctx: Ctx, op, ins):
    a, b = _tensor(ctx, ins[0]), _tensor(ctx, ins[1])
    c = ins[2] if len(ins) > 2 and ins[2] is not None else None
    alpha = op.attr_float("alpha", 1.0)
    beta = op.attr_float("beta", 1.0)
    if op.attr_int("transA", 0):
        a = a.T
    if op.attr_int("transB", 0):
        b = b.T
    a, b = _align_binary(ctx, a, b)
    y = torch.matmul(a, b)
    if alpha != 1.0:
        y = y * _scalar(y, alpha)
    if c is not None:
        cc, _ = _align_binary(ctx, c, y)
        if beta != 1.0:
            cc = cc * _scalar(cc, beta)
        y = y + cc
    return [y]


def _nhwc(op) -> bool:
    return op.attr("layout") == "NHWC"


@register("Conv")
def _conv(ctx: Ctx, op, ins):
    """NCHW Conv of rank 4, and of rank 3 (Conv1D) as the JAX op runs it: the
    input gains a trailing unit dim, a (O, I, k) weight becomes (O, I, k, 1)
    (the converter's own promotion), and strides, dilations and pads gain
    that dim's 1 / 1 / 0.

    ``layout:NHWC`` (the layout pass): x is (N, H, W, C) and is read as the
    ``torch.channels_last`` NCHW view ``x.permute(0, 3, 1, 2)``; the planner
    uploads the weight channels-last (``"ohwi"``), so cuDNN runs NHWC with no
    layout conversion and its channels-last output, permuted back, is a
    contiguous (N, H, W, O) tensor."""
    x, w = _tensor(ctx, ins[0]), ins[1]
    b = ins[2] if len(ins) > 2 and ins[2] is not None else None
    nhwc = _nhwc(op)
    if nhwc:
        if x.ndim != 4:
            raise ValueError(f"Conv with layout:NHWC takes a 4-D (N, H, W, C) input, got {tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2)
    if x.ndim not in (3, 4):
        raise NotImplementedError(f"Conv of rank {x.ndim} is not ported (NCHW Conv1D and Conv2D only)")
    conv1d = x.ndim == 3
    if conv1d:
        x = x[..., None]
        if w.ndim == 3:
            w = w[..., None]
    n_spatial = 1 if conv1d else 2
    group = op.attr_int("group", 1)
    strides = list(op.attr_ints("strides", [1] * n_spatial))
    dilations = list(op.attr_ints("dilations", [1] * n_spatial))
    pads = list(op.attr_ints("pads", [0] * (2 * n_spatial)))
    if conv1d:
        strides = strides + [1] if len(strides) < 2 else strides
        dilations = dilations + [1] if len(dilations) < 2 else dilations
        if len(pads) == 2:
            pads = [pads[0], 0, pads[1], 0]
    pt, pl, pb, pr = pads
    x, w = _align_binary(ctx, x, w)
    if (pt, pl) == (pb, pr):
        padding = (pt, pl)
    else:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = (0, 0)
    bb = None if b is None else _astype(ctx, b, x.dtype)
    out = F.conv2d(x, w, bb, stride=strides, padding=padding, dilation=dilations, groups=group)
    if nhwc:
        return [out.permute(0, 2, 3, 1)]
    return [out[..., 0] if conv1d else out]


# ---------------------------------------------------------------------------
# pooling: explicit pads (ceil_mode adds the JAX op's extra high pad), then
# every window of the padded tensor as a strided view, reduced. The spatial
# dims start at 2 (NCHW) or at 1 (layout:NHWC, channels last).
# ---------------------------------------------------------------------------


def _spatial0(op, x) -> int:
    """The first spatial dim of a pooling input: 1 under layout:NHWC, where
    the input must be 4-D (N, H, W, C), else 2."""
    if not _nhwc(op):
        return 2
    if x.ndim != 4:
        raise ValueError(f"{op.op_type} with layout:NHWC takes a 4-D (N, H, W, C) input, got {tuple(x.shape)}")
    return 1


def _pool_pads(op, x, kernel, strides, first: int = 2):
    """[(lo, hi)] per spatial dim: the pads attribute, and with ceil_mode the
    extra high pad that lets the last (partial) window fit, as the JAX op
    computes it."""
    n = len(kernel)
    pads = list(op.attr_ints("pads", [0] * (2 * n)))
    out = []
    for i in range(n):
        lo, hi = pads[i], pads[i + n]
        if op.attr_int("ceil_mode", 0):
            size = x.shape[first + i] + lo + hi
            out_dim = -(-(size - kernel[i]) // strides[i]) + 1
            hi += max(0, (out_dim - 1) * strides[i] + kernel[i] - size)
        out.append((lo, hi))
    return out


def _windows(x: torch.Tensor, kernel, strides, padding, value, first: int = 2) -> torch.Tensor:
    """x with its spatial dims from ``first`` on, padded with `value` -> the
    same with each spatial dim replaced by the output positions and the
    window dims appended: (N, C, *out, *kernel) for NCHW, (N, *out, C,
    *kernel) for NHWC, as a view of the padded tensor."""
    flat = [p for lo_hi in reversed(padding) for p in lo_hi]  # F.pad wants the last dim first
    if first == 1:
        flat = [0, 0] + flat  # the channel dim is last
    if any(flat):
        x = F.pad(x, flat, value=value)
    for i, (k, s) in enumerate(zip(kernel, strides)):
        x = x.unfold(first + i, k, s)
    return x


@register("MaxPool")
def _maxpool(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    first = _spatial0(op, x)
    kernel = list(op.attr_ints("kernel_shape"))
    n = len(kernel)
    strides = list(op.attr_ints("strides", [1] * n))
    if any(d != 1 for d in op.attr_ints("dilations", [1] * n)):
        raise NotImplementedError("MaxPool dilations != 1")
    low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    win = _windows(x, kernel, strides, _pool_pads(op, x, kernel, strides, first), low, first)
    return [torch.amax(win, dim=tuple(range(-n, 0)))]


@register("AveragePool")
def _avgpool(ctx: Ctx, op, ins):
    """Window sums in float32 over the count of elements inside the input
    (count_include_pad=0: pads and ceil_mode's extra pad excluded) or over
    the kernel size (count_include_pad=1)."""
    x = _tensor(ctx, ins[0])
    first = _spatial0(op, x)
    kernel = list(op.attr_ints("kernel_shape"))
    n = len(kernel)
    strides = list(op.attr_ints("strides", [1] * n))
    padding = _pool_pads(op, x, kernel, strides, first)
    red = tuple(range(-n, 0))
    s = _windows(x.float(), kernel, strides, padding, 0.0, first).sum(dim=red)
    if op.attr_int("count_include_pad", 0):
        out = s / float(np.prod(kernel))
    else:
        spatial = tuple(x.shape[first:first + n])
        ones = torch.ones((1, 1) + spatial if first == 2 else (1,) + spatial + (1,),
                          dtype=torch.float32, device=x.device)
        out = s / _windows(ones, kernel, strides, padding, 0.0, first).sum(dim=red)
    return [out.to(x.dtype)]


@register("GlobalAveragePool")
def _global_avgpool(ctx: Ctx, op, ins):
    x = _tensor(ctx, ins[0])
    red = (1, 2) if _spatial0(op, x) == 1 else tuple(range(2, x.ndim))
    return [_f32_island(x, lambda v: v.mean(dim=red, keepdim=True))]


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
    if _nhwc(op) and x.ndim == 4:
        # scales / sizes come in NCHW axis order (the model's constants);
        # the tensor is channel-last (runtime/layout.py)
        perm = (0, 2, 3, 1)
        if scales is not None:
            scales = [scales[p] for p in perm]
        if sizes is not None:
            sizes = [sizes[p] for p in perm]

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

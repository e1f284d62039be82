"""Plain float32 building blocks of the reference, and the precision that
they compute in.

Four hooks of ``Precision`` say where a program in a lower precision would
round: ``entry`` at each model's inputs (the UNet's sample, timestep,
context, pooled embeds and time ids, the decoder's latents), as a program
casts its inputs to its compute dtype; ``q`` on both operands of every
product (matrix products, convolutions, attention's two products); ``r`` on
every intermediate that a program holds in its compute dtype (the outputs of
products, norms and activations, the residual sums); ``sinusoid``, the
Fourier features of the timestep and of SDXL's time ids. ``FLOAT32`` rounds
nowhere: everything is float32.

The reference of a configuration (``for_config``) is float32 but in its
Fourier features, which it takes in the configuration's dtype, as the
configuration states its arithmetic (every graph input cast to the dtype at
entry, every op computed in it: OnnxStream's ``use_fp16_arithmetic``). There
alone a rounding is not a relative error but a phase: a timestep near 1000
times a frequency near 1 is an angle near 1000, which bfloat16 holds to
within 2 radians.

The control, ``float8``, stands one precision below the configuration's
bfloat16 and computes in float8: products and intermediates rounded to e4m3
after a per-tensor scale that maps their largest magnitude to 448, the inputs
cast to e5m2, the float8 format whose range holds a timestep of 999 and time
ids of 1024. The softmax, the classifier-free guidance and the sampler's
update stay float32, as in the program."""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Precision:
    """The reference's products in float32."""

    name = "float32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def sinusoid(self, t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        """(N,) times (k,) -> (N, 2k): [cos, sin] of the angles."""
        ang = t.float()[:, None] * freqs[None]
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)

    def entry(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Float8(Precision):
    name = "float8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    r = q

    def entry(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float8_e5m2).to(t.dtype)

    def sinusoid(self, t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        ang = self.q(t.float()[:, None] * freqs[None])
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class Phases(Precision):
    """Float32, the Fourier features in ``dtype``: the angle is the product
    of the timestep and the frequency, each held in ``dtype``, rounded to
    it, and its cosine and sine rounded to it."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.name = f"float32, phases in {dtype}"

    def sinusoid(self, t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        ang = t.to(self.dtype)[:, None] * freqs.to(self.dtype)[None]
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).float()


FLOAT32 = Precision()
PRECISIONS = {"float32": FLOAT32, "float8": Float8()}


def for_config(config: dict) -> Precision:
    """The reference of a configuration, by its ``dtype``."""
    dtype = getattr(torch, config["dtype"])
    return FLOAT32 if dtype == torch.float32 else Phases(dtype)


class Weights:
    """Named parameters as float32 on one device; records the names read, so
    that a dry run lists what the architecture takes."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], device=None):
        self.tensors, self.device = tensors, device
        self.read = set()

    def __call__(self, name: str) -> torch.Tensor:
        key = name + ".bin"
        self.read.add(key)
        t = self.tensors[key]
        if self.device is not None:
            t = t.to(self.device)
        return t.float()

    def has(self, name: str) -> bool:
        return name + ".bin" in self.tensors


def linear(x: torch.Tensor, W: Weights, name: str, P: Precision, bias: bool = True) -> torch.Tensor:
    """x (..., din) @ weight (din, dout) [+ bias]."""
    y = torch.matmul(P.q(x), P.q(W(name + ".weight")))
    return P.r(y + W(name + ".bias") if bias else y)


def conv(x: torch.Tensor, W: Weights, name: str, P: Precision, stride: int = 1, pad: Optional[int] = None
         ) -> torch.Tensor:
    w = W(name + ".weight_nchw")
    pad = w.shape[-1] // 2 if pad is None else pad
    return P.r(F.conv2d(P.q(x), P.q(w), W(name + ".bias"), stride=stride, padding=pad))


def group_norm(x: torch.Tensor, W: Weights, name: str, groups: int, eps: float, P: Precision) -> torch.Tensor:
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = (g - mean).pow(2).mean(-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return P.r(y * W(name + ".weight").reshape(shape) + W(name + ".bias").reshape(shape))


def layer_norm(x: torch.Tensor, W: Weights, name: str, eps: float, P: Precision) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    return P.r((x - mean) / torch.sqrt(var + eps) * W(name + ".weight") + W(name + ".bias"))


def silu(x: torch.Tensor, P: Precision) -> torch.Tensor:
    return P.r(x * torch.sigmoid(x))


def gelu(x: torch.Tensor, P: Precision) -> torch.Tensor:
    return P.r(0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))


def quick_gelu(x: torch.Tensor, P: Precision) -> torch.Tensor:
    return P.r(x * torch.sigmoid(1.702 * x))


def attention(x: torch.Tensor, ctx: torch.Tensor, W: Weights, name: str, heads: int, P: Precision,
              qkv_bias: bool = False, causal: bool = False) -> torch.Tensor:
    """Multi-head scaled dot-product attention with its four projections:
    x (B, M, d) attends over ctx (B, N, dc). Softmax in float32."""
    b, m, _ = x.shape
    n = ctx.shape[1]
    q = linear(x, W, name + "/to_q", P, bias=qkv_bias)
    k = linear(ctx, W, name + "/to_k", P, bias=qkv_bias)
    v = linear(ctx, W, name + "/to_v", P, bias=qkv_bias)
    dh = q.shape[-1] // heads
    q, k, v = (t.reshape(b, -1, heads, dh).transpose(1, 2) for t in (q, k, v))
    s = P.r(torch.matmul(P.q(q), P.q(k).transpose(-1, -2)) * (1.0 / math.sqrt(dh)))
    if causal:
        s = s.masked_fill(torch.ones(m, n, dtype=torch.bool, device=s.device).triu(1), float("-inf"))
    p = P.r(torch.softmax(s, dim=-1))
    o = P.r(torch.matmul(P.q(p), P.q(v))).transpose(1, 2).reshape(b, m, heads * dh)
    return linear(o, W, name + "/to_out", P)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

"""Fused scaled-dot-product attention op ``ostpu.sdpa``.

Counterpart of ``onnxstream_tpu/ops/attention.py``. The graph fusion pass
(``runtime/fusion.py``) rewrites the recognized attention patterns into
``ostpu.sdpa``; this impl runs both forms, packed heads (mask-free, the SD
UNet) and head-major with an additive mask (the llama graphs), through the
hand-written CUDA flash kernel (``kernels/flash_attention.py``) at the sites
the size predicates pick, and through the torch reference paths everywhere
else.

Canonical signature:
    inputs:  Q (..., H, M, D), K (..., Hkv, N, D), V (..., Hkv, N, Dv), mask?
             or, with attr ``heads``, packed Q (..., M, H*D), K/V (..., N, Hkv*D)
    attrs:   scale (float, default 1/sqrt(D)), k_transposed (K given as
             (..., Hkv, D, N)), causal (0/1), heads (packed form)
GQA: H may be a multiple of Hkv.
"""

from __future__ import annotations

import math

import torch

from onnxstream_tpu_torch.kernels.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention,
    flash_attention_packed,
    head_major_problem,
)
from onnxstream_tpu_torch.ops import Ctx, register


def _causal_keep(m: int, n: int, device) -> torch.Tensor:
    """(m, n) bool: key column visible from query row (offset n - m)."""
    row = torch.arange(m, device=device)[:, None]
    col = torch.arange(n, device=device)[None, :]
    return col <= row + (n - m)


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to q's dtype and folded into q BEFORE the product,
    # so raw fp16 dot products cannot overflow; it travels as a Python number,
    # since a scalar tensor made on the card is a host copy that waits
    return q * float(torch.tensor(scale, dtype=q.dtype))


def sdpa_reference(q, k, v, mask=None, scale=None, k_transposed=False, causal=False):
    """Reference SDPA with float32 softmax and GQA support: (..., H, M, D)."""
    if k_transposed:
        k = k.transpose(-1, -2)  # -> (..., N, D)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    h_q = q.shape[-3] if q.ndim >= 3 else 1
    h_kv = k.shape[-3] if k.ndim >= 3 else 1
    if q.ndim >= 3 and h_q != h_kv:
        if h_q % h_kv:
            raise ValueError(f"GQA requires q_heads % kv_heads == 0, got {h_q} vs {h_kv}")
        k = k.repeat_interleave(h_q // h_kv, dim=-3)
        v = v.repeat_interleave(h_q // h_kv, dim=-3)
    # scores stay in the compute dtype; the float32 work is the softmax island
    logits = torch.matmul(_scaled(q, scale), k.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    if causal:
        m, n = logits.shape[-2:]
        logits = logits.masked_fill(~_causal_keep(m, n, logits.device),
                                    torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def sdpa_reference_packed(q, k, v, heads, mask=None, scale=None, causal=False):
    """Packed-projection SDPA: q (..., M, H*D), k/v (..., N, Hkv*D) -> (..., M, H*Dv).

    Rows with no valid key (causal with M > N) take the ``finfo.min`` fill,
    as in the JAX package, and come out as the mean of V; the flash kernel
    and its twin write such rows as 0."""
    lead = q.shape[:-2]
    m, hd = q.shape[-2:]
    d = hd // heads
    n = k.shape[-2]
    hkv = k.shape[-1] // d
    dv = v.shape[-1] // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q4 = _scaled(q, scale).reshape(lead + (m, heads, d)).transpose(-2, -3)
    k4 = k.reshape(lead + (n, hkv, d)).transpose(-2, -3)
    v4 = v.reshape(lead + (n, hkv, dv)).transpose(-2, -3)
    if heads != hkv:
        if heads % hkv:
            raise ValueError(f"GQA requires q_heads % kv_heads == 0, got {heads} vs {hkv}")
        k4 = k4.repeat_interleave(heads // hkv, dim=-3)
        v4 = v4.repeat_interleave(heads // hkv, dim=-3)
    logits = torch.matmul(q4, k4.transpose(-1, -2))  # (..., H, M, N)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    if causal:
        logits = logits.masked_fill(~_causal_keep(m, n, logits.device),
                                    torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    out = torch.matmul(probs, v4)  # (..., H, M, Dv)
    return out.transpose(-2, -3).reshape(lead + (m, heads * dv)).to(q.dtype)


def _use_flash_packed(config, heads, q, k, v) -> bool:
    """The flash kernel runs where it pays off and where it can run: CUDA
    tensors whose head dims it takes, long KV and large score matrices (the
    JAX package's size predicate). Everything else, the meta tensors of the
    planner included, takes ``sdpa_reference_packed``."""
    if config is not None and not config.use_flash_attention:
        return False
    if not q.is_cuda:
        return False
    if q.ndim not in (2, 3) or q.shape[-2] < 8 or not (q.dtype == k.dtype == v.dtype):
        return False
    d = q.shape[-1] // heads
    hkv = k.shape[-1] // d if d else 0
    dv = v.shape[-1] // hkv if hkv else 0
    if not (d % 8 == 0 and 0 < d <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM and dv % 8 == 0):
        return False
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        return False
    batch = q.shape[0] if q.ndim == 3 else 1
    kv_len = k.shape[-2]
    score_bytes = 2 * batch * heads * q.shape[-2] * kv_len
    return kv_len >= 512 and score_bytes >= (8 << 20)


def _use_flash(config, q, k, v, mask=None, k_transposed=False) -> bool:
    """The head-major flash kernel runs on CUDA tensors that it can take
    (``head_major_problem``: ranks, dtypes, head dims, strides, a mask that
    broadcasts), with the JAX package's size gates: KV >= 512 and scores of
    at least 8 MB. Everything else, the planner's meta tensors included,
    takes ``sdpa_reference``."""
    if config is not None and not config.use_flash_attention:
        return False
    if not q.is_cuda or q.ndim not in (3, 4) or q.shape[-2] < 8 or not (q.ndim == k.ndim == v.ndim):
        return False
    if q.ndim == 3:  # lifted to batch 1, as flash_attention does
        q, k, v = q[None], k[None], v[None]
    if head_major_problem(q, k, v, mask, k_transposed) is not None:
        return False
    batch, heads, m, _ = q.shape
    kv_len = k.shape[-1] if k_transposed else k.shape[-2]
    return kv_len >= 512 and 2 * batch * heads * m * kv_len >= (8 << 20)


@register("ostpu.sdpa")
def _sdpa(ctx: Ctx, op, ins):
    q, k, v, mask = [None if x is None else ctx.tensor(x) for x in (list(ins) + [None])[:4]]
    scale = op.attr_float("scale", 0.0) or None
    k_transposed = bool(op.attr_int("k_transposed", 0))
    causal = bool(op.attr_int("causal", 0))
    heads = op.attr_int("heads", 0)

    if heads:
        # packed projections (fusion absorbed the head split/merge)
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1] // heads)
        if mask is None and _use_flash_packed(ctx.config, heads, q, k, v):
            return [flash_attention_packed(q, k, v, heads, scale=scale, causal=causal)]
        return [sdpa_reference_packed(q, k, v, heads, mask=mask, scale=scale, causal=causal)]
    if _use_flash(ctx.config, q, k, v, mask, k_transposed):
        return [flash_attention(q, k, v, mask=mask, scale=scale, k_transposed=k_transposed,
                                causal=causal)]
    return [sdpa_reference(q, k, v, mask=mask, scale=scale, k_transposed=k_transposed, causal=causal)]

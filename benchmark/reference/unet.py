"""The UNet of Stable Diffusion (diffusers ``UNet2DConditionModel``) as
published for SD1.5 and SDXL: sinusoidal timestep embedding (cos first) and
its two-layer MLP; SDXL's added conditioning (pooled text embeds and the
Fourier features of the six time ids, ``text_time``); ResNet blocks with the
time embedding added after the first convolution; Transformer2D blocks
(GroupNorm eps 1e-6, a 1x1 input projection, BasicTransformerBlocks of
self-attention, cross-attention and a GEGLU feed-forward, the output
projection and the residual); strided-convolution downsamplers and
nearest-neighbour upsamplers; the skip connections of the up path.

Configuration keys are those of the published ``unet/config.json``. The
weights are named as the benchmark's weight file names them. Its GEGLU
projection holds the gate first and the value second.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from benchmark.reference.ops import (FLOAT32, Precision, Weights, attention, conv, gelu, group_norm, layer_norm,
                                     linear, silu, upsample_nearest2x)

RESNET_EPS = 1e-5
TRANSFORMER_GN_EPS = 1e-6
LN_EPS = 1e-5


def heads(cfg: dict) -> List[int]:
    h = cfg["attention_head_dim"]
    return [int(h)] * len(cfg["block_out_channels"]) if isinstance(h, int) else [int(v) for v in h]


def depths(cfg: dict) -> List[int]:
    """Transformer layers per block at each level, as the config gives them."""
    t = cfg.get("transformer_layers_per_block", 1)
    return [int(t)] * len(cfg["block_out_channels"]) if isinstance(t, int) else [int(v) for v in t]


def layers(cfg: dict) -> List[int]:
    """Transformer layers per block at each level: 0 where the level's down
    block has no cross-attention."""
    return [d if "CrossAttn" in kind else 0 for d, kind in zip(depths(cfg), cfg["down_block_types"])]


def _sinusoid(t: torch.Tensor, dim: int, P: Precision) -> torch.Tensor:
    """(N,) -> (N, dim): [cos, sin] of t times 10000^(-k/half), as P takes
    them."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    return P.sinusoid(t, freqs)


def eps(W: Weights, cfg: dict, sample: torch.Tensor, t: float, context: torch.Tensor,
        pooled: Optional[torch.Tensor] = None, time_ids: Optional[torch.Tensor] = None,
        P: Precision = FLOAT32) -> torch.Tensor:
    """The predicted noise for sample (B, 4, h, w) at timestep t under
    context (B, 77, cross_attention_dim); SDXL also takes pooled (B, p) and
    time_ids (B, 6)."""
    groups = int(cfg["norm_num_groups"])
    chans = [int(c) for c in cfg["block_out_channels"]]
    n_heads, n_layers = heads(cfg), layers(cfg)
    b = sample.shape[0]
    sample, context = P.entry(sample), P.entry(context)
    tt = P.entry(torch.full((1,), float(t), dtype=torch.float32, device=sample.device))
    temb = linear(silu(linear(P.r(_sinusoid(tt, chans[0], P)), W, "temb/lin1", P), P), W, "temb/lin2", P)
    if cfg.get("addition_embed_type") == "text_time":
        tid = P.r(_sinusoid(P.entry(time_ids).reshape(-1), int(cfg["addition_time_embed_dim"]), P).reshape(b, -1))
        add = torch.cat([P.entry(pooled), tid], dim=-1)
        temb = P.r(temb + linear(silu(linear(add, W, "add_emb/lin1", P), P), W, "add_emb/lin2", P))

    def resnet(x: torch.Tensor, cout: int, nm: str) -> torch.Tensor:
        h = conv(silu(group_norm(x, W, nm + "/norm1", groups, RESNET_EPS, P), P), W, nm + "/conv1", P)
        h = P.r(h + linear(silu(temb, P), W, nm + "/time_emb", P)[:, :, None, None])
        h = conv(silu(group_norm(h, W, nm + "/norm2", groups, RESNET_EPS, P), P), W, nm + "/conv2", P)
        if x.shape[1] != cout:
            x = conv(x, W, nm + "/shortcut", P, pad=0)
        return P.r(x + h)

    def transformer(x: torch.Tensor, h: int, depth: int, nm: str) -> torch.Tensor:
        bb, c, hh, ww = x.shape
        y = conv(group_norm(x, W, nm + "/norm", groups, TRANSFORMER_GN_EPS, P), W, nm + "/proj_in", P, pad=0)
        y = y.reshape(bb, c, hh * ww).transpose(1, 2)
        for d in range(depth):
            bn = f"{nm}/blk{d}"
            a = layer_norm(y, W, bn + "/ln1", LN_EPS, P)
            y = P.r(y + attention(a, a, W, bn + "/attn1", h, P))
            a = layer_norm(y, W, bn + "/ln2", LN_EPS, P)
            y = P.r(y + attention(a, context, W, bn + "/attn2", h, P))
            a = layer_norm(y, W, bn + "/ln3", LN_EPS, P)
            gate, value = linear(a, W, bn + "/ff_in", P).chunk(2, dim=-1)
            y = P.r(y + linear(P.r(gelu(gate, P) * value), W, bn + "/ff_out", P))
        y = y.transpose(1, 2).reshape(bb, c, hh, ww)
        return P.r(conv(y, W, nm + "/proj_out", P, pad=0) + x)

    x = conv(sample, W, "conv_in", P)
    skips = [x]
    n = len(chans)
    for lvl, cout in enumerate(chans):
        for blk in range(int(cfg["layers_per_block"])):
            x = resnet(x, cout, f"down{lvl}/res{blk}")
            if n_layers[lvl]:
                x = transformer(x, n_heads[lvl], n_layers[lvl], f"down{lvl}/attn{blk}")
            skips.append(x)
        if lvl != n - 1:
            x = conv(x, W, f"down{lvl}/downsample", P, stride=2, pad=1)
            skips.append(x)

    x = resnet(x, chans[-1], "mid/res0")
    x = transformer(x, n_heads[-1], depths(cfg)[-1], "mid/attn")
    x = resnet(x, chans[-1], "mid/res1")

    for lvl in reversed(range(n)):
        for blk in range(int(cfg["layers_per_block"]) + 1):
            x = resnet(torch.cat([x, skips.pop()], dim=1), chans[lvl], f"up{lvl}/res{blk}")
            if n_layers[lvl]:
                x = transformer(x, n_heads[lvl], n_layers[lvl], f"up{lvl}/attn{blk}")
        if lvl != 0:
            x = conv(upsample_nearest2x(x), W, f"up{lvl}/upconv", P)

    x = silu(group_norm(x, W, "norm_out", groups, RESNET_EPS, P), P)
    return conv(x, W, "conv_out", P)

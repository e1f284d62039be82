"""SD UNet architecture graphs (UNet2DConditionModel).

Reconstructs the diffusers UNet the reference runs from converted ONNX
(reference src/sd.cpp diffusion loop, README.md:128: SD1.5 UNet = 2050 ops /
854M params), in the same decomposed text IR the converter produces. Configs:
SD15 (the headline model), SDXL-base shapes, and a tiny config for tests.

Counterpart of ``onnxstream_tpu/models/sd/unet.py`` (same graphs and weights).

Graph inputs (SD1.5): sample (1,4,H/8,W/8), timestep (1,), encoder_hidden_states
(1,77,768). SDXL adds text_embeds (1,1280) and time_ids (1,6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from onnxstream_tpu_torch.convert.builder import GraphBuilder, T


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64  # latent H=W
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)  # SD1.5: heads per level
    # which levels get transformer blocks (SD1.5: all but the last down level)
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 0)
    norm_groups: int = 32
    context_len: int = 77
    # SDXL additional conditioning: pooled text embeds (text_5F_embeds input,
    # width pooled_dim) + in-graph fourier embedding of the 6 time_ids at
    # time_fourier_dim each (diffusers add_time_proj; 1280 + 6*256 = 2816)
    pooled_dim: int = 0
    time_fourier_dim: int = 256
    head_dim_is_count: bool = True  # attention_head_dim holds the head COUNT (SD1.5)

    @property
    def addition_embed_dim(self) -> int:
        return self.pooled_dim + 6 * self.time_fourier_dim if self.pooled_dim else 0


SD15 = UNetConfig()

SDXL = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    layers_per_block=2,
    cross_attention_dim=2048,
    attention_head_dim=(5, 10, 20),
    attn_levels=(False, True, True),
    transformer_layers=(0, 2, 10),
    context_len=77,
    pooled_dim=1280,
)

TINY = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=32,
    attention_head_dim=(2, 2),
    attn_levels=(True, True),
    transformer_layers=(1, 1),
    norm_groups=8,
    context_len=7,
)

TINY_XL = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    layers_per_block=1,
    cross_attention_dim=80,  # tiny te1 (32) + tiny te2 (48) concat
    attention_head_dim=(2, 2),
    attn_levels=(True, True),
    transformer_layers=(1, 1),
    norm_groups=8,
    context_len=7,
    pooled_dim=48,
    time_fourier_dim=8,
)


def build_unet(cfg: UNetConfig = SD15, batch: int = 1, seed: int = 0,
               lazy_weights: bool = False) -> GraphBuilder:
    # lazy_weights: big weights become LazyArray placeholders so perf
    # harnesses with device-synthesized weights skip the ~160 s host
    # randn generation of the 3.4 GB synthetic checkpoint entirely
    g = GraphBuilder(seed=seed, lazy_weights=lazy_weights)
    ch0 = cfg.block_out_channels[0]
    temb_dim = ch0 * 4
    s = cfg.sample_size

    sample = g.input("sample", (batch, cfg.in_channels, s, s))
    timestep = g.input("timestep", (1,))
    context = g.input("encoder_hidden_states", (batch, cfg.context_len, cfg.cross_attention_dim))

    # --- timestep embedding: sin/cos projection computed in-graph -----------
    half = ch0 // 2
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    t = g.emit("Unsqueeze", [timestep, g.weight("temb.unsq_axes", np.array([1], np.int64))], [(1, 1)], name="temb/unsq")
    ang = g.mul(t, g.weight("temb.freqs", freqs.reshape(1, half)), name="temb/ang")
    emb = g.concat([g.emit("Cos", [ang], [ang.shape]), g.emit("Sin", [ang], [ang.shape])], axis=-1, name="temb/cat")
    temb = g.matmul_w(emb, temb_dim, name="temb/lin1")
    temb = g.silu(temb)
    temb = g.matmul_w(temb, temb_dim, name="temb/lin2")  # (1, temb_dim)

    if cfg.addition_embed_dim:
        # SDXL conditioning (inputs named as the converted graph pushes them,
        # reference src/sd.cpp:1488-1516): pooled text embeds (1, pooled_dim)
        # and time_ids (1, 6); the fourier projection of each time_id
        # (diffusers add_time_proj, flip_sin_to_cos) runs in-graph, then
        # concat(text_embeds, time_embeds) -> 2-layer MLP -> add to temb.
        pooled = g.input("text_5F_embeds", (batch, cfg.pooled_dim))
        time_ids = g.input("time_5F_ids", (batch, 6))
        td = cfg.time_fourier_dim
        tfreqs = np.exp(-math.log(10000.0) * np.arange(td // 2, dtype=np.float32) / (td // 2))
        tid_col = g.reshape(time_ids, (batch * 6, 1), name="add_emb/tid_col")
        tang = g.mul(tid_col, g.weight("add_emb.freqs", tfreqs.reshape(1, td // 2)), name="add_emb/ang")
        tsin = g.emit("Sin", [tang], [tang.shape])
        tcos = g.emit("Cos", [tang], [tang.shape])
        time_emb = g.concat([tcos, tsin], axis=-1, name="add_emb/fourier")  # (b*6, td)
        time_emb = g.reshape(time_emb, (batch, 6 * td), name="add_emb/time_flat")
        add_cond = g.concat([pooled, time_emb], axis=-1, name="add_emb/cat")
        a = g.matmul_w(add_cond, temb_dim, name="add_emb/lin1")
        a = g.silu(a)
        a = g.matmul_w(a, temb_dim, name="add_emb/lin2")
        temb = g.add(temb, a, name="add_emb/add")

    def resblock(x: T, cout: int, name: str) -> T:
        cin = x.shape[1]
        h = g.group_norm(x, cfg.norm_groups, name=f"{name}/norm1")
        h = g.silu(h)
        h = g.conv(h, cout, 3, name=f"{name}/conv1")
        e = g.silu(temb)
        e = g.matmul_w(e, cout, name=f"{name}/time_emb")
        # temb is (1, temb_dim) for SD1.5 but (batch, temb_dim) when the SDXL
        # add-embeds branch broadcast it; follow its leading dim
        e = g.reshape(e, (e.shape[0], cout, 1, 1), name=f"{name}/time_r")
        h = g.add(h, e, out_shape=h.shape, name=f"{name}/time_add")
        h = g.group_norm(h, cfg.norm_groups, name=f"{name}/norm2")
        h = g.silu(h)
        h = g.conv(h, cout, 3, name=f"{name}/conv2")
        if cin != cout:
            x = g.conv(x, cout, 1, pad=0, name=f"{name}/shortcut")
        return g.add(x, h, name=f"{name}/add")

    def transformer(x: T, level: int, name: str) -> T:
        b, c, h, w = x.shape
        if cfg.head_dim_is_count:
            heads = cfg.attention_head_dim[level]
            dim_head = c // heads
        else:
            dim_head = cfg.attention_head_dim[level]
            heads = c // dim_head
        res = x
        y = g.group_norm(x, cfg.norm_groups, name=f"{name}/norm")
        y = g.conv(y, c, 1, pad=0, name=f"{name}/proj_in")
        y = g.reshape(y, (b, c, h * w), name=f"{name}/flat")
        y = g.transpose(y, (0, 2, 1), name=f"{name}/to_seq")
        for d in range(cfg.transformer_layers[level]):
            bn = f"{name}/blk{d}"
            a = g.layer_norm(y, name=f"{bn}/ln1")
            y = g.add(y, g.attention(a, heads=heads, dim_head=dim_head, name=f"{bn}/attn1"), name=f"{bn}/res1")
            a = g.layer_norm(y, name=f"{bn}/ln2")
            y = g.add(
                y, g.attention(a, context=context, heads=heads, dim_head=dim_head, name=f"{bn}/attn2"), name=f"{bn}/res2"
            )
            a = g.layer_norm(y, name=f"{bn}/ln3")
            ff = g.matmul_w(a, c * 8, name=f"{bn}/ff_in")  # GEGLU: 2 * 4c
            gate, val = g.split(ff, [c * 4, c * 4], axis=-1)
            ff = g.mul(g.gelu(gate), val, name=f"{bn}/geglu")
            ff = g.matmul_w(ff, c, name=f"{bn}/ff_out")
            y = g.add(y, ff, name=f"{bn}/res3")
        y = g.transpose(y, (0, 2, 1), name=f"{name}/to_sp")
        y = g.reshape(y, (b, c, h, w), name=f"{name}/unflat")
        y = g.conv(y, c, 1, pad=0, name=f"{name}/proj_out")
        return g.add(y, res, name=f"{name}/res")

    # --- down path ------------------------------------------------------------
    x = g.conv(sample, ch0, 3, name="conv_in")
    skips: List[T] = [x]
    n_levels = len(cfg.block_out_channels)
    for lvl, cout in enumerate(cfg.block_out_channels):
        for blk in range(cfg.layers_per_block):
            x = resblock(x, cout, f"down{lvl}/res{blk}")
            if cfg.attn_levels[lvl]:
                x = transformer(x, lvl, f"down{lvl}/attn{blk}")
            skips.append(x)
        if lvl != n_levels - 1:
            x = g.conv(x, cout, 3, stride=2, pad=1, name=f"down{lvl}/downsample")
            skips.append(x)

    # --- mid -------------------------------------------------------------------
    mid_c = cfg.block_out_channels[-1]
    mid_attn_level = n_levels - 1 if cfg.attn_levels[-1] else n_levels - 2
    x = resblock(x, mid_c, "mid/res0")
    x = transformer(x, mid_attn_level, "mid/attn")
    x = resblock(x, mid_c, "mid/res1")

    # --- up path -----------------------------------------------------------------
    for lvl in reversed(range(n_levels)):
        cout = cfg.block_out_channels[lvl]
        for blk in range(cfg.layers_per_block + 1):
            skip = skips.pop()
            x = g.concat([x, skip], axis=1, name=f"up{lvl}/cat{blk}")
            x = resblock(x, cout, f"up{lvl}/res{blk}")
            if cfg.attn_levels[lvl]:
                x = transformer(x, lvl, f"up{lvl}/attn{blk}")
        if lvl != 0:
            b, c, h, w = x.shape
            x = g.emit(
                "Resize",
                [x, None, g.weight(f"up{lvl}.scales", np.array([1, 1, 2, 2], np.float32))],
                [(b, c, h * 2, w * 2)],
                {"coordinate_transformation_mode": "asymmetric", "mode": "nearest", "nearest_mode": "floor"},
                name=f"up{lvl}/upsample",
            )
            x = g.conv(x, c, 3, name=f"up{lvl}/upconv")

    x = g.group_norm(x, cfg.norm_groups, name="norm_out")
    x = g.silu(x)
    g.emit("Conv", [x, g.gen_weight("conv_out.weight_nchw",
                                    lambda co=cfg.out_channels, ci=x.shape[1]: g.randn(co, ci, 3, 3),
                                    shape=(cfg.out_channels, x.shape[1], 3, 3)),
                    g.gen_weight("conv_out.bias",
                                 lambda co=cfg.out_channels: g.randn(co, scale=0.01),
                                 shape=(cfg.out_channels,))],
           [(batch, cfg.out_channels, s, s)],
           {"dilations": "1,1", "group": 1, "kernel_shape": "3,3", "pads": "1,1,1,1", "strides": "1,1"},
           name="conv_out", out_names=["out_sample"])
    return g


def param_count(g: GraphBuilder) -> int:
    return sum(int(np.prod(a.shape)) for a in g.weights.values())

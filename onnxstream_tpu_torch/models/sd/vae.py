"""VAE decoder (and encoder) graphs for SD.

The reference runs the converted decoder ONNX (vae_decoder_fp16|qu8/model.txt)
plain, calibrated-quantized, or tiled (src/sd.cpp:1174-1364, 2357-2517;
README.md:68-88 documents the 4.4 GB -> 298 MB tiled effect). Decoder input:
latent (1, 4, h, w) already divided by 0.18215 by the pipeline; output
(1, 3, 8h, 8w) in [-1, 1].

Counterpart of ``onnxstream_tpu/models/sd/vae.py``: the same code, carried
here so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from onnxstream_tpu_torch.convert.builder import GraphBuilder, T


@dataclasses.dataclass
class VaeConfig:
    latent_channels: int = 4
    base: int = 128
    mult: Tuple[int, ...] = (1, 2, 4, 4)  # encoder order; decoder reverses
    blocks: int = 3  # res blocks per decoder level
    norm_groups: int = 32
    sample: int = 64  # latent h=w of the build (tiled decode uses 32)


VAE_SD = VaeConfig()
VAE_TINY = VaeConfig(base=16, mult=(1, 2), blocks=1, norm_groups=4, sample=8)


def _resblock(g: GraphBuilder, x: T, cout: int, groups: int, name: str) -> T:
    cin = x.shape[1]
    h = g.group_norm(x, groups, name=f"{name}/norm1")
    h = g.silu(h)
    h = g.conv(h, cout, 3, name=f"{name}/conv1")
    h = g.group_norm(h, groups, name=f"{name}/norm2")
    h = g.silu(h)
    h = g.conv(h, cout, 3, name=f"{name}/conv2")
    if cin != cout:
        x = g.conv(x, cout, 1, pad=0, name=f"{name}/shortcut")
    return g.add(x, h, name=f"{name}/add")


def _attn(g: GraphBuilder, x: T, groups: int, name: str) -> T:
    b, c, h, w = x.shape
    y = g.group_norm(x, groups, name=f"{name}/norm")
    y = g.reshape(y, (b, c, h * w), name=f"{name}/flat")
    y = g.transpose(y, (0, 2, 1), name=f"{name}/seq")
    y = g.attention(y, heads=1, name=f"{name}/attn")
    y = g.transpose(y, (0, 2, 1), name=f"{name}/sp")
    y = g.reshape(y, (b, c, h, w), name=f"{name}/unflat")
    return g.add(x, y, name=f"{name}/res")


def build_vae_decoder(cfg: VaeConfig = VAE_SD, latent_hw: Tuple[int, int] = None,
                      seed: int = 0, lazy_weights: bool = False) -> GraphBuilder:
    # lazy_weights: conv weights (via g.conv -> gen_weight) stay LazyArray
    # placeholders for device-synthesized perf runs; the few explicit
    # weights below are tiny and stay eager
    g = GraphBuilder(seed=seed, lazy_weights=lazy_weights)
    lh, lw = latent_hw or (cfg.sample, cfg.sample)
    top = cfg.base * cfg.mult[-1]
    z = g.input("latent", (1, cfg.latent_channels, lh, lw))

    x = g.conv(z, cfg.latent_channels, 1, pad=0, name="post_quant_conv")
    x = g.conv(x, top, 3, name="conv_in")
    x = _resblock(g, x, top, cfg.norm_groups, "mid/res0")
    x = _attn(g, x, cfg.norm_groups, "mid/attn")
    x = _resblock(g, x, top, cfg.norm_groups, "mid/res1")

    for lvl, m in enumerate(reversed(cfg.mult)):
        cout = cfg.base * m
        for b in range(cfg.blocks):
            x = _resblock(g, x, cout, cfg.norm_groups, f"up{lvl}/res{b}")
        if lvl != len(cfg.mult) - 1:
            bsz, c, hh, ww = x.shape
            x = g.emit(
                "Resize",
                [x, None, g.weight(f"up{lvl}.scales", np.array([1, 1, 2, 2], np.float32))],
                [(bsz, c, hh * 2, ww * 2)],
                {"coordinate_transformation_mode": "asymmetric", "mode": "nearest", "nearest_mode": "floor"},
                name=f"up{lvl}/upsample",
            )
            x = g.conv(x, c, 3, name=f"up{lvl}/upconv")

    x = g.group_norm(x, cfg.norm_groups, name="norm_out")
    x = g.silu(x)
    g.emit(
        "Conv",
        [x, g.weight("conv_out.weight_nchw", g.randn(3, x.shape[1], 3, 3)),
         g.weight("conv_out.bias", g.randn(3, scale=0.01))],
        [(1, 3, x.shape[2], x.shape[3])],
        {"dilations": "1,1", "group": 1, "kernel_shape": "3,3", "pads": "1,1,1,1", "strides": "1,1"},
        name="conv_out",
        out_names=["image"],
    )
    return g


def build_vae_encoder(cfg: VaeConfig = VAE_SD, image_hw: Tuple[int, int] = None, seed: int = 0) -> GraphBuilder:
    """Encoder (for img2img-style flows; the reference ships decoder-only
    pipelines but the family is part of the VAE)."""
    g = GraphBuilder(seed=seed)
    ih, iw = image_hw or (cfg.sample * 8, cfg.sample * 8)
    img = g.input("image", (1, 3, ih, iw))
    x = g.conv(img, cfg.base, 3, name="conv_in")
    for lvl, m in enumerate(cfg.mult):
        cout = cfg.base * m
        for b in range(cfg.blocks - 1):
            x = _resblock(g, x, cout, cfg.norm_groups, f"down{lvl}/res{b}")
        if lvl != len(cfg.mult) - 1:
            x = g.conv(x, cout, 3, stride=2, pad=1, name=f"down{lvl}/down")
    top = cfg.base * cfg.mult[-1]
    x = _resblock(g, x, top, cfg.norm_groups, "mid/res0")
    x = _attn(g, x, cfg.norm_groups, "mid/attn")
    x = _resblock(g, x, top, cfg.norm_groups, "mid/res1")
    x = g.group_norm(x, cfg.norm_groups, name="norm_out")
    x = g.silu(x)
    x = g.conv(x, 2 * cfg.latent_channels, 3, name="conv_out")
    g.emit("Conv", [x, g.weight("quant_conv.weight_nchw", g.randn(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, 1)),
                    g.weight("quant_conv.bias", g.randn(2 * cfg.latent_channels, scale=0.01))],
           [(1, 2 * cfg.latent_channels, x.shape[2], x.shape[3])],
           {"dilations": "1,1", "group": 1, "kernel_shape": "1,1", "pads": "0,0,0,0", "strides": "1,1"},
           name="quant_conv", out_names=["latent_dist"])
    return g

"""The decoder of Stable Diffusion's AutoencoderKL (diffusers ``Decoder``
behind ``post_quant_conv``): a 1x1 post-quantization convolution, the input
convolution, a mid block of ResNet, single-head spatial self-attention and
ResNet, ``layers_per_block + 1`` ResNet blocks at each level from the widest
down, nearest-neighbour upsampling with a convolution between levels, and
GroupNorm, SiLU and the output convolution. Every GroupNorm has eps 1e-6.

Configuration keys are those of the published ``vae/config.json``. The
weights are named as the benchmark's weight file names them; where the file
holds no bias of the attention's q, k and v projections, they have none.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops import (FLOAT32, Precision, Weights, attention, conv, group_norm, silu,
                                     upsample_nearest2x)

GN_EPS = 1e-6


def decode(W: Weights, cfg: dict, z: torch.Tensor, P: Precision = FLOAT32) -> torch.Tensor:
    """z (1, 4, h, w), the latents already divided by the scaling factor ->
    the image (1, 3, 8h, 8w), about [-1, 1]."""
    groups = int(cfg["norm_num_groups"])
    chans = [int(c) for c in cfg["block_out_channels"]]

    def resnet(x: torch.Tensor, cout: int, nm: str) -> torch.Tensor:
        h = conv(silu(group_norm(x, W, nm + "/norm1", groups, GN_EPS, P), P), W, nm + "/conv1", P)
        h = conv(silu(group_norm(h, W, nm + "/norm2", groups, GN_EPS, P), P), W, nm + "/conv2", P)
        if x.shape[1] != cout:
            x = conv(x, W, nm + "/shortcut", P, pad=0)
        return P.r(x + h)

    x = conv(P.entry(z), W, "post_quant_conv", P, pad=0)
    x = conv(x, W, "conv_in", P)
    x = resnet(x, chans[-1], "mid/res0")
    b, c, h, w = x.shape
    y = group_norm(x, W, "mid/attn/norm", groups, GN_EPS, P).reshape(b, c, h * w).transpose(1, 2)
    y = attention(y, y, W, "mid/attn/attn", 1, P, qkv_bias=W.has("mid/attn/attn/to_q.bias"))
    x = P.r(x + y.transpose(1, 2).reshape(b, c, h, w))
    x = resnet(x, chans[-1], "mid/res1")
    for lvl, cout in enumerate(reversed(chans)):
        for blk in range(int(cfg["layers_per_block"]) + 1):
            x = resnet(x, cout, f"up{lvl}/res{blk}")
        if lvl != len(chans) - 1:
            x = conv(upsample_nearest2x(x), W, f"up{lvl}/upconv", P)
    x = silu(group_norm(x, W, "norm_out", groups, GN_EPS, P), P)
    return conv(x, W, "conv_out", P)

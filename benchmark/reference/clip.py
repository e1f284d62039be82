"""CLIP's text transformer (transformers ``CLIPTextModel`` /
``CLIPTextModelWithProjection``): token and position embeddings, pre-norm
layers of causal self-attention (q, k, v and out projections with biases)
and an MLP (quick GELU for ViT-L/14, GELU for OpenCLIP bigG/14), the final
LayerNorm, and the pooled state projected by ``text_projection``.

Configuration keys are those of the published ``text_encoder/config.json``:
``hidden_size``, ``num_attention_heads``, ``num_hidden_layers``,
``hidden_act``, ``layer_norm_eps``. The weights are named as the benchmark's
weight file names them (``encoder.layers.<i>/attn/to_q.weight`` ...)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.ops import FLOAT32, Precision, Weights, attention, gelu, layer_norm, linear, quick_gelu


def encode(W: Weights, cfg: dict, tokens: torch.Tensor, P: Precision = FLOAT32,
           pool_at: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """tokens (1, L) int64 -> ``last`` (1, L, d), the final LayerNorm's
    output; ``penultimate`` (1, L, d), the output of the second-to-last
    layer; and with ``pool_at``, ``pooled`` (1, p): the final state at that
    position times the text projection."""
    eps = float(cfg["layer_norm_eps"])
    act = quick_gelu if cfg["hidden_act"] == "quick_gelu" else gelu
    heads = int(cfg["num_attention_heads"])
    x = P.r(W("embeddings.token_embedding.weight")[tokens] + W("embeddings.position_embedding.weight"))
    states = []
    for i in range(int(cfg["num_hidden_layers"])):
        nm = f"encoder.layers.{i}"
        a = layer_norm(x, W, nm + "/ln1", eps, P)
        x = P.r(x + attention(a, a, W, nm + "/attn", heads, P, qkv_bias=True, causal=True))
        a = layer_norm(x, W, nm + "/ln2", eps, P)
        x = P.r(x + linear(act(linear(a, W, nm + "/fc1", P), P), W, nm + "/fc2", P))
        states.append(x)
    last = layer_norm(x, W, "final_layer_norm", eps, P)
    out = {"last": last, "penultimate": states[-2]}
    if pool_at is not None:
        out["pooled"] = P.r(torch.matmul(P.q(last[:, pool_at]), P.q(W("text_projection.weight"))))
    return out

"""CLIP text-encoder graphs (SD1.5: ViT-L/14; SDXL adds OpenCLIP ViT-bigG).

The reference runs these as converted ONNX (text_encoder_fp32/model.txt, one
run per 77-token chunk, src/sd.cpp:2163-2230; SDXL dual encoders with
penultimate hidden states + pooled output via m_extra_outputs,
src/sd.cpp:2580-2663). Graph input: tokens (1, 77) int64.

Counterpart of ``onnxstream_tpu/models/sd/clip.py``: the same code, carried
here so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from onnxstream_tpu_torch.convert.builder import GraphBuilder


@dataclasses.dataclass
class ClipConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    seq: int = 77
    activation: str = "quick_gelu"  # ViT-L; OpenCLIP bigG uses "gelu"
    pooled: bool = False  # emit pooled/text-projection output (SDXL encoder 2)
    proj_dim: int = 0  # text projection output dim; 0 -> width


CLIP_L = ClipConfig()
CLIP_BIGG = ClipConfig(width=1280, layers=32, heads=20, activation="gelu", pooled=True)
CLIP_TINY = ClipConfig(vocab_size=1000, width=32, layers=2, heads=2, seq=7)
CLIP_TINY_G = ClipConfig(
    vocab_size=1000, width=48, layers=2, heads=2, seq=7, activation="gelu", pooled=True
)


def build_text_encoder(cfg: ClipConfig = CLIP_L, seed: int = 0,
                       lazy_weights: bool = False) -> GraphBuilder:
    # lazy_weights: big weights stay LazyArray placeholders so perf harnesses
    # (SessionConfig.synthetic_device_weights) never host-materialize them —
    # the token embedding alone is vocab x width (253 MB f32 for CLIP-bigG)
    g = GraphBuilder(seed=seed, lazy_weights=lazy_weights)
    d, L = cfg.width, cfg.seq
    tokens = g.input("tokens", (1, L))

    tok_emb = g.gen_weight("embeddings.token_embedding.weight",
                           lambda: g.randn(cfg.vocab_size, d, scale=0.02),
                           shape=(cfg.vocab_size, d))
    x = g.emit("Gather", [tok_emb, tokens], [(1, L, d)], {"axis": 0}, name="embeddings/gather")
    pos = g.weight("embeddings.position_embedding.weight", g.randn(L, d, scale=0.02))
    x = g.add(x, pos, out_shape=(1, L, d), name="embeddings/add_pos")

    # causal mask as a (L, L) additive weight, like the converted graph carries
    mask_arr = np.triu(np.full((L, L), -3.4028235e38, np.float32), 1)
    mask = g.weight("causal_mask", mask_arr.reshape(1, 1, L, L))

    hidden_states = []
    for layer in range(cfg.layers):
        nm = f"encoder.layers.{layer}"
        a = g.layer_norm(x, name=f"{nm}/ln1")
        # CLIP projections carry biases (transformers CLIPTextModel q/k/v/out)
        attn = g.attention(a, heads=cfg.heads, name=f"{nm}/attn", causal_mask=mask, qkv_bias=True)
        x = g.add(x, attn, name=f"{nm}/res1")
        a = g.layer_norm(x, name=f"{nm}/ln2")
        h = g.matmul_w(a, d * 4, name=f"{nm}/fc1")
        h = g.quick_gelu(h) if cfg.activation == "quick_gelu" else g.gelu(h)
        h = g.matmul_w(h, d, name=f"{nm}/fc2")
        x = g.add(x, h, name=f"{nm}/res2")
        hidden_states.append(x)

    final = g.layer_norm(x, name="final_layer_norm")
    # name the outputs so pipelines can request penultimate states via
    # extra_outputs (the reference pulls out_5F_13 / out_5F_33, sd.cpp:2601)
    g.emit("Identity", [final], [(1, L, d)], name="out_hidden", out_names=["last_hidden_state"])
    g.emit("Identity", [hidden_states[-2] if len(hidden_states) >= 2 else x], [(1, L, d)],
           name="out_penult", out_names=["penultimate_hidden_state"])
    if cfg.pooled:
        # pooled = final LN state at the EOS position, times text_projection.
        # With fixed 77-token chunks the EOS index is 76.
        idx = g.weight("pool.eos_index", np.array([L - 1], np.int64))
        pooled = g.emit("Gather", [final, idx], [(1, 1, d)], {"axis": 1}, name="pool/gather")
        pooled = g.reshape(pooled, (1, d), name="pool/flatten")
        pd = cfg.proj_dim or d
        proj = g.gen_weight("text_projection.weight",
                            lambda: g.randn(d, pd), shape=(d, pd))
        g.emit("MatMul", [pooled, proj], [(1, pd)], name="pool/proj", out_names=["pooled_output"])
    return g

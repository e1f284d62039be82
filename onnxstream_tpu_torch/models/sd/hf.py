"""HuggingFace CLIP text-encoder checkpoint -> builder weight dict.

Counterpart of ``onnxstream_tpu/models/sd/hf.py``: maps a transformers
CLIPTextModel(WithProjection) state_dict to the graph builder names
(``onnxstream_tpu_torch/models/sd/clip.py``), so real SD text encoders run
without the ONNX hop. Linear weights transpose to (din, dout); the
builder-generated causal mask stays. The arrays are float32 numpy, as the
JAX package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from onnxstream_tpu_torch.models._hf import to_f32 as _np
from onnxstream_tpu_torch.models.sd.clip import ClipConfig


def clip_config_from_hf(hf_config, pooled: bool = False) -> ClipConfig:
    return ClipConfig(
        vocab_size=hf_config.vocab_size,
        width=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        seq=hf_config.max_position_embeddings,
        activation="quick_gelu" if hf_config.hidden_act == "quick_gelu" else "gelu",
        pooled=pooled,
        proj_dim=getattr(hf_config, "projection_dim", 0) if pooled else 0,
    )


def clip_weights_from_hf_state_dict(state_dict: Dict, cfg: ClipConfig) -> Dict[str, np.ndarray]:
    sd = dict(state_dict)

    def g(key):
        return _np(sd[key if key in sd else "text_model." + key])

    out: Dict[str, np.ndarray] = {}

    def put(name, arr):
        out[name + ".bin"] = arr

    put("embeddings.token_embedding.weight", g("embeddings.token_embedding.weight"))
    put("embeddings.position_embedding.weight", g("embeddings.position_embedding.weight")[: cfg.seq])
    for l in range(cfg.layers):
        hp, op = f"encoder.layers.{l}.", f"encoder.layers.{l}"
        for hf_p, ours in (("q_proj", "to_q"), ("k_proj", "to_k"), ("v_proj", "to_v"), ("out_proj", "to_out")):
            put(f"{op}/attn/{ours}.weight", g(hp + f"self_attn.{hf_p}.weight").T.copy())
            put(f"{op}/attn/{ours}.bias", g(hp + f"self_attn.{hf_p}.bias"))
        put(f"{op}/ln1.weight", g(hp + "layer_norm1.weight"))
        put(f"{op}/ln1.bias", g(hp + "layer_norm1.bias"))
        put(f"{op}/ln2.weight", g(hp + "layer_norm2.weight"))
        put(f"{op}/ln2.bias", g(hp + "layer_norm2.bias"))
        put(f"{op}/fc1.weight", g(hp + "mlp.fc1.weight").T.copy())
        put(f"{op}/fc1.bias", g(hp + "mlp.fc1.bias"))
        put(f"{op}/fc2.weight", g(hp + "mlp.fc2.weight").T.copy())
        put(f"{op}/fc2.bias", g(hp + "mlp.fc2.bias"))
    put("final_layer_norm.weight", g("final_layer_norm.weight"))
    put("final_layer_norm.bias", g("final_layer_norm.bias"))
    if cfg.pooled and "text_projection.weight" in sd:
        put("text_projection.weight", _np(sd["text_projection.weight"]).T.copy())
    return out

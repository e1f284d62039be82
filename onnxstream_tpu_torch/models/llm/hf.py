"""HuggingFace llama checkpoint -> builder weight dict.

The reference ships pre-converted llama ONNX on HF (vitoplantamura/
onnxstream-llms); this converter goes straight from a transformers
llama/mistral state_dict to the graph-builder weight names
(onnxstream_tpu_torch/models/llm/llama.py), so any HF llama checkpoint runs
without the ONNX hop. Linear weights transpose from HF's (dout, din) to the
builder's (din, dout); rope tables / masks / shape constants stay
builder-generated.

Counterpart of ``onnxstream_tpu/models/llm/hf.py`` (the same weight dict).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from onnxstream_tpu_torch.models._hf import to_f32 as _np
from onnxstream_tpu_torch.models.llm.llama import LlamaConfig


def weights_from_hf_state_dict(state_dict: Dict, cfg: LlamaConfig) -> Dict[str, np.ndarray]:
    """state_dict keys as produced by transformers LlamaForCausalLM."""
    sd = {k: v for k, v in state_dict.items()}
    out: Dict[str, np.ndarray] = {}

    def put(name: str, arr: np.ndarray) -> None:
        out[name + ".bin"] = arr

    put("model.embed_tokens.weight", _np(sd["model.embed_tokens.weight"]))
    for layer in range(cfg.layers):
        p = f"model.layers.{layer}."
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put(p + f"self_attn.{proj}.weight", _np(sd[p + f"self_attn.{proj}.weight"]).T.copy())
        for proj in ("gate_proj", "up_proj", "down_proj"):
            put(p + f"mlp.{proj}.weight", _np(sd[p + f"mlp.{proj}.weight"]).T.copy())
        put(p + "input_layernorm.weight", _np(sd[p + "input_layernorm.weight"]))
        put(p + "post_attention_layernorm.weight", _np(sd[p + "post_attention_layernorm.weight"]))
    put("model.norm.weight", _np(sd["model.norm.weight"]))
    lm = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])  # tied embeddings
    put("lm_head.weight", _np(lm).T.copy())
    return out


def config_from_hf(hf_config) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        intermediate=hf_config.intermediate_size,
        max_pos=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        eps=hf_config.rms_norm_eps,
    )

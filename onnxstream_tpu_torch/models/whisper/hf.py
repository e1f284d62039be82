"""HuggingFace whisper checkpoint -> builder weight dicts.

Maps a transformers WhisperForConditionalGeneration state_dict to the
encoder/decoder graph weight names (onnxstream_tpu_torch/models/whisper/model.py),
so any HF whisper checkpoint runs without the ONNX hop the reference uses.
Linear weights transpose to (din, dout); the cross-attention K/V projections
land in the ENCODER weight dict (the encoder graph computes the stacked
cross K/V with the decoder's weights, like the converted reference encoder).

Counterpart of ``onnxstream_tpu/models/whisper/hf.py`` (the same weight dicts).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from onnxstream_tpu_torch.models.whisper.model import WhisperConfig


from onnxstream_tpu_torch.models._hf import to_f32 as _np


def config_from_hf(hf_config) -> WhisperConfig:
    return WhisperConfig(
        n_mels=hf_config.num_mel_bins,
        n_vocab=hf_config.vocab_size,
        n_audio_ctx=hf_config.max_source_positions,
        n_audio_state=hf_config.d_model,
        n_audio_head=hf_config.encoder_attention_heads,
        n_audio_layer=hf_config.encoder_layers,
        n_text_ctx=hf_config.max_target_positions,
        n_text_state=hf_config.d_model,
        n_text_head=hf_config.decoder_attention_heads,
        n_text_layer=hf_config.decoder_layers,
        n_audio_ffn=hf_config.encoder_ffn_dim,
        n_text_ffn=hf_config.decoder_ffn_dim,
        sot=hf_config.decoder_start_token_id,
        eot=hf_config.eos_token_id,
    )


def weights_from_hf_state_dict(state_dict: Dict, cfg: WhisperConfig) -> Tuple[Dict, Dict]:
    """Returns (encoder_weights, decoder_weights), keys with the .bin suffix."""
    sd = dict(state_dict)

    def g(key):
        return _np(sd[key if key in sd else "model." + key])

    enc: Dict[str, np.ndarray] = {}
    dec: Dict[str, np.ndarray] = {}

    def pe(name, arr):
        enc[name + ".bin"] = arr

    def pd(name, arr):
        dec[name + ".bin"] = arr

    # encoder stem (HF conv1d (out, in, 3) -> our height-1 conv2d (out, in, 1, 3))
    pe("encoder.conv1.weight_nchw", g("encoder.conv1.weight")[:, :, None, :].copy())
    pe("encoder.conv1.bias", g("encoder.conv1.bias"))
    pe("encoder.conv2.weight_nchw", g("encoder.conv2.weight")[:, :, None, :].copy())
    pe("encoder.conv2.bias", g("encoder.conv2.bias"))
    pe("encoder.positional_embedding", g("encoder.embed_positions.weight")[: cfg.n_audio_ctx])

    for l in range(cfg.n_audio_layer):
        hp, op = f"encoder.layers.{l}.", f"encoder.blocks.{l}"
        pe(f"{op}/attn_q.weight", g(hp + "self_attn.q_proj.weight").T.copy())
        pe(f"{op}/attn_q.bias", g(hp + "self_attn.q_proj.bias"))
        pe(f"{op}/attn_k.weight", g(hp + "self_attn.k_proj.weight").T.copy())
        pe(f"{op}/attn_v.weight", g(hp + "self_attn.v_proj.weight").T.copy())
        pe(f"{op}/attn_v.bias", g(hp + "self_attn.v_proj.bias"))
        pe(f"{op}/attn_out.weight", g(hp + "self_attn.out_proj.weight").T.copy())
        pe(f"{op}/attn_out.bias", g(hp + "self_attn.out_proj.bias"))
        pe(f"{op}/attn_ln.weight", g(hp + "self_attn_layer_norm.weight"))
        pe(f"{op}/attn_ln.bias", g(hp + "self_attn_layer_norm.bias"))
        pe(f"{op}/mlp_fc1.weight", g(hp + "fc1.weight").T.copy())
        pe(f"{op}/mlp_fc1.bias", g(hp + "fc1.bias"))
        pe(f"{op}/mlp_fc2.weight", g(hp + "fc2.weight").T.copy())
        pe(f"{op}/mlp_fc2.bias", g(hp + "fc2.bias"))
        pe(f"{op}/mlp_ln.weight", g(hp + "final_layer_norm.weight"))
        pe(f"{op}/mlp_ln.bias", g(hp + "final_layer_norm.bias"))
    pe("encoder.ln_post.weight", g("encoder.layer_norm.weight"))
    pe("encoder.ln_post.bias", g("encoder.layer_norm.bias"))

    # cross K/V projections live in the encoder graph (stacked cross outputs)
    for l in range(cfg.n_text_layer):
        hp, op = f"decoder.layers.{l}.", f"decoder.blocks.{l}.cross_attn"
        pe(f"{op}/to_k.weight", g(hp + "encoder_attn.k_proj.weight").T.copy())
        pe(f"{op}/to_v.weight", g(hp + "encoder_attn.v_proj.weight").T.copy())
        pe(f"{op}/to_v.bias", g(hp + "encoder_attn.v_proj.bias"))

    emb = g("decoder.embed_tokens.weight")
    pd("decoder.token_embedding.weight", emb)
    pd("decoder.lm_head.weight", emb.T.copy())  # whisper ties proj_out
    pd("decoder.positional_embedding", g("decoder.embed_positions.weight")[: cfg.n_text_ctx])
    for l in range(cfg.n_text_layer):
        hp, op = f"decoder.layers.{l}.", f"decoder.blocks.{l}"
        pd(f"{op}/attn_q.weight", g(hp + "self_attn.q_proj.weight").T.copy())
        pd(f"{op}/attn_q.bias", g(hp + "self_attn.q_proj.bias"))
        pd(f"{op}/attn_k.weight", g(hp + "self_attn.k_proj.weight").T.copy())
        pd(f"{op}/attn_v.weight", g(hp + "self_attn.v_proj.weight").T.copy())
        pd(f"{op}/attn_v.bias", g(hp + "self_attn.v_proj.bias"))
        pd(f"{op}/attn_out.weight", g(hp + "self_attn.out_proj.weight").T.copy())
        pd(f"{op}/attn_out.bias", g(hp + "self_attn.out_proj.bias"))
        pd(f"{op}/attn_ln.weight", g(hp + "self_attn_layer_norm.weight"))
        pd(f"{op}/attn_ln.bias", g(hp + "self_attn_layer_norm.bias"))
        pd(f"{op}/cross_q.weight", g(hp + "encoder_attn.q_proj.weight").T.copy())
        pd(f"{op}/cross_q.bias", g(hp + "encoder_attn.q_proj.bias"))
        pd(f"{op}/cross_out.weight", g(hp + "encoder_attn.out_proj.weight").T.copy())
        pd(f"{op}/cross_out.bias", g(hp + "encoder_attn.out_proj.bias"))
        pd(f"{op}/cross_ln.weight", g(hp + "encoder_attn_layer_norm.weight"))
        pd(f"{op}/cross_ln.bias", g(hp + "encoder_attn_layer_norm.bias"))
        pd(f"{op}/mlp_fc1.weight", g(hp + "fc1.weight").T.copy())
        pd(f"{op}/mlp_fc1.bias", g(hp + "fc1.bias"))
        pd(f"{op}/mlp_fc2.weight", g(hp + "fc2.weight").T.copy())
        pd(f"{op}/mlp_fc2.bias", g(hp + "fc2.bias"))
        pd(f"{op}/mlp_ln.weight", g(hp + "final_layer_norm.weight"))
        pd(f"{op}/mlp_ln.bias", g(hp + "final_layer_norm.bias"))
    pd("decoder.ln.weight", g("decoder.layer_norm.weight"))
    pd("decoder.ln.bias", g("decoder.layer_norm.bias"))
    return enc, dec


def specials_from_generation_config(cfg: WhisperConfig, gc) -> WhisperConfig:
    """Override the multilingual-default special tokens with the checkpoint's
    actual ids (English-only models shift them by one). Mutates cfg."""
    if gc is None:
        return cfg
    if getattr(gc, "no_timestamps_token_id", None) is not None:
        cfg.no_timestamps = gc.no_timestamps_token_id
    task_to_id = getattr(gc, "task_to_id", None) or {}
    if "transcribe" in task_to_id:
        cfg.transcribe = task_to_id["transcribe"]
    if "translate" in task_to_id:
        cfg.translate = task_to_id["translate"]
    if getattr(gc, "decoder_start_token_id", None) is not None:
        cfg.sot = gc.decoder_start_token_id
    if getattr(gc, "eos_token_id", None) is not None:
        cfg.eot = gc.eos_token_id
    # no_speech: transformers exposes it as suppress config on some models
    if getattr(gc, "no_speech_token_id", None) is not None:
        cfg.no_speech = gc.no_speech_token_id
    return cfg

"""Whisper transcription pipeline: audio -> mel -> encoder -> greedy decode.

Mirrors the reference browser example's inference loop (reference
examples/Whisper_wasm/index.html:985-1075):

  * encoder runs once per 30 s window producing stacked cross K/V;
  * the decoder starts from the sot_sequence (sot, language, transcribe,
    no_timestamps) and decodes greedily one token at a time;
  * token suppression: eot and blank at the first step, and always
    no_timestamps / sot / no_speech / translate (index.html:1039-1046);
  * self-KV is a fixed n_text_ctx buffer fed back between steps with an
    `offset` scalar.

Counterpart of ``onnxstream_tpu/models/whisper/pipeline.py``, with the same
surface (``from_synthetic``, ``from_hf``, ``from_dir``, ``_decoder``,
``transcribe``, ``decode_text``) and an explicit ``device``: None means the
first CUDA card (and raises without one), the CPU only when asked. The mel
features stay on the host. The cross K/V and the self-KV buffers stay device
tensors between runs, fed back through ``Session.add_tensor``; the one host
read a token is the last row of the logits.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from onnxstream_tpu_torch.models.whisper.mel import log_mel_spectrogram
from onnxstream_tpu_torch.models.whisper.model import (
    WHISPER_TINY_TEST,
    WhisperConfig,
    build_decoder,
    build_encoder,
    mangle,
)
from onnxstream_tpu_torch.runtime.config import SessionConfig, default_device
from onnxstream_tpu_torch.runtime.session import Session
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def _builder_session(builder, compute_dtype: str, device: torch.device, overrides=None,
                     on_device: bool = False) -> Session:
    """A Session over a builder graph, its weights (with `overrides` from a
    checkpoint) from a dict provider."""
    weights = dict(builder.weights)
    weights.update(overrides or {})
    s = Session(
        config=SessionConfig(compute_dtype=compute_dtype, fuse_ops_in_attention=True,
                             synthetic_device_weights=on_device, device=device),
        weights_provider=DictWeightsProvider(params_from_numpy(weights)),
    )
    s.read_string(builder.to_text())
    return s


class WhisperPipeline:
    def __init__(self, cfg: WhisperConfig, encoder: Session, make_decoder,
                 id_to_token: Optional[Dict[int, str]] = None):
        self.cfg = cfg
        self.encoder = encoder
        self.device = torch.device(encoder.config.device)
        self._make_decoder = make_decoder  # L -> Session
        self._decoders: Dict[int, Session] = {}
        self.id_to_token = id_to_token or {}

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_synthetic(cls, cfg: WhisperConfig = WHISPER_TINY_TEST, seed: int = 0,
                       compute_dtype: str = "float32", on_device: bool = False,
                       device: Optional[torch.device] = None) -> "WhisperPipeline":
        """Random weights from `seed`. on_device: the big float weights are
        synthesized on the device instead of uploaded (timing only)."""
        device = _device(device)
        enc = _builder_session(build_encoder(cfg, seed=seed), compute_dtype, device, on_device=on_device)

        def make_decoder(L: int) -> Session:
            # the same seed for every L: the prefill and decode graphs draw the
            # same parameters; the L-dependent constants (masks, reshape
            # shapes) stay with their own builder
            return _builder_session(build_decoder(cfg, new_len=L, seed=seed + 1), compute_dtype, device,
                                    on_device=on_device)

        return cls(cfg, enc, make_decoder)

    @classmethod
    def from_hf(cls, hf_model, compute_dtype: str = "float32",
                device: Optional[torch.device] = None) -> "WhisperPipeline":
        """Straight from a transformers WhisperForConditionalGeneration (no
        ONNX hop): its weights take the builder graphs' names."""
        from onnxstream_tpu_torch.models.whisper.hf import (
            config_from_hf,
            specials_from_generation_config,
            weights_from_hf_state_dict,
        )

        device = _device(device)
        cfg = config_from_hf(hf_model.config)
        # English-only (.en) checkpoints shift the special-token ids by one;
        # the generation config carries the real values
        specials_from_generation_config(cfg, getattr(hf_model, "generation_config", None))
        enc_w, dec_w = weights_from_hf_state_dict(hf_model.state_dict(), cfg)
        enc = _builder_session(build_encoder(cfg), compute_dtype, device, enc_w)
        return cls(cfg, enc, lambda L: _builder_session(build_decoder(cfg, new_len=L), compute_dtype, device, dec_w))

    @classmethod
    def from_dir(cls, path: str, cfg: WhisperConfig, provider: str = "ram+prefetch",
                 compute_dtype: str = "float32", device: Optional[torch.device] = None) -> "WhisperPipeline":
        """Reference layout: {path}/encoder_fp32/model.txt + decoder_fp32/ +
        tokens file (the browser example fetches the same pieces). One
        decoder Session serves every L, one plan per L."""
        device = _device(device)

        def mk(sub):
            s = Session(config=SessionConfig(compute_dtype=compute_dtype, fuse_ops_in_attention=True,
                                             device=device),
                        weights_provider_name=provider)
            s.read_file(os.path.join(path, sub, "model.txt"))
            return s

        enc = mk("encoder_fp32")
        dec = mk("decoder_fp32")
        return cls(cfg, enc, lambda L: dec)

    # ---------------------------------------------------------------- decoding
    def _decoder(self, L: int) -> Session:
        if L not in self._decoders:
            self._decoders[L] = self._make_decoder(L)
        return self._decoders[L]

    def encode(self, audio: np.ndarray):
        """The encoder's stacked cross K and V for a 30 s window, as device
        tensors in the compute dtype."""
        cfg = self.cfg
        mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels, pad_to=2 * cfg.n_audio_ctx)
        self.encoder.clear_tensors()
        self.encoder.add_tensor(mangle("mel"), mel)
        enc_out = self.encoder.run(device_outputs=True)
        return enc_out[mangle("n_layer_cross_k")], enc_out[mangle("n_layer_cross_v")]

    def transcribe(self, audio: np.ndarray, max_tokens: Optional[int] = None,
                   language_token: Optional[int] = None) -> List[int]:
        """Greedy transcription; returns the emitted token ids (no specials)."""
        cfg = self.cfg
        cross_k, cross_v = self.encode(audio)

        # the self-KV buffers start as zeros on the device, in the dtype the
        # decoder hands them back in
        NL, C, d = cfg.n_text_layer, cfg.n_text_ctx, cfg.n_text_state
        self_k = torch.zeros((NL, 1, C, d), dtype=cross_k.dtype, device=cross_k.device)
        self_v = torch.zeros_like(self_k)

        sot_sequence = list(cfg.sot_sequence)
        if language_token is not None:
            sot_sequence[1] = language_token
        tokens_in: List[int] = sot_sequence
        out_tokens: List[int] = []
        offset = 0
        budget = max_tokens if max_tokens is not None else cfg.n_text_ctx - len(sot_sequence) - 1

        while len(out_tokens) < budget and offset + len(tokens_in) <= cfg.n_text_ctx:
            sess = self._decoder(len(tokens_in))
            sess.clear_tensors()
            sess.add_tensor(mangle("tokens"), np.asarray([tokens_in], np.int64))
            sess.add_tensor(mangle("offset"), np.asarray([offset], np.int64))
            sess.add_tensor(mangle("in_n_layer_self_k_cache"), self_k)
            sess.add_tensor(mangle("in_n_layer_self_v_cache"), self_v)
            sess.add_tensor(mangle("n_layer_cross_k"), cross_k)
            sess.add_tensor(mangle("n_layer_cross_v"), cross_v)
            out = sess.run(device_outputs=True)
            self_k = out[mangle("out_n_layer_self_k_cache")]
            self_v = out[mangle("out_n_layer_self_v_cache")]
            # the one host read of the step: the last position's logits
            logits = out[mangle("logits")][0, -1].float().cpu().numpy().copy()

            # suppression (reference index.html:1039-1046)
            if offset == 0:
                logits[cfg.eot] = -np.inf
                logits[cfg.blank_id] = -np.inf
            for t in (cfg.no_timestamps, cfg.sot, cfg.no_speech, cfg.translate):
                logits[t] = -np.inf

            tok = int(np.argmax(logits))
            offset += len(tokens_in)
            if tok == cfg.eot:
                break
            out_tokens.append(tok)
            tokens_in = [tok]
        return out_tokens

    def decode_text(self, token_ids: List[int]) -> str:
        return "".join(self.id_to_token.get(t, f"<{t}>") for t in token_ids)

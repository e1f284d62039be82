"""Whisper encoder/decoder graphs with the reference tensor contract.

The reference browser example runs converted whisper ONNX with these I/O
names (reference examples/Whisper_wasm/index.html:1290-1327, '_' mangled to
'_5F_'):

  encoder:  mel (1, n_mels, 2*n_audio_ctx)
            -> n_layer_cross_k / n_layer_cross_v
               (n_text_layer, 1, n_audio_ctx, n_text_state)
  decoder:  tokens (1, L) int64, offset (1,) int64,
            in_n_layer_self_k_cache / in_n_layer_self_v_cache
               (n_text_layer, 1, n_text_ctx, n_text_state),
            n_layer_cross_k / n_layer_cross_v
            -> logits (1, L, n_vocab),
               out_n_layer_self_k_cache / out_n_layer_self_v_cache

The self-KV cache is a FIXED n_text_ctx buffer with new rows written at
`offset` — the reference design already matches XLA's static-shape model, so
here the write happens in-graph (ScatterND at offset) and attention masks
columns >= offset + row + 1, exactly like the bucketed llama decode
(onnxstream_tpu_torch/models/llm/llama.py). The decoder is built per new-token
length L (prefill = len(sot_sequence), decode = 1), two planned graphs in all.

Counterpart of ``onnxstream_tpu/models/whisper/model.py``: the same builders,
so both packages make the same text and the same numpy weights for a seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from onnxstream_tpu_torch.convert.builder import GraphBuilder, T


def mangle(name: str) -> str:
    return name.replace("_", "_5F_")


@dataclasses.dataclass
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 512
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6
    n_audio_ffn: int = 0  # 0 -> 4 * n_audio_state
    n_text_ffn: int = 0  # 0 -> 4 * n_text_state
    # special tokens (metadata.json of the browser example)
    sot: int = 50258
    eot: int = 50257
    blank_id: int = 220
    no_timestamps: int = 50363
    no_speech: int = 50362
    translate: int = 50358
    transcribe: int = 50359

    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        return (self.sot, self.sot + 1, self.transcribe, self.no_timestamps)

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head


WHISPER_BASE = WhisperConfig()

WHISPER_TINY_TEST = WhisperConfig(
    n_mels=80, n_vocab=64, n_audio_ctx=8, n_audio_state=32, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=16, n_text_state=32, n_text_head=2, n_text_layer=2,
    sot=58, eot=57, blank_id=20, no_timestamps=63, no_speech=62, translate=59,
    transcribe=60,
)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper encoder positional embedding."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2, dtype=np.float32))
    scaled = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def build_encoder(cfg: WhisperConfig = WHISPER_TINY_TEST, seed: int = 0) -> GraphBuilder:
    g = GraphBuilder(seed=seed)
    d, Ta = cfg.n_audio_state, cfg.n_audio_ctx
    Tin = 2 * Ta

    mel = g.input(mangle("mel"), (1, cfg.n_mels, Tin))

    # conv1d stem as height-1 Conv2D (the converter promotes Conv1D the same
    # way, reference src/onnxstream.cpp Conv1D promote)
    x4 = g.reshape(mel, (1, cfg.n_mels, 1, Tin), name="stem/4d")
    x4 = g.emit(
        "Conv",
        [x4, g.weight("encoder.conv1.weight_nchw", g.randn(d, cfg.n_mels, 1, 3)),
         g.weight("encoder.conv1.bias", g.randn(d, scale=0.01))],
        [(1, d, 1, Tin)],
        {"dilations": "1,1", "group": 1, "kernel_shape": "1,3", "pads": "0,1,0,1", "strides": "1,1"},
        name="encoder/conv1",
    )
    x4 = g.gelu(x4)
    x4 = g.emit(
        "Conv",
        [x4, g.weight("encoder.conv2.weight_nchw", g.randn(d, d, 1, 3)),
         g.weight("encoder.conv2.bias", g.randn(d, scale=0.01))],
        [(1, d, 1, Ta)],
        {"dilations": "1,1", "group": 1, "kernel_shape": "1,3", "pads": "0,1,0,1", "strides": "1,2"},
        name="encoder/conv2",
    )
    x4 = g.gelu(x4)
    x = g.reshape(x4, (1, d, Ta), name="stem/3d")
    x = g.transpose(x, (0, 2, 1), name="stem/to_seq")
    x = g.add(x, g.weight("encoder.positional_embedding", _sinusoids(Ta, d)),
              out_shape=(1, Ta, d), name="stem/pos")

    Ha, hda = cfg.n_audio_head, d // cfg.n_audio_head

    def enc_attention(a: T, nm: str) -> T:
        # whisper projection bias pattern: q/v/out yes, k no (transformers
        # WhisperAttention)
        def heads(t: T, tag: str) -> T:
            t = g.reshape(t, (1, Ta, Ha, hda), name=f"{tag}/r")
            return g.transpose(t, (0, 2, 1, 3), name=f"{tag}/t")

        q = heads(g.matmul_w(a, d, name=f"{nm}/attn_q"), f"{nm}/qh")
        k = heads(g.matmul_w(a, d, name=f"{nm}/attn_k", bias=False), f"{nm}/kh")
        v = heads(g.matmul_w(a, d, name=f"{nm}/attn_v"), f"{nm}/vh")
        kt = g.transpose(k, (0, 1, 3, 2), name=f"{nm}/kT")
        logits = g.emit("MatMul", [q, kt], [(1, Ha, Ta, Ta)], name=f"{nm}/qk")
        logits = g.mul(logits, g.scalar(1.0 / math.sqrt(hda), name=f"{nm}.scale"), name=f"{nm}/scale")
        probs = g.softmax(logits, -1)
        o = g.emit("MatMul", [probs, v], [(1, Ha, Ta, hda)], name=f"{nm}/pv")
        o = g.transpose(o, (0, 2, 1, 3), name=f"{nm}/ot")
        o = g.reshape(o, (1, Ta, d), name=f"{nm}/or")
        return g.matmul_w(o, d, name=f"{nm}/attn_out")

    for layer in range(cfg.n_audio_layer):
        nm = f"encoder.blocks.{layer}"
        a = g.layer_norm(x, name=f"{nm}/attn_ln")
        x = g.add(x, enc_attention(a, nm), name=f"{nm}/res1")
        a = g.layer_norm(x, name=f"{nm}/mlp_ln")
        h = g.matmul_w(a, cfg.n_audio_ffn or d * 4, name=f"{nm}/mlp_fc1")
        h = g.gelu(h)
        h = g.matmul_w(h, d, name=f"{nm}/mlp_fc2")
        x = g.add(x, h, name=f"{nm}/res2")
    x = g.layer_norm(x, name="encoder.ln_post")

    # cross K/V for every decoder layer, computed with the decoder's
    # cross-attention projection weights and stacked over layers — the same
    # bundling the converted encoder ships (index.html:1317-1321)
    ks, vs = [], []
    ds = cfg.n_text_state
    for layer in range(cfg.n_text_layer):
        nm = f"decoder.blocks.{layer}.cross_attn"
        k = g.matmul_w(x, ds, name=f"{nm}/to_k", bias=False)
        v = g.matmul_w(x, ds, name=f"{nm}/to_v")
        ks.append(g.reshape(k, (1, 1, Ta, ds), name=f"{nm}/k4"))
        vs.append(g.reshape(v, (1, 1, Ta, ds), name=f"{nm}/v4"))
    ck = ks[0] if len(ks) == 1 else g.concat(ks, axis=0, name="cross/k_stack")
    cv = vs[0] if len(vs) == 1 else g.concat(vs, axis=0, name="cross/v_stack")
    g.emit("Identity", [ck], [(cfg.n_text_layer, 1, Ta, ds)], name="out_ck",
           out_names=[mangle("n_layer_cross_k")])
    g.emit("Identity", [cv], [(cfg.n_text_layer, 1, Ta, ds)], name="out_cv",
           out_names=[mangle("n_layer_cross_v")])
    return g


def build_decoder(cfg: WhisperConfig = WHISPER_TINY_TEST, new_len: int = 1, seed: int = 0) -> GraphBuilder:
    """One L=new_len decoder graph over the fixed n_text_ctx self-KV buffer."""
    g = GraphBuilder(seed=seed)
    L, C = new_len, cfg.n_text_ctx
    d, H, hd, Ta = cfg.n_text_state, cfg.n_text_head, cfg.head_dim, cfg.n_audio_ctx
    NL = cfg.n_text_layer

    tokens = g.input(mangle("tokens"), (1, L))
    offset = g.input(mangle("offset"), (1,))
    in_k = g.input(mangle("in_n_layer_self_k_cache"), (NL, 1, C, d))
    in_v = g.input(mangle("in_n_layer_self_v_cache"), (NL, 1, C, d))
    cross_k = g.input(mangle("n_layer_cross_k"), (NL, 1, Ta, d))
    cross_v = g.input(mangle("n_layer_cross_v"), (NL, 1, Ta, d))

    # embeddings: token + learned positional rows [offset : offset+L]
    tok_emb = g.weight("decoder.token_embedding.weight", g.randn(cfg.n_vocab, d, scale=0.02))
    x = g.emit("Gather", [tok_emb, tokens], [(1, L, d)], {"axis": 0}, name="emb/tok")
    pos_emb = g.weight("decoder.positional_embedding", g.randn(C, d, scale=0.02))
    arangeL = g.weight(f"emb.arange{L}", np.arange(L, dtype=np.int64))
    pos_ids = g.emit("Add", [arangeL, offset], [(L,)], name="emb/pos_ids")
    pe = g.emit("Gather", [pos_emb, pos_ids], [(L, d)], {"axis": 0}, name="emb/pos")
    x = g.add(x, pe, out_shape=(1, L, d), name="emb/add")

    # additive mask over the C-row buffer: row l may see col <= offset + l
    col = g.weight(f"mask.col{C}", np.arange(C, dtype=np.int64).reshape(1, 1, 1, C))
    row1 = g.weight(f"mask.row{L}", (np.arange(L, dtype=np.int64) + 1).reshape(1, 1, L, 1))
    off4 = g.emit("Unsqueeze", [offset, g.weight("mask.unsq", np.array([0, 1, 2], np.int64))],
                  [(1, 1, 1, 1)], name="mask/off4")
    thresh = g.emit("Add", [row1, off4], [(1, 1, L, 1)], name="mask/thresh")
    valid = g.emit("Less", [col, thresh], [(1, 1, L, C)], name="mask/valid")
    mask = g.emit("Where", [valid, g.weight("mask.zero", np.zeros(1, np.float32)),
                            g.weight("mask.neg", np.full(1, -1e9, np.float32))],
                  [(1, 1, L, C)], name="mask/additive")

    # ScatterND indices (per layer): write L rows at (layer, 0, offset+l)
    off1 = g.emit("Unsqueeze", [offset, g.weight("kvw.unsq", np.array([0], np.int64))],
                  [(1, 1)], name="kvw/off2")
    l_col = g.weight(f"kvw.l{L}", np.arange(L, dtype=np.int64).reshape(L, 1))
    pos_col = g.emit("Add", [l_col, off1], [(L, 1)], name="kvw/pos")
    zero_col = g.weight(f"kvw.zero{L}", np.zeros((L, 1), np.int64))

    def heads(t: T, ln: int, tag: str) -> T:
        t = g.reshape(t, (1, ln, H, hd), name=f"{tag}/r")
        return g.transpose(t, (0, 2, 1, 3), name=f"{tag}/t")

    def sdpa(q: T, k: T, v: T, lk: int, tag: str, add_mask) -> T:
        kt = g.transpose(k, (0, 1, 3, 2), name=f"{tag}/kT")
        logits = g.emit("MatMul", [q, kt], [(1, H, L, lk)], name=f"{tag}/qk")
        logits = g.mul(logits, g.scalar(1.0 / math.sqrt(hd), name=f"{tag}.scale"), name=f"{tag}/scale")
        if add_mask is not None:
            logits = g.emit("Add", [logits, add_mask], [(1, H, L, lk)], name=f"{tag}/mask")
        probs = g.softmax(logits, -1)
        o = g.emit("MatMul", [probs, v], [(1, H, L, hd)], name=f"{tag}/pv")
        o = g.transpose(o, (0, 2, 1, 3), name=f"{tag}/ot")
        return g.reshape(o, (1, L, d), name=f"{tag}/or")

    k_cache, v_cache = in_k, in_v
    for layer in range(NL):
        nm = f"decoder.blocks.{layer}"
        lyr_col = g.weight(f"kvw.layer{layer}x{L}", np.full((L, 1), layer, np.int64))
        idx = g.concat([lyr_col, zero_col, pos_col], axis=1, name=f"{nm}/kvw_idx")  # (L, 3)

        a = g.layer_norm(x, name=f"{nm}/attn_ln")
        q = heads(g.matmul_w(a, d, name=f"{nm}/attn_q"), L, f"{nm}/q")
        k_new = g.matmul_w(a, d, name=f"{nm}/attn_k", bias=False)  # (1, L, d)
        v_new = g.matmul_w(a, d, name=f"{nm}/attn_v")
        k_cache = g.emit("ScatterND", [k_cache, idx, g.reshape(k_new, (L, d), name=f"{nm}/k2")],
                         [(NL, 1, C, d)], name=f"{nm}/scatk")
        v_cache = g.emit("ScatterND", [v_cache, idx, g.reshape(v_new, (L, d), name=f"{nm}/v2")],
                         [(NL, 1, C, d)], name=f"{nm}/scatv")
        sel = g.weight(f"sel.layer{layer}", np.array([layer], np.int64))
        k_l = g.emit("Gather", [k_cache, sel], [(1, 1, C, d)], {"axis": 0}, name=f"{nm}/k_sel")
        k_l = g.reshape(k_l, (1, C, d), name=f"{nm}/k_sel3")
        v_l = g.emit("Gather", [v_cache, sel], [(1, 1, C, d)], {"axis": 0}, name=f"{nm}/v_sel")
        v_l = g.reshape(v_l, (1, C, d), name=f"{nm}/v_sel3")
        o = sdpa(q, heads(k_l, C, f"{nm}/kh"), heads(v_l, C, f"{nm}/vh"), C, f"{nm}/self", mask)
        o = g.matmul_w(o, d, name=f"{nm}/attn_out")
        x = g.add(x, o, name=f"{nm}/res1")

        a = g.layer_norm(x, name=f"{nm}/cross_ln")
        q = heads(g.matmul_w(a, d, name=f"{nm}/cross_q"), L, f"{nm}/cq")
        ck_l = g.emit("Gather", [cross_k, sel], [(1, 1, Ta, d)], {"axis": 0}, name=f"{nm}/ck_sel")
        ck_l = g.reshape(ck_l, (1, Ta, d), name=f"{nm}/ck_sel3")
        cv_l = g.emit("Gather", [cross_v, sel], [(1, 1, Ta, d)], {"axis": 0}, name=f"{nm}/cv_sel")
        cv_l = g.reshape(cv_l, (1, Ta, d), name=f"{nm}/cv_sel3")
        o = sdpa(q, heads(ck_l, Ta, f"{nm}/ckh"), heads(cv_l, Ta, f"{nm}/cvh"), Ta, f"{nm}/cross", None)
        o = g.matmul_w(o, d, name=f"{nm}/cross_out")
        x = g.add(x, o, name=f"{nm}/res2")

        a = g.layer_norm(x, name=f"{nm}/mlp_ln")
        h = g.matmul_w(a, cfg.n_text_ffn or d * 4, name=f"{nm}/mlp_fc1")
        h = g.gelu(h)
        h = g.matmul_w(h, d, name=f"{nm}/mlp_fc2")
        x = g.add(x, h, name=f"{nm}/res3")

    x = g.layer_norm(x, name="decoder.ln")
    # logits tied to the token embedding (whisper decoder ties lm head)
    head_w = g.weight("decoder.lm_head.weight",
                      g.weights["decoder.token_embedding.weight.bin"].T.copy())
    g.emit("MatMul", [x, head_w], [(1, L, cfg.n_vocab)], name="logits_mm",
           out_names=[mangle("logits")])
    g.emit("Identity", [k_cache], [(NL, 1, C, d)], name="out_k",
           out_names=[mangle("out_n_layer_self_k_cache")])
    g.emit("Identity", [v_cache], [(NL, 1, C, d)], name="out_v",
           out_names=[mangle("out_n_layer_self_v_cache")])
    return g

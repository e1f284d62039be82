"""Llama-architecture graphs with KV-cache-as-graph-I/O (bucketed for XLA).

The reference runs converted llama ONNX with truly dynamic shapes: 44/64
`pkv*` inputs start at seq-dim 0 and grow every token (src/llm.cpp:396-439).
XLA wants static shapes, so this is the one place the reference design is
re-done (SURVEY.md section 7 item 8): graphs are built per (new_len L,
past_bucket P) pair; past K/V arrive padded to P, a scalar `cache_len` input
masks the invalid tail, and the emitted `opkv*` outputs are (P+L)-long so the
pipeline can feed them back (padding up only at bucket boundaries). All
attention masking is an additive mask folded into the SDPA fusion.

RoPE uses Gather from precomputed cos/sin tables; RMSNorm/GQA/SwiGLU are
emitted in the converted-model op decomposition.

Counterpart of ``onnxstream_tpu/models/llm/llama.py`` (same graphs, same
weights for the same seed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from onnxstream_tpu_torch.convert.builder import GraphBuilder, T


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32003
    dim: int = 2048
    layers: int = 22
    heads: int = 32
    kv_heads: int = 4
    intermediate: int = 5632
    max_pos: int = 2048
    rope_theta: float = 10000.0
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


TINYLLAMA = LlamaConfig()
MISTRAL = LlamaConfig(
    vocab_size=32000, dim=4096, layers=32, heads=32, kv_heads=8,
    intermediate=14336, max_pos=4096, eps=1e-5
)
LLAMA_TINY = LlamaConfig(
    vocab_size=503, dim=64, layers=2, heads=4, kv_heads=2, intermediate=128, max_pos=128
)


def _rope_tables(cfg: LlamaConfig) -> Tuple[np.ndarray, np.ndarray]:
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    t = np.arange(cfg.max_pos, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # (max_pos, hd/2)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def build_llama(cfg: LlamaConfig, new_len: int = 1, past: int = 0, seed: int = 0,
                weight_bank=None, lazy_weights: bool = False) -> GraphBuilder:
    """One (L=new_len, P=past_bucket) graph.

    Inputs: input_ids (1,L) int64, position_ids (1,L) int64,
            cache_len (1,) int64 [only when past>0],
            pkv{2i}/pkv{2i+1} (1, kv_heads, P, head_dim) [only when past>0] —
            a fixed bucket-sized buffer; rows >= cache_len are free space.
    Outputs: logits (1, L, vocab), next_token (1,) [greedy argmax of the last
            valid position], opkv{j}:
              past>0: the SAME bucket-sized buffer with the L new rows written
                      at position cache_len in-graph (ScatterND) — feeds back
                      as pkv with zero host work;
              past=0: the fresh (1, kv_heads, L, head_dim) cache.
    """
    g = GraphBuilder(seed=seed, weight_bank=weight_bank, lazy_weights=lazy_weights)
    L, P = new_len, past
    d, H, KV, hd = cfg.dim, cfg.heads, cfg.kv_heads, cfg.head_dim
    Ttot = P if P else L  # attention span: the KV bucket, or the prefill len

    input_ids = g.input("input_5F_ids", (1, L))
    position_ids = g.input("position_5F_ids", (1, L))
    cache_len = g.input("cache_5F_len", (1,)) if P else None

    embed = g.gen_weight("model.embed_tokens.weight", lambda: g.randn(cfg.vocab_size, d, scale=0.02),
                         shape=(cfg.vocab_size, d))
    x = g.emit("Gather", [embed, input_ids], [(1, L, d)], {"axis": 0}, name="embed/gather")

    cos_tab, sin_tab = _rope_tables(cfg)
    cos_w = g.weight("rope.cos", cos_tab)
    sin_w = g.weight("rope.sin", sin_tab)
    cos = g.emit("Gather", [cos_w, position_ids], [(1, L, hd)], {"axis": 0}, name="rope/cos")
    sin = g.emit("Gather", [sin_w, position_ids], [(1, L, hd)], {"axis": 0}, name="rope/sin")
    cos = g.emit("Unsqueeze", [cos, g.weight("rope.unsq", np.array([1], np.int64))], [(1, 1, L, hd)], name="rope/cos4")
    sin = g.emit("Unsqueeze", [sin, g.weight("rope.unsq", np.array([1], np.int64))], [(1, 1, L, hd)], name="rope/sin4")

    # additive attention mask.
    #   past=0 (prefill): static causal (1,1,L,L).
    #   past>0 (bucketed): the KV buffer has P rows; row l of the query may
    #   see col <= cache_len + l (valid past plus the new rows written below).
    if P:
        col = g.weight(f"mask.col{P}", np.arange(P, dtype=np.int64).reshape(1, 1, 1, P))
        row1 = g.weight(f"mask.row{L}", (np.arange(L, dtype=np.int64) + 1).reshape(1, 1, L, 1))
        cl = g.emit("Unsqueeze", [cache_len, g.weight("mask.unsq", np.array([0, 1, 2], np.int64))],
                    [(1, 1, 1, 1)], name="mask/len4")
        thresh = g.emit("Add", [row1, cl], [(1, 1, L, 1)], name="mask/thresh")
        valid = g.emit("Less", [col, thresh], [(1, 1, L, P)], name="mask/valid")
        mask = g.emit("Where", [valid, g.weight("mask.zero", np.zeros(1, np.float32)),
                                g.weight("mask.neg", np.full(1, -1e9, np.float32))],
                      [(1, 1, L, P)], name="mask/additive")
    else:
        causal = np.tril(np.ones((L, L), bool)).reshape(1, 1, L, L)
        mask = g.weight("mask.static", np.where(causal, 0.0, -1e9).astype(np.float32))

    # ScatterND indices for writing L new KV rows at cache_len (past>0)
    if P:
        n_upd = KV * L
        head_col = g.weight(f"kvw.head{n_upd}", np.repeat(np.arange(KV, dtype=np.int64), L).reshape(n_upd, 1))
        l_col = g.weight(f"kvw.l{n_upd}", np.tile(np.arange(L, dtype=np.int64), KV).reshape(n_upd, 1))
        cl1 = g.emit("Unsqueeze", [cache_len, g.weight("kvw.unsq", np.array([0], np.int64))],
                     [(1, 1)], name="kvw/len2")
        pos_col = g.emit("Add", [l_col, cl1], [(n_upd, 1)], name="kvw/pos")
        kv_indices2 = g.concat([head_col, pos_col], axis=1, name="kvw/indices")

    def rmsnorm(t: T, name: str) -> T:
        sq = g.binary("Pow", t, g.scalar(2.0, name=f"{name}.two"), out_shape=t.shape, name=f"{name}/pow")
        var = g.emit("ReduceMean", [sq], [t.shape[:-1] + (1,)], {"axes": "-1", "keepdims": 1}, name=f"{name}/mean")
        var = g.add(var, g.scalar(cfg.eps, name=f"{name}.eps"), name=f"{name}/eps")
        std = g.emit("Sqrt", [var], [var.shape], name=f"{name}/sqrt")
        y = g.binary("Div", t, std, out_shape=t.shape, name=f"{name}/div")
        w = g.weight(f"{name}.weight", np.ones(d, np.float32))
        return g.mul(y, w, name=f"{name}/mul")

    def rope(t: T, name: str) -> T:
        # t: (1, h, L, hd); rotate_half = (-x2, x1)
        half = hd // 2
        x1, x2 = g.split(t, [half, half], axis=-1)
        negx2 = g.emit("Neg", [x2], [x2.shape], name=f"{name}/neg")
        rot = g.concat([negx2, x1], axis=-1, name=f"{name}/rot")
        return g.add(g.mul(t, cos, name=f"{name}/tc"), g.mul(rot, sin, name=f"{name}/rs"), name=f"{name}/rope")

    def heads_split(t: T, n: int, name: str) -> T:
        t = g.reshape(t, (1, L, n, hd), name=f"{name}/r")
        return g.transpose(t, (0, 2, 1, 3), name=f"{name}/t")

    for layer in range(cfg.layers):
        nm = f"model.layers.{layer}"
        h_in = x
        a = rmsnorm(x, f"{nm}.input_layernorm")
        q = heads_split(g.matmul_w(a, H * hd, name=f"{nm}.self_attn.q_proj", bias=False), H, f"{nm}/q")
        k = heads_split(g.matmul_w(a, KV * hd, name=f"{nm}.self_attn.k_proj", bias=False), KV, f"{nm}/k")
        v = heads_split(g.matmul_w(a, KV * hd, name=f"{nm}.self_attn.v_proj", bias=False), KV, f"{nm}/v")
        q = rope(q, f"{nm}/ropeq")
        k = rope(k, f"{nm}/ropek")

        if P:
            pk = g.input(f"pkv{2 * layer}", (1, KV, P, hd))
            pv = g.input(f"pkv{2 * layer + 1}", (1, KV, P, hd))
            k_upd = g.reshape(k, (KV * L, hd), name=f"{nm}/k_upd")
            v_upd = g.reshape(v, (KV * L, hd), name=f"{nm}/v_upd")
            pk3 = g.reshape(pk, (1 * KV, P, hd), name=f"{nm}/pk3")
            pv3 = g.reshape(pv, (1 * KV, P, hd), name=f"{nm}/pv3")
            # indices are (N,3) over (b*kv collapsed? no: (kv, pos)) — use
            # depth-2 indices over the collapsed (kv, P, hd) layout
            k3 = g.emit("ScatterND", [pk3, kv_indices2, k_upd], [(KV, P, hd)], name=f"{nm}/scatk")
            v3 = g.emit("ScatterND", [pv3, kv_indices2, v_upd], [(KV, P, hd)], name=f"{nm}/scatv")
            k_full = g.reshape(k3, (1, KV, P, hd), name=f"{nm}/k_full")
            v_full = g.reshape(v3, (1, KV, P, hd), name=f"{nm}/v_full")
        else:
            k_full, v_full = k, v

        g.emit("Identity", [k_full], [k_full.shape], name=f"{nm}/outk", out_names=[f"opkv{2 * layer}"])
        g.emit("Identity", [v_full], [v_full.shape], name=f"{nm}/outv", out_names=[f"opkv{2 * layer + 1}"])

        # GQA expand kv -> q heads (converted-model decomposition)
        if H != KV:
            rep = H // KV
            ke = g.emit("Unsqueeze", [k_full, g.weight("gqa.unsq", np.array([2], np.int64))],
                        [(1, KV, 1, Ttot, hd)], name=f"{nm}/ke_u")
            ke = g.emit("Expand", [ke, g.weight(f"gqa.shape{Ttot}", np.array([1, KV, rep, Ttot, hd], np.int64))],
                        [(1, KV, rep, Ttot, hd)], name=f"{nm}/ke_e")
            ke = g.reshape(ke, (1, H, Ttot, hd), name=f"{nm}/ke_r")
            ve = g.emit("Unsqueeze", [v_full, g.weight("gqa.unsq", np.array([2], np.int64))],
                        [(1, KV, 1, Ttot, hd)], name=f"{nm}/ve_u")
            ve = g.emit("Expand", [ve, g.weight(f"gqa.shape{Ttot}", np.array([1, KV, rep, Ttot, hd], np.int64))],
                        [(1, KV, rep, Ttot, hd)], name=f"{nm}/ve_e")
            ve = g.reshape(ve, (1, H, Ttot, hd), name=f"{nm}/ve_r")
        else:
            ke, ve = k_full, v_full

        kt = g.transpose(ke, (0, 1, 3, 2), name=f"{nm}/kT")
        logits = g.emit("MatMul", [q, kt], [(1, H, L, Ttot)], name=f"{nm}/qk")
        logits = g.mul(logits, g.scalar(1.0 / math.sqrt(hd), name=f"{nm}.scale"), name=f"{nm}/scale")
        logits = g.emit("Add", [logits, mask], [(1, H, L, Ttot)], name=f"{nm}/mask")
        probs = g.softmax(logits, -1)
        o = g.emit("MatMul", [probs, ve], [(1, H, L, hd)], name=f"{nm}/pv")
        o = g.transpose(o, (0, 2, 1, 3), name=f"{nm}/ot")
        o = g.reshape(o, (1, L, H * hd), name=f"{nm}/or")
        o = g.matmul_w(o, d, name=f"{nm}.self_attn.o_proj", bias=False)
        x = g.add(h_in, o, name=f"{nm}/res1")

        h2 = rmsnorm(x, f"{nm}.post_attention_layernorm")
        gate = g.matmul_w(h2, cfg.intermediate, name=f"{nm}.mlp.gate_proj", bias=False)
        up = g.matmul_w(h2, cfg.intermediate, name=f"{nm}.mlp.up_proj", bias=False)
        act = g.mul(g.silu(gate), up, name=f"{nm}/swiglu")
        down = g.matmul_w(act, d, name=f"{nm}.mlp.down_proj", bias=False)
        x = g.add(x, down, name=f"{nm}/res2")

    x = rmsnorm(x, "model.norm")
    head = g.gen_weight("lm_head.weight", lambda: g.randn(d, cfg.vocab_size, scale=0.02),
                        shape=(d, cfg.vocab_size))
    logits_t = g.emit("MatMul", [x, head], [(1, L, cfg.vocab_size)], name="lm_head", out_names=["logits_all"])
    g.emit("Identity", [logits_t], [(1, L, cfg.vocab_size)], name="logits_out", out_names=["logits"])
    # greedy next token computed in-graph: only 8 bytes leave the device per
    # decode step (last_5F_pos selects the final *valid* row under padding)
    last_pos = g.input("last_5F_pos", (1,))
    last = g.emit("Gather", [logits_t, last_pos], [(1, 1, cfg.vocab_size)], {"axis": 1}, name="last/gather")
    g.emit("ArgMax", [last], [(1, 1)], {"axis": -1, "keepdims": 0}, name="next", out_names=["next_token"])
    return g


def param_count(cfg: LlamaConfig) -> int:
    d, hd = cfg.dim, cfg.head_dim
    per_layer = d * cfg.heads * hd + 2 * d * cfg.kv_heads * hd + cfg.heads * hd * d + 3 * d * cfg.intermediate + 2 * d
    return cfg.vocab_size * d * 2 + cfg.layers * per_layer + d

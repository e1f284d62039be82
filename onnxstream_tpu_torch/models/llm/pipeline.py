"""LLM chat pipeline: prefill + bucketed KV-cache decode.

Counterpart of ``onnxstream_tpu/models/llm/pipeline.py``, with the same
surface (``_session``, ``reset``, ``forward``, ``decode_on_device``,
``generate_on_device``, ``generate``, ``chat_turn``). The reference flow
(src/llm.cpp:396-497): prefill = one run with the full prompt; decode = one
run per token with a 1-token input and a growing pkv. Here the KV cache lives
on the device as torch tensors, padded to bucket sizes, and one Session (one
executor) serves each (L, P) graph:

    past buckets: 32, 64, 128, ... max_pos
    graphs: (L=prompt_bucket, P=0) for prefill, (L=1, P=bucket) for decode

Outputs ``opkv*`` are fed back as ``pkv*`` without leaving the device;
padding up to a larger bucket happens on the device too. Every session shares
one upload of the model weights (``SessionConfig.shared_device_weight_cache``)
and the graph builder's host weights (``GraphBuilder.weight_bank``). On a CUDA
device each session's executor replays a captured CUDA graph from its second
run on (``runtime/executor.py``): the prefill from the second request, the
decode graph at every token after its first. Their graphs share one memory
pool.

``decode_on_device`` takes the place of the JAX package's ``lax.scan``: a
Python loop over the (L=1, P) executor whose inputs are all device tensors
(the in-graph ``next_token``, a device position counter), so the host never
waits for the card inside the loop; only the final (n,) ids cross to the
host.

With ``mesh=`` (``parallel.sharding.make_mesh``; one process a rank, e.g.
under ``parallel.launch.spawn``) every session runs tensor-parallel: the
q / k / v / o and MLP projections shard over "tp" and the KV cache over its
head axis (``tp_kv_head_inputs``), so ``kv[i]`` is this rank's (1,
kv_heads / tp, P, head_dim) shard, fed back as a ``LocalShard``. Every rank
runs the same calls: the next token comes from gathered logits, equal on
every rank. With ``int8_weights`` too, a rank's int8 weights are its
column slices of the one-device quantization (``runtime/executor.py``), and
kernel 6 runs at the local N.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from onnxstream_tpu_torch.dtypes import dtype_name, to_torch
from onnxstream_tpu_torch.models.llm.llama import LlamaConfig, build_llama
from onnxstream_tpu_torch.models.llm.tokenizer import SentencePieceBPE, chat_template
from onnxstream_tpu_torch.parallel import LocalShard
from onnxstream_tpu_torch.runtime.config import SessionConfig, default_device
from onnxstream_tpu_torch.runtime.session import Session
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, is_lazy


def _next_bucket(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds max bucket {buckets[-1]}")


def _host_tensor(arr) -> torch.Tensor:
    """A host weight as a torch tensor, sharing a writable numpy array's
    memory: the multi-GB model weights are not copied a second time. A
    ``LazyArray`` placeholder stays one (``DictWeightsProvider``
    materializes it if the host asks for it)."""
    if isinstance(arr, torch.Tensor) or is_lazy(arr):
        return arr
    if isinstance(arr, np.ndarray) and arr.flags.writeable and dtype_name(arr.dtype) != "bfloat16":
        return torch.from_numpy(arr)
    return to_torch(arr)


def _upcast_rmsnorm(op_type: str, op_name: str) -> bool:
    return "input_layernorm" in op_name or "post_attention_layernorm" in op_name


class LlamaPipeline:
    def __init__(
        self,
        cfg: LlamaConfig,
        weights: Dict[str, np.ndarray] = None,
        tokenizer: Optional[SentencePieceBPE] = None,
        compute_dtype: str = "float32",
        buckets: Optional[List[int]] = None,
        is_tiny_chat: bool = True,
        seed: int = 0,
        int8_weights: bool = False,
        synthetic_on_device: bool = False,
        mesh=None,
        device: Optional[torch.device] = None,
    ):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        # None: the first CUDA card (raises without one); the CPU only when asked
        self.device = default_device() if device is None else torch.device(device)
        # int8 weights: every 2-D floating MatMul weight is quantized at first
        # fetch to symmetric per-channel s8 (force_uint8_storage_set) and its
        # MatMuls run through kernels/qmatmul.w8a8_dyn_matmul: decode reads 1
        # byte per weight instead of 2
        self.int8_weights = int8_weights
        # timing runs: the builder emits LazyArray placeholders and every
        # session generates the big weights on the device
        # (SessionConfig.synthetic_device_weights): no host materialization
        # and no upload. Numerically meaningless
        self.synthetic_on_device = synthetic_on_device
        self.mesh = mesh
        self.tokenizer = tokenizer
        self.is_tiny_chat = is_tiny_chat
        self.seed = seed
        self._ext_weights = weights
        self.buckets = buckets or [b for b in (32, 64, 128, 256, 512, 1024, 2048, 4096) if b <= cfg.max_pos]
        self._sessions: Dict[tuple, Session] = {}
        # one device upload of the model weights shared by every (L, P) graph
        self._shared_dev_weights: Dict = {}
        # one host-side generation of the random weights shared by every
        # (L, P) graph build (GraphBuilder.weight_bank), and its torch view
        self._weight_bank: Dict[str, np.ndarray] = {}
        self._host_params: Dict[str, torch.Tensor] = {}
        # one CUDA-graph memory pool for every (L, P) session's captured graph
        self._graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        # device-resident cache state
        self.kv: Optional[List[torch.Tensor]] = None  # 2*layers tensors (1, kv, P, hd), padded
        self.cache_len = 0

    # --------------------------------------------------------------- session
    def _session_config(self) -> SessionConfig:
        return SessionConfig(
            compute_dtype=self.compute_dtype,
            fuse_ops_in_attention=True,
            use_scaled_dp_attn_op=True,
            uint8_per_channel=True,
            int8_symmetric_storage=True,
            shared_device_weight_cache=self._shared_dev_weights,
            requires_upcast=_upcast_rmsnorm,
            device=self.device,
            synthetic_device_weights=self.synthetic_on_device,
            mesh=self.mesh,
            tp_kv_head_inputs=frozenset(
                f"pkv{i}" for i in range(2 * self.cfg.layers)) if self.mesh is not None else frozenset(),
        )

    def _session(self, L: int, P: int) -> Session:
        key = (L, P)
        s = self._sessions.get(key)
        if s is None:
            g = build_llama(self.cfg, new_len=L, past=P, seed=self.seed,
                            weight_bank=self._weight_bank, lazy_weights=self.synthetic_on_device)
            weights = dict(self._ext_weights) if self._ext_weights else {}
            # graph-aux tensors (masks, shape consts, rope tables) are
            # generated by the builder; model weights may come from outside
            for name, arr in g.weights.items():
                weights.setdefault(name, arr)
            if self._ext_weights:
                # fail fast on a naming mismatch: chatting with the builder's
                # random placeholder weights produces garbage
                big_missing = [
                    n for n, a in g.weights.items()
                    if n not in self._ext_weights
                    and int(np.prod(np.shape(a) or (1,))) >= (1 << 18)
                ]
                if big_missing:
                    raise ValueError(
                        f"{len(big_missing)} model weights are not covered by "
                        f"the provided weight dict (e.g. {big_missing[:3]}); "
                        f"provided names look like "
                        f"{sorted(self._ext_weights)[:3]} — refusing to run "
                        f"on random builder weights")
            force_u8 = set()
            if self.int8_weights:
                # every 2-D floating MatMul weight, classified on the arrays
                force_u8 = {
                    op.inputs[1].name
                    for op in g.ops
                    if op.op_type == "MatMul"
                    and len(op.inputs) == 2
                    and op.inputs[1].name in weights
                    and np.ndim(weights[op.inputs[1].name]) == 2
                    and np.issubdtype(
                        getattr(weights[op.inputs[1].name], "dtype", np.dtype(np.int64)),
                        np.floating,
                    )
                }
            model = set(self._weight_bank) | set(self._ext_weights or ())
            params = {}
            for name, arr in weights.items():
                if name in model:  # model weights: one host tensor for all graphs
                    if name not in self._host_params:
                        self._host_params[name] = _host_tensor(arr)
                    params[name] = self._host_params[name]
                else:  # this graph's own constants
                    params[name] = _host_tensor(arr)
            cfg = self._session_config()
            cfg.force_uint8_storage_set = force_u8
            s = Session(config=cfg, weights_provider=DictWeightsProvider(params))
            s.graph_pool = self._graph_pool
            s.read_string(g.to_text())
            self._sessions[key] = s
        return s

    def reset(self) -> None:
        self.kv = None
        self.cache_len = 0

    def _kv_input(self, arr: torch.Tensor):
        """A cache tensor as a graph input: under a mesh this rank's shard
        with the cache's whole shape."""
        if self.mesh is None:
            return arr
        return LocalShard(arr, (1, self.cfg.kv_heads, arr.shape[2], self.cfg.head_dim))

    def _pad_kv(self, P: int) -> int:
        """Pad the device KV cache up to bucket P (on the device); returns
        the bucket in use (a larger existing one is kept)."""
        curP = self.kv[0].shape[2]
        if curP < P:
            self.kv = [F.pad(a, (0, 0, 0, P - curP)) for a in self.kv]
            return P
        return curP

    def quantize_seconds(self) -> float:
        """Host seconds spent quantizing weights at first fetch (int8_weights)."""
        return sum(ex.quantize_seconds for s in self._sessions.values() for ex in s._executors.values())

    def device_weight_bytes(self) -> int:
        """Bytes of the distinct device weight tensors over all sessions."""
        seen = {}
        for s in self._sessions.values():
            for ex in s._executors.values():
                for t in ex.device_weights():
                    seen[t.data_ptr()] = t.numel() * t.element_size()
        return sum(seen.values())

    # --------------------------------------------------------------- forward
    def forward(self, token_ids: List[int], position0: Optional[int] = None, want_logits: bool = True):
        """Run L new tokens against the cache. Returns (next_token_id, logits
        of the last valid position or None). KV stays on the device: only the
        argmax id (and optionally logits) come back to the host."""
        L = len(token_ids)
        pos0 = self.cache_len if position0 is None else position0
        # an id outside the vocab would index out of range on the device,
        # which faults the CUDA context instead of raising here
        bad = [t for t in token_ids if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids {bad[:4]} outside the vocab [0, {self.cfg.vocab_size})")

        if self.cache_len == 0 and self.kv is None:
            # prefill: (Lb, past=0) graph; the padded tail rows are masked by
            # cache_len in subsequent decode graphs
            Lb = _next_bucket(L, self.buckets)
            sess = self._session(Lb, 0)
            ids = np.zeros((1, Lb), np.int64)
            ids[0, :L] = token_ids
            pos = np.zeros((1, Lb), np.int64)
            pos[0, :L] = np.arange(pos0, pos0 + L)
            sess.clear_tensors()
            sess.add_tensor("input_5F_ids", ids)
            sess.add_tensor("position_5F_ids", pos)
            sess.add_tensor("last_5F_pos", np.array([L - 1], np.int64))
            out = sess.run(device_outputs=True)
            self.kv = [out[f"opkv{i}"] for i in range(2 * self.cfg.layers)]
            self.cache_len = L
        else:
            # decode/continuation: pad L up to a power-of-2 bucket so every
            # follow-up prompt length reuses a planned graph. ScatterND writes
            # the padded rows too, but cache_len advances by the true L, so
            # the garbage rows stay outside the valid window.
            Lb = 1 if L == 1 else 1 << (L - 1).bit_length()
            P = self._pad_kv(_next_bucket(self.cache_len + Lb, self.buckets))
            sess = self._session(Lb, P)
            ids = np.zeros((1, Lb), np.int64)
            ids[0, :L] = token_ids
            pos = np.full((1, Lb), pos0 + L - 1, np.int64)
            pos[0, :L] = np.arange(pos0, pos0 + L)
            sess.clear_tensors()
            sess.add_tensor("input_5F_ids", ids)
            sess.add_tensor("position_5F_ids", pos)
            sess.add_tensor("cache_5F_len", np.array([self.cache_len], np.int64))
            sess.add_tensor("last_5F_pos", np.array([L - 1], np.int64))
            for i, arr in enumerate(self.kv):
                sess.add_tensor(f"pkv{i}", self._kv_input(arr))
            out = sess.run(device_outputs=True)
            self.kv = [out[f"opkv{i}"] for i in range(2 * self.cfg.layers)]
            self.cache_len += L

        nxt = int(out["next_token"].reshape(-1)[0])
        logits = None
        if want_logits:
            li = out["logits"][0].float().cpu().numpy()
            logits = li[min(L, li.shape[0]) - 1]
        return nxt, logits

    # ----------------------------------------------------- on-device decoding
    def decode_on_device(self, first_token: int, n: int) -> List[int]:
        """Decode n greedy tokens with no host round trip per token: a loop
        over the (L=1, P) executor whose inputs are device tensors only (the
        previous step's in-graph next_token and a device position counter),
        so the host enqueues ahead of the card. The port's replacement for
        the JAX package's lax.scan and for the reference's run-per-token loop
        (src/llm.cpp:458-497); only the final (n,) ids cross to the host."""
        assert self.kv is not None and self.cache_len > 0, "prefill first"
        P = self._pad_kv(_next_bucket(self.cache_len + n, self.buckets))
        sess = self._session(1, P)
        dev = self.device
        # int64 like the host path's numpy inputs: both share one executor
        tok = torch.tensor([[first_token]], dtype=torch.int64).to(dev)
        cl = torch.tensor([self.cache_len], dtype=torch.int64).to(dev)
        last = torch.zeros(1, dtype=torch.int64, device=dev)
        kv = self.kv
        toks = []
        for _ in range(n):
            sess.clear_tensors()
            sess.add_tensor("input_5F_ids", tok)
            sess.add_tensor("position_5F_ids", cl.reshape(1, 1))
            sess.add_tensor("cache_5F_len", cl)
            sess.add_tensor("last_5F_pos", last)
            for i, arr in enumerate(kv):
                sess.add_tensor(f"pkv{i}", self._kv_input(arr))
            out = sess.run(device_outputs=True)
            kv = [out[f"opkv{i}"] for i in range(2 * self.cfg.layers)]
            tok = out["next_token"].reshape(1, 1).to(torch.int64)
            toks.append(tok)
            cl = cl + 1
        self.kv = kv
        self.cache_len += n
        return torch.cat(toks).reshape(-1).tolist()

    # fixed chunk length, as the JAX package's scan length
    DECODE_CHUNK = 32

    def generate_on_device(
        self,
        prompt_ids: List[int],
        max_new_tokens: int = 32,
        stop_ids: Optional[List[int]] = None,
    ) -> List[int]:
        """Prefill + fixed-size on-device decode chunks; stop tokens truncate
        host-side. The device KV cache stays exactly consistent with the
        returned tokens: each decode step feeds the carried token (writing its
        KV) and yields the next, so every returned token's KV is written; on
        truncation cache_len rewinds so over-decoded rows fall outside the
        valid window (they are masked by cache_len in every decode graph)."""
        stop = set(stop_ids or [])
        first, _ = self.forward(prompt_ids, want_logits=False)
        if first in stop or max_new_tokens <= 0:
            return []
        cl0 = self.cache_len  # rows written so far; `first` itself is unfed

        # candidates (in fed order): `first`, then per chunk the previous
        # carry (fed first by this chunk, writing its KV) followed by the
        # chunk's yields except its own carry. Only the final carry stays out
        # of cand — it is the one token whose KV row was never written.
        cand: List[int] = [first]
        cur = first
        chunks = 0
        while len(cand) < max_new_tokens:
            n = min(self.DECODE_CHUNK,
                    self.buckets[-1] - self.cache_len,
                    self.cfg.max_pos - self.cache_len - 1)
            if n <= 0:
                break
            ys = self.decode_on_device(cur, n)
            chunks += 1
            if chunks > 1:
                # the previous carry was just fed; it precedes this chunk's
                # yields in the true sequence (it cannot be a stop token —
                # a stop carry breaks the loop below before being re-fed)
                cand.append(cur)
            new = ys[:-1]
            cur = ys[-1]
            cand.extend(new)
            # stop on a yielded stop token and on a stop carry: feeding a
            # stop carry into another chunk would append post-EOS tokens that
            # the host generate() loop never produces
            if cur in stop or any(t in stop for t in new):
                break

        out: List[int] = []
        for t in cand:
            if t in stop:
                break
            out.append(t)
        out = out[:max_new_tokens]

        if chunks == 0:
            # `first` was never fed; one host step writes its KV row
            # (the host loop does the same final forward, llm.cpp:482-495)
            self.forward([first], want_logits=False)
        else:
            # rewind to the kept tokens; decode graphs mask rows >= cache_len
            # so over-decoded rows become invisible
            self.cache_len = cl0 + len(out)
        return out

    # -------------------------------------------------------------- generate
    def generate(
        self,
        prompt_ids: List[int],
        max_new_tokens: int = 32,
        stop_ids: Optional[List[int]] = None,
        stream: Optional[Callable[[int], None]] = None,
    ) -> List[int]:
        stop = set(stop_ids or [])
        nxt, _ = self.forward(prompt_ids, want_logits=False)
        out: List[int] = []
        for _ in range(max_new_tokens):
            if nxt in stop:
                break
            out.append(nxt)
            if stream:
                stream(nxt)
            nxt, _ = self.forward([nxt], want_logits=False)
        return out

    def chat_turn(self, prompt: str, max_new_tokens: int = 128, stream=None) -> str:
        assert self.tokenizer is not None, "no tokenizer loaded"
        text = chat_template(prompt, self.is_tiny_chat, continuing=self.cache_len > 0)
        ids = self.tokenizer.encode(text)
        stop_name = "<|im_end|>" if self.is_tiny_chat else "</s>"
        stop_id = self.tokenizer.token2idx.get(stop_name)
        stop_ids = [stop_id] if stop_id is not None else []
        if stream is None:
            # no streaming requested: decode the whole turn on the device, as
            # the JAX package does; each step replays the decode graph
            toks = self.generate_on_device(ids, max_new_tokens, stop_ids=stop_ids)
        else:
            toks = self.generate(ids, max_new_tokens, stop_ids=stop_ids, stream=stream)
        if hasattr(self.tokenizer, "decode_token_bytes"):
            # join at the byte level: a multi-byte char's <0xNN> fallback
            # tokens are partial utf-8 sequences that only assemble correctly
            # as bytes (reference llm.cpp joins std::string pieces)
            bpieces = []
            for i, t in enumerate(toks):
                # a model vocab larger than the tokenizer's (synthetic smoke
                # runs) can emit unmapped ids; the reference throws
                # (llm.cpp:485)
                b = (self.tokenizer.decode_token_bytes(t)
                     if t < len(self.tokenizer.idx2token) else b"")
                if i == 0 and b.startswith(b" "):
                    b = b[1:]
                bpieces.append(b)
            return b"".join(bpieces).decode("utf-8", errors="replace")
        pieces = []
        for i, t in enumerate(toks):
            s = self.tokenizer.decode_token(t) if t < len(self.tokenizer.idx2token) else ""
            if i == 0 and s.startswith(" "):
                s = s[1:]
            pieces.append(s)
        return "".join(pieces)

"""The TinyLlama chat slice: the port's LLM modules against the JAX package.

On LLAMA_TINY with the same seeded weights and buckets [8, 16, 32], both
pipelines run on the CPU: greedy tokens must be equal; prefill and decode
logits agree within 1e-4 * max|logits| in float32 and 5e-2 * max|logits| in
bfloat16 (the two frameworks round bf16 at different points). The builder,
tokenizer and HF converter copies must give the JAX package's output exactly.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from onnxstream_tpu.cli.llm_main import main as jax_cli
from onnxstream_tpu.models.llm import llama as jax_llama
from onnxstream_tpu.models.llm.hf import config_from_hf as jax_config_from_hf
from onnxstream_tpu.models.llm.hf import weights_from_hf_state_dict as jax_from_hf
from onnxstream_tpu.models.llm.pipeline import LlamaPipeline as JaxPipeline
from onnxstream_tpu.models.llm.tokenizer import SentencePieceBPE as JaxBPE
from onnxstream_tpu.models.llm.tokenizer import chat_template as jax_chat_template
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.cli.llm_main import main as port_cli
from onnxstream_tpu_torch.models.llm import llama
from onnxstream_tpu_torch.models.llm.hf import config_from_hf, weights_from_hf_state_dict
from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY, TINYLLAMA, build_llama
from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
from onnxstream_tpu_torch.models.llm.tokenizer import SentencePieceBPE, chat_template
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
BUCKETS = [8, 16, 32]
PROMPT = [3, 17, 99, 5]
SEQ = [1, 5, 7, 9, 2, 3]


def _port(dtype="float32", **kw):
    return LlamaPipeline(LLAMA_TINY, compute_dtype=dtype, buckets=list(BUCKETS), device=CPU, **kw)


def _logit_trace(pipe):
    """Logits of a prefill (6 tokens, bucket 8), two decode steps (the second
    crosses into bucket 16 with a continuation of 3 tokens, padded to 4)."""
    pipe.reset()
    out = [pipe.forward(SEQ)[1]]
    out.append(pipe.forward([4])[1])
    out.append(pipe.forward([8, 2, 7])[1])
    out.append(pipe.forward([11])[1])
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """Everything the port is compared with, from the JAX pipeline (one per
    dtype, so each bucket graph compiles once)."""
    ref = {}
    j = JaxPipeline(jax_llama.LLAMA_TINY, buckets=list(BUCKETS))
    ref["tokens"] = j.generate(PROMPT, max_new_tokens=8)
    ref["logits_float32"] = _logit_trace(j)
    j.reset()
    ref["turn1"] = j.generate([3, 17], max_new_tokens=4)
    ref["turn2"] = j.generate([5, 9], max_new_tokens=4)
    ref["multiturn_cache_len"] = j.cache_len
    j.reset()
    ref["stopped"] = j.generate(PROMPT, max_new_tokens=8, stop_ids=[ref["tokens"][2]])
    jb = JaxPipeline(jax_llama.LLAMA_TINY, compute_dtype="bfloat16", buckets=list(BUCKETS))
    ref["logits_bfloat16"] = _logit_trace(jb)
    return ref


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("name", ["TINYLLAMA", "MISTRAL", "LLAMA_TINY"])
def test_configs_and_param_counts_match_jax(name):
    cfg, jcfg = getattr(llama, name), getattr(jax_llama, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert llama.param_count(cfg) == jax_llama.param_count(jcfg)


@pytest.mark.parametrize("L,P", [(8, 0), (1, 16), (4, 16)])
def test_build_llama_matches_jax_builder(L, P):
    g = build_llama(LLAMA_TINY, new_len=L, past=P, seed=2)
    jg = jax_llama.build_llama(jax_llama.LLAMA_TINY, new_len=L, past=P, seed=2)
    assert g.to_text() == jg.to_text()
    assert list(g.weights) == list(jg.weights)
    for name, arr in jg.weights.items():
        assert g.weights[name].dtype == arr.dtype
        np.testing.assert_array_equal(g.weights[name], arr)


def test_tokenizer_matches_jax():
    tokens = [(0, "<unk>")] + [(0, bytes([b])) for b in range(256)] + [(-1, "hi"), (-2, "he"), (-3, "hel")]
    special = ["<s>", "</s>", "[PAD]", "<|im_start|>", "<|im_end|>"]
    tok, jtok = SentencePieceBPE(tokens, special), JaxBPE(tokens, special)
    for text in ["hello hi", "<s>héllo ☃</s>", chat_template("hi there", True, True)]:
        assert tok.encode(text) == jtok.encode(text)
    for args in [("hi", True, False), ("hi", True, True), ("hi", False, False), ("hi", False, True)]:
        assert chat_template(*args) == jax_chat_template(*args)


def test_hf_converter_matches_jax():
    cfg = LLAMA_TINY
    rng = np.random.default_rng(0)
    d, hd = cfg.dim, cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, d), "model.norm.weight": (d,)}
    for i in range(cfg.layers):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (cfg.heads * hd, d),
                       p + "self_attn.k_proj.weight": (cfg.kv_heads * hd, d),
                       p + "self_attn.v_proj.weight": (cfg.kv_heads * hd, d),
                       p + "self_attn.o_proj.weight": (d, cfg.heads * hd),
                       p + "mlp.gate_proj.weight": (cfg.intermediate, d),
                       p + "mlp.up_proj.weight": (cfg.intermediate, d),
                       p + "mlp.down_proj.weight": (d, cfg.intermediate),
                       p + "input_layernorm.weight": (d,), p + "post_attention_layernorm.weight": (d,)})
    sd = {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for k, s in shapes.items()}
    got, want = weights_from_hf_state_dict(sd, cfg), jax_from_hf(sd, jax_llama.LLAMA_TINY)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    hf = types.SimpleNamespace(vocab_size=100, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                               num_key_value_heads=2, intermediate_size=128, max_position_embeddings=256,
                               rope_theta=500000.0, rms_norm_eps=1e-6)
    assert dataclasses.asdict(config_from_hf(hf)) == dataclasses.asdict(jax_config_from_hf(hf))


@pytest.mark.parametrize("L,P", [(16, 0), (1, 64)])
def test_tinyllama_attention_all_fuse(L, P):
    """use_scaled_dp_attn_op turns all 22 TinyLlama attentions into
    ostpu.sdpa: head-major (no heads attr, since masked attention is not
    packed), the K transpose peeled (k_transposed 0), the (1, 1, L, T) mask as
    the 4th input, and the GQA expand left in the graph (32 heads reach the
    kernel). The big weights stay lazy: fusion reads only scalars."""
    g = build_llama(TINYLLAMA, new_len=L, past=P, lazy_weights=True)
    small = {n: a for n, a in g.weights.items() if isinstance(a, np.ndarray)}
    s = Session(LlamaPipeline(TINYLLAMA, device=CPU)._session_config(),
                weights_provider=DictWeightsProvider(params_from_numpy(small)))
    s.read_string(g.to_text())
    sdpa = [op for op in s.graph.ops if op.op_type == "ostpu.sdpa"]
    assert len(sdpa) == TINYLLAMA.layers == 22
    assert not any(op.op_type == "Softmax" for op in s.graph.ops)
    T = P or L
    for op in sdpa:
        assert op.attr_int("k_transposed", -1) == 0 and op.attr_int("heads", 0) == 0
        assert len(op.inputs) == 4 and op.inputs[3].shape == (1, 1, L, T)
        assert op.inputs[1].shape == (1, TINYLLAMA.heads, T, TINYLLAMA.head_dim)


# ----------------------------------------------------------------- pipeline
def test_greedy_tokens_match_jax(jax_ref):
    """8 new tokens from a 4-token prompt: the cache crosses from bucket 8
    into bucket 16 on the way (JAX tests/test_llm.py:64-85)."""
    p = _port()
    assert p.generate(PROMPT, max_new_tokens=8) == jax_ref["tokens"]
    assert p.cache_len == len(PROMPT) + 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(jax_ref, dtype):
    got, want = _logit_trace(_port(dtype)), jax_ref[f"logits_{dtype}"]
    bound = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (LLAMA_TINY.vocab_size,)
        err = float(np.abs(g - w).max())
        assert err <= bound * float(np.abs(w).max()), (dtype, err, float(np.abs(w).max()))


def test_generate_on_device_equals_generate(jax_ref):
    p = _port()
    assert p.generate_on_device(PROMPT, max_new_tokens=8) == jax_ref["tokens"]
    # the decode chunk runs on past the request; cache_len rewinds to the kept tokens
    assert p.cache_len == len(PROMPT) + 8


def test_generate_on_device_stop_token_matches_jax(jax_ref):
    stop = jax_ref["tokens"][2]
    assert _port().generate_on_device(PROMPT, max_new_tokens=8, stop_ids=[stop]) == jax_ref["stopped"]
    assert _port().generate(PROMPT, max_new_tokens=8, stop_ids=[stop]) == jax_ref["stopped"]


def test_multiturn_on_device_matches_jax_host_loop(jax_ref):
    """After an on-device turn the KV cache holds exactly the returned
    tokens, so turn 2 matches the host loop (JAX tests/test_llm.py:154-171)."""
    p = _port()
    assert p.generate_on_device([3, 17], max_new_tokens=4) == jax_ref["turn1"]
    assert p.generate_on_device([5, 9], max_new_tokens=4) == jax_ref["turn2"]
    assert p.cache_len == jax_ref["multiturn_cache_len"]


def test_one_executor_per_bucket():
    """Decode inputs fed back as device tensors (int64 ids from the in-graph
    argmax, the device position counter) hit the executor that the host
    loop's numpy inputs planned: cache_len is never pinned."""
    p = _port()
    p.forward(PROMPT)
    p.decode_on_device(7, 8)
    p.forward([9])
    p.decode_on_device(3, 2)
    assert sorted(p._sessions) == [(1, 16), (8, 0)]
    for key, s in p._sessions.items():
        assert len(s._executors) == 1, key
        ex = next(iter(s._executors.values()))
        assert not ex.plan.pinned_inputs
    assert p.cache_len == len(PROMPT) + 8 + 1 + 2


def test_device_weights_uploaded_once_across_sessions():
    """The prefill and decode sessions share one device copy of every weight
    of at least executor.SHARED_CACHE_MIN_BYTES (1 MiB): here the embedding and the LM
    head, at vocab 4096 x dim 64 in float32."""
    cfg = dataclasses.replace(LLAMA_TINY, vocab_size=4096)
    p = LlamaPipeline(cfg, buckets=list(BUCKETS), device=CPU)
    p.forward(PROMPT)
    p.decode_on_device(7, 8)
    assert len(p._sessions) == 2
    assert sorted(k[0] for k in p._shared_dev_weights) == ["lm_head.weight.bin",
                                                            "model.embed_tokens.weight.bin"]
    per_session = [next(iter(s._executors.values())).device_weights() for s in p._sessions.values()]
    ptrs = [{t.data_ptr() for t in ws if t.numel() * t.element_size() >= 1 << 20} for ws in per_session]
    assert len(ptrs[0]) == 2 and ptrs[0] == ptrs[1]
    big = 2 * 4096 * 64 * 4
    counted_per_session = sum(sum(t.numel() * t.element_size() for t in ws) for ws in per_session)
    # (on the CPU a float32 upload may alias the host tensor, which the
    # per-pointer count also merges)
    assert big <= p.device_weight_bytes() <= counted_per_session - big


@pytest.mark.parametrize("option", ["int8_weights", "synthetic_on_device", "mesh", "device"])
def test_unported_options_raise(option):
    if option == "device":
        # None means the first CUDA card; without one it names the missing card
        if torch.cuda.is_available():
            assert LlamaPipeline(LLAMA_TINY).device == torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                LlamaPipeline(LLAMA_TINY)
        return
    if option in ("int8_weights", "synthetic_on_device"):
        # ported: the int8 route runs (test_int8_pipeline_matches_jax holds it
        # against JAX), and so do weights synthesized on the device
        # (tests/test_torch_synthetic.py)
        p = LlamaPipeline(LLAMA_TINY, buckets=list(BUCKETS), device=CPU, **{option: True})
        assert 0 <= p.forward(PROMPT)[0] < LLAMA_TINY.vocab_size
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaPipeline(LLAMA_TINY, device=CPU, **{option: object() if option == "mesh" else True})


def test_out_of_vocab_ids_raise_before_reaching_the_device():
    p = _port()
    with pytest.raises(ValueError, match="outside the vocab"):
        p.forward([3, LLAMA_TINY.vocab_size])
    assert p.kv is None and p.cache_len == 0


def test_device_outputs_stay_tensors_in_the_compute_dtype():
    p = _port("bfloat16")
    s = p._session(8, 0)
    s.add_tensor("input_5F_ids", np.arange(8, dtype=np.int64)[None])
    s.add_tensor("position_5F_ids", np.arange(8, dtype=np.int64)[None])
    s.add_tensor("last_5F_pos", np.array([7], np.int64))
    dev = s.run(device_outputs=True)
    host = s.run()
    assert dev["logits"].dtype == torch.bfloat16 and dev["next_token"].dtype == torch.int32
    assert host["logits"].dtype == np.float32 and host["next_token"].dtype == np.int64
    np.testing.assert_array_equal(dev["logits"].float().numpy(), host["logits"])
    assert len(s._executors) == 1


def test_requires_upcast_matches_jax():
    """An op named for upcasting runs in float32 and casts back, in both
    packages (here a bf16 RMSNorm-style Pow + ReduceMean chain)."""
    from onnxstream_tpu_torch.convert.builder import GraphBuilder

    g = GraphBuilder()
    x_in = g.input("x", (2, 8))
    sq = g.binary("Pow", x_in, g.scalar(2.0, name="two"), name="n.input_layernorm/pow")
    g.emit("ReduceMean", [sq], [(2, 1)], {"axes": "-1", "keepdims": 1}, name="n.input_layernorm/mean",
           out_names=["m"])
    text, two = g.to_text(), g.weights
    x = np.random.default_rng(0).standard_normal((2, 8), dtype=np.float32) * 3
    upcast = lambda t, n: "input_layernorm" in n  # noqa: E731
    js = JaxSession(JaxConfig(compute_dtype="bfloat16", requires_upcast=upcast), weights_provider=JaxDict(two))
    ps = Session(SessionConfig(compute_dtype="bfloat16", requires_upcast=upcast, device=CPU),
                 weights_provider=DictWeightsProvider(params_from_numpy(two)))
    for s in (js, ps):
        s.read_string(text)
        s.add_tensor("x", x)
    np.testing.assert_allclose(ps.run()["m"], js.run()["m"], rtol=1e-2, atol=1e-2)


def test_cli_synthetic_tiny_prints_what_the_jax_cli_prints(capsys):
    argv = ["--synthetic", "tiny", "--prompt", "hello", "--max-new-tokens", "6"]
    assert jax_cli(argv + ["--device", "cpu"]) == 0
    want = capsys.readouterr().out
    assert port_cli(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "done!" in got and got == want


def test_requires_upcast_is_asked_once_per_op_not_per_run():
    calls = []

    def upcast(op_type, op_name):
        calls.append(op_name)
        return "input_layernorm" in op_name

    p = LlamaPipeline(LLAMA_TINY, buckets=[8, 16, 32], device=CPU)
    p._session_config = lambda: SessionConfig(requires_upcast=upcast, device=CPU)
    s = p._session(8, 0)
    for _ in range(3):
        s.add_tensor("input_5F_ids", np.arange(8, dtype=np.int64)[None])
        s.add_tensor("position_5F_ids", np.arange(8, dtype=np.int64)[None])
        s.add_tensor("last_5F_pos", np.array([7], np.int64))
        s.run()
    assert len(s._executors) == 1
    assert len(calls) == len(s.graph.ops) and any("input_layernorm" in n for n in calls)


@pytest.mark.parametrize("source", [["--model", "tinyllama"], ["--model", "mistral"]])
def test_cli_refuses_download_whatever_the_source(source, tmp_path, monkeypatch, capsys):
    """--download is no longer refused: with --models-path the CLI fetches
    the model's catalog entry first, as the JAX CLI does. The catalog entry
    points at a file:// folder holding LLAMA_TINY in the reference's layout
    (vocab.txt, model.txt, one .bin a weight), and the full-size config is
    swapped for LLAMA_TINY; the chat from the fetched folder prints what a
    chat from the source folder prints."""
    from onnxstream_tpu_torch.models.llm import llama as port_llama
    from onnxstream_tpu_torch.utils.download import MODEL_CATALOG

    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    # the model's parameters, one .bin each, declared in model.txt (the builder's shape
    # constants depend on the bucket and stay out, as the pipeline builds them itself)
    b = port_llama.build_llama(port_llama.LLAMA_TINY, 8, 0)
    params = {n: np.asarray(a) for n, a in b.weights.items() if n.startswith(("model.", "lm_head"))}
    lines = []
    for i, (n, a) in enumerate(params.items()):
        a.tofile(str(src / n))
        dims = ",".join(map(str, a.shape))
        lines.append(f"p{i}:Identity*input:{n}(float32:{dims})*output:o{i}({dims})")
    (src / "model.txt").write_text("\n".join(lines) + "\n")
    (src / "vocab.txt").write_text("".join(f"0,<0x{i:02X}>\n" for i in range(256)))
    name = "TinyLlama-1.1B-Chat-v0.3-fp16" if source[1] == "tinyllama" else "Mistral-7B-Instruct-v0.2-fp16"
    monkeypatch.setitem(MODEL_CATALOG, name, {**MODEL_CATALOG[name], "url": f"file://{src}/"})
    monkeypatch.setattr(port_llama, "TINYLLAMA", port_llama.LLAMA_TINY)
    monkeypatch.setattr(port_llama, "MISTRAL", port_llama.LLAMA_TINY)
    argv = source + ["--device", "cpu", "--compute-dtype", "float32", "--prompt", "hi", "--max-new-tokens", "4"]
    assert port_cli(argv + ["--models-path", str(src)]) == 0
    want = capsys.readouterr().out
    assert port_cli(argv + ["--models-path", str(dst), "--download"]) == 0
    got = capsys.readouterr().out
    assert "done!" in want and got.replace("Downloading weights", "") .count("done!") >= 1
    assert got.splitlines()[-2:] == want.splitlines()[-2:]
    fetched = {p.name for p in dst.iterdir()}
    assert fetched == {p.name for p in src.iterdir()} and len(fetched) == len(params) + 2 > 20


@pytest.fixture(scope="module")
def jax_int8_ref():
    j = JaxPipeline(jax_llama.LLAMA_TINY, buckets=list(BUCKETS), int8_weights=True)
    ref = {"logits": _logit_trace(j)}
    j.reset()
    ref["tokens"] = j.generate(PROMPT, max_new_tokens=8)
    return ref


def test_int8_pipeline_matches_jax(jax_int8_ref):
    """int8_weights, float32: every 2-D MatMul weight stored as symmetric
    per-channel s8 and run through w8a8_dyn_matmul in prefill and decode (the
    JAX executor: w8a8_dyn_matmul_xla). Logits within 1e-3 * max, greedy
    tokens equal."""
    p = _port(int8_weights=True)
    for g, w in zip(_logit_trace(p), jax_int8_ref["logits"]):
        assert float(np.abs(g - w).max()) <= 1e-3 * float(np.abs(w).max())
    p.reset()
    assert p.generate(PROMPT, max_new_tokens=8) == jax_int8_ref["tokens"]
    assert p.quantize_seconds() > 0
    routes = 7 * LLAMA_TINY.layers + 1
    for key, s in p._sessions.items():
        ex = next(iter(s._executors.values()))
        assert len(ex.quant_routes) == routes and set(ex.quant_routes.values()) == {"w8a8_dyn_matmul"}, key


def test_int8_pipeline_uploads_its_matmul_weights_kmajor():
    """Every weight that kernel 6 reads is uploaded K-major ('tnk', (N, K)),
    quantized per output channel first: the device copy is the transposed
    file-layout quantization, in every bucket session; the float weights
    (norms, the embedding) keep their layout."""
    from onnxstream_tpu_torch.runtime.quantization import quantize_weight_symmetric_per_channel

    p = _port(int8_weights=True)
    p.forward(PROMPT)
    p.decode_on_device(7, 2)
    for key, s in p._sessions.items():
        ex = next(iter(s._executors.values()))
        args = {w.name: w for w in ex.plan.arg_weights}
        tagged = {n for n, w in args.items() if w.transform == "tnk"}
        assert tagged == {n for n, w in args.items() if w.symmetric}, key
        assert len(tagged) == 7 * LLAMA_TINY.layers + 1 and "lm_head.weight.bin" in tagged
        for n in tagged:
            dev = (ex._resident.get(n) or p._shared_dev_weights.get((n, args[n].shape, "torch.int8", "tnk")))[0]
            q, _ = quantize_weight_symmetric_per_channel(np.asarray(p._weight_bank[n], np.float32))
            assert np.array_equal(dev.numpy(), q.T), n


def test_int8_bucket_sessions_share_weights_with_their_scales():
    """The bucket sessions share one upload of every weight of at least 1 MiB
    (here the embedding and the 64 x 16384 int8 LM head); a session that
    finds a weight in the shared cache takes its (N,) scales too, never the
    planner's placeholder (its MatMul would read as zeros). Smaller weights
    are quantized per executor, to the same scales."""
    cfg = dataclasses.replace(LLAMA_TINY, vocab_size=16384)
    p = LlamaPipeline(cfg, buckets=list(BUCKETS), device=CPU, int8_weights=True)
    p.forward(PROMPT)
    p.decode_on_device(7, 4)
    assert len(p._sessions) == 2
    assert sorted(k[0] for k in p._shared_dev_weights) == ["lm_head.weight.bin", "model.embed_tokens.weight.bin"]
    args = [{w.name: w for w in next(iter(s._executors.values())).plan.arg_weights} for s in p._sessions.values()]
    forced = [n for n, w in args[0].items() if w.symmetric]
    assert len(forced) == 7 * cfg.layers + 1 and "lm_head.weight.bin" in forced
    for n in forced:
        w0, w1 = args[0][n], args[1][n]
        # uploaded K-major for kernel 6 (tnk): the device shape is (N, K), the scales (N,)
        assert w0.transform == w1.transform == "tnk" and w1.shape == w1.file_shape[::-1]
        assert isinstance(w1.quant[0], torch.Tensor) and tuple(w1.quant[0].shape) == (w1.shape[0],)
        assert w1.quant[1] == 0.0 and torch.equal(w0.quant[0], w1.quant[0])
    assert args[1]["lm_head.weight.bin"].quant[0] is args[0]["lm_head.weight.bin"].quant[0]

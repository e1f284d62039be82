"""Weights synthesized on the device (``SessionConfig.synthetic_device_weights``).

A big weight is generated where it runs instead of being fetched: the host
never materializes a builder's ``LazyArray`` placeholder for it (each big
placeholder here raises if asked), small weights stay real, the same graph
gives the same weights on every fetch and in every session, streamed or
resident, each weight from its own stream, and the port's choice of what to synthesize is the JAX
executor's ``_synth_kind`` on the same planned weights.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.convert.builder import LazyArray
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet
from onnxstream_tpu_torch.runtime.executor import SYNTH_SCALE, synth_kind
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
# the TINY UNet's weights are all under the default gate (1 << 18 elements):
# these tests synthesize every weight of at least this many elements
MIN_ELEMENTS = 4096


def _inputs(batch=1):
    rng = np.random.default_rng(0)
    return {"sample": rng.standard_normal((batch, 4, 16, 16), dtype=np.float32),
            "timestep": np.array([500.0], np.float32),
            "encoder_hidden_states": rng.standard_normal((batch, 7, 32), dtype=np.float32)}


def _refuse_big(g, min_elements=MIN_ELEMENTS):
    """Make each big LazyArray of a builder raise when it is materialized;
    returns their names."""
    big = []
    for name, arr in g.weights.items():
        if isinstance(arr, LazyArray) and arr.size >= min_elements:
            def refuse(name=name):
                raise AssertionError(f"{name} was materialized on the host")
            arr._make = refuse
            big.append(name)
    return big


def _session(g, **cfg):
    cfg = {"synthetic_device_weights": True, "synthetic_min_elements": MIN_ELEMENTS, **cfg}
    s = Session(SessionConfig(device=CPU, **cfg), weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    s.read_string(g.to_text())
    return s


def _run(s, inputs):
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s.run()["out_sample"]


@pytest.fixture(scope="module")
def lazy_unet():
    g = build_unet(TINY, seed=1, lazy_weights=True)
    big = _refuse_big(g)
    return g, big


def test_big_lazy_weights_are_never_materialized(lazy_unet):
    g, big = lazy_unet
    assert len(big) > 20
    s = _session(g)
    out = _run(s, _inputs())
    assert out.shape == (1, 4, 16, 16) and np.isfinite(out).all()
    # an eager run (calibration, ops_printf) synthesizes too
    ex = s._executor()
    eager = ex.run_eager(_inputs())["out_sample"]
    np.testing.assert_allclose(eager, out, rtol=1e-5, atol=1e-5)
    assert all(g.weights[n]._arr is None for n in big)
    # the small weights are the real ones, and the big ones synthesized
    real = 0
    for w in ex.plan.arg_weights:
        dev = ex._resident[w.name][0]
        if w.name in big:
            assert synth_kind(w, s.config) == "normal"
        else:
            assert synth_kind(w, s.config) is None
            host = g.weights[w.name]
            host = host.materialize() if isinstance(host, LazyArray) else host
            np.testing.assert_array_equal(dev.numpy(), np.asarray(host).reshape(dev.shape))
            real += 1
    assert real > 20


def test_synthesis_is_seeded_and_streams_the_same_weights(lazy_unet):
    g, _ = lazy_unet
    first = _session(g)
    a = _run(first, _inputs())
    b = _run(_session(g), _inputs())
    np.testing.assert_array_equal(a, b)
    # generated again at each fetch under a budget: the same values
    streamed = _session(g, hbm_budget_bytes=200_000)
    c = _run(streamed, _inputs())
    ex = streamed._executor()
    assert len(ex.segments) > 1 and not ex._resident
    np.testing.assert_array_equal(c, a)
    np.testing.assert_array_equal(_run(streamed, _inputs()), a)
    # each weight its own stream: no two synthesized weights of one shape are equal
    ex = first._executor()
    by_shape = {}
    for name in lazy_unet[1]:
        by_shape.setdefault(tuple(ex._resident[name][0].shape), []).append(ex._resident[name][0])
    pairs = [(x, y) for ts in by_shape.values() for i, x in enumerate(ts) for y in ts[i + 1:]]
    assert pairs and all(not torch.equal(x, y) for x, y in pairs)
    # a batch-2 graph of the same builder gets the same weights: each row is the batch-1 run
    g2 = build_unet(TINY, batch=2, seed=1, lazy_weights=True)
    _refuse_big(g2)
    two = _run(_session(g2), _inputs(2))
    for row in range(2):
        one = {k: (v[row:row + 1] if k != "timestep" else v) for k, v in _inputs(2).items()}
        np.testing.assert_allclose(two[row:row + 1], _run(_session(g), one), rtol=1e-4, atol=1e-4)


def test_synthesized_weights_are_cached_like_uploads(lazy_unet, monkeypatch):
    """Resident (no budget): generated once, in the shared cache by the same
    key when the config gives one; a second session reads the cache."""
    import onnxstream_tpu_torch.runtime.executor as executor_mod

    # the TINY weights are under the shared cache's 1 MB floor
    monkeypatch.setattr(executor_mod, "SHARED_CACHE_MIN_BYTES", 16384)
    g, big = lazy_unet
    shared = {}
    s1 = _session(g, shared_device_weight_cache=shared)
    _run(s1, _inputs())
    ex1 = s1._executor()
    cached = {k[0] for k in shared}
    assert cached and cached <= set(big)
    s2 = _session(g, shared_device_weight_cache=shared)
    _run(s2, _inputs())
    ex2 = s2._executor()
    for w in ex2.plan.arg_weights:
        cache, key = ex2._cache_slot(w)
        if cache is shared:
            assert cache[key][0] is ex1._cache_slot(w)[0][key][0]


def test_normal_s8_and_u8_kinds_generate_as_stated():
    """normal: N(0, 0.02) in the upload dtype (std within 10 %); s8: int8 in
    [-127, 127] with a flat per-channel scale over the file layout's last
    axis, K-major relayouts included; u8: uint8 over the whole range."""
    from onnxstream_tpu_torch.dtypes import DType
    from onnxstream_tpu_torch.runtime.executor import Executor
    from onnxstream_tpu_torch.runtime.planner import WeightArg

    cfg = SessionConfig(device=CPU, synthetic_device_weights=True, compute_dtype="bfloat16",
                        force_uint8_storage_set={"w_s8"}, int8_symmetric_storage=True)
    ws = [WeightArg("w_f", DType.float32, torch.bfloat16, (512, 1024)),
          WeightArg("w_s8", DType.float32, torch.int8, (768, 512), quant=(0.0, 0), symmetric=True,
                    transform="tnk", file_shape=(512, 768)),
          WeightArg("w_u8", DType.uint8, torch.uint8, (1024, 512), quant=(0.01, 128))]
    ex = Executor.__new__(Executor)
    ex.config, ex.device = cfg, CPU
    ex._arg_index = {w.name: i for i, w in enumerate(ws)}
    kinds = [synth_kind(w, cfg) for w in ws]
    assert kinds == ["normal", "s8", "u8"]
    f, s8, u8 = (ex._synthesize(w, k) for w, k in zip(ws, kinds))
    assert f.dtype == torch.bfloat16 and f.shape == (512, 1024)
    assert abs(f.float().std().item() - SYNTH_SCALE) < 0.1 * SYNTH_SCALE and abs(f.float().mean().item()) < 1e-3
    assert s8.dtype == torch.int8 and s8.shape == (768, 512)
    assert s8.min().item() >= -127 and s8.max().item() == 127
    scale, zero = ws[1].quant
    assert ws[1].symmetric and zero == 0.0 and tuple(scale.shape) == (768,)
    assert torch.all(scale == SYNTH_SCALE / 127.0)
    assert u8.dtype == torch.uint8 and u8.min().item() == 0 and u8.max().item() == 255
    assert ws[2].quant == (0.01, 128)
    # small weights and integer tables stay real
    assert synth_kind(WeightArg("b", DType.float32, torch.bfloat16, (1024,)), cfg) is None
    assert synth_kind(WeightArg("idx", DType.int64, torch.int64, (1 << 20,)), cfg) is None
    # a transformed weight is made in its upload layout
    conv = WeightArg("w_c", DType.float32, torch.bfloat16, (64, 64, 3, 3), transform="ohwi",
                     file_shape=(64, 64, 3, 3))
    ex._arg_index["w_c"] = 3
    c = ex._synthesize(conv, "normal")
    assert c.shape == (64, 64, 3, 3) and c.is_contiguous(memory_format=torch.channels_last)


def _zeros_for(graph):
    """Zero inputs of every graph input, float32 or int64 by its dtype."""
    return {n: np.zeros(spec.shape, np.float32 if spec.dtype.is_float else np.int64)
            for n, spec in graph.inputs.items()}


def _jax_kinds(text, weights, min_elements, **cfg):
    s = JaxSession(JaxConfig(**cfg), weights_provider=JaxDict(dict(weights)))
    s.read_string(text)
    for k, v in _zeros_for(s.graph).items():
        s.add_tensor(k, v)
    ex = s._executor()
    return {w.name: (ex._synth_kind(w, min_elements=min_elements), w.transform) for w in ex.plan.arg_weights}


def _port_kinds(text, weights, min_elements, **cfg):
    s = Session(SessionConfig(device=CPU, synthetic_min_elements=min_elements, **cfg),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, v in _zeros_for(s.graph).items():
        s.add_tensor(k, v)
    ex = s._executor()
    return {w.name: (synth_kind(w, s.config), w.transform) for w in ex.plan.arg_weights}


def _llama_int8_graph():
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY, build_llama

    g = build_llama(dataclasses.replace(LLAMA_TINY, dim=256, intermediate=1024, vocab_size=1024), new_len=8, past=0)
    force = {op.inputs[1].name for op in g.ops if op.op_type == "MatMul" and len(op.inputs) == 2
             and op.inputs[1].name in g.weights and np.ndim(g.weights[op.inputs[1].name]) == 2}
    return g.to_text(), g.weights, dict(force_uint8_storage_set=force, int8_symmetric_storage=True,
                                        uint8_per_channel=True, use_scaled_dp_attn_op=True)


def _unet_u8_graph():
    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights

    g = build_unet(TINY)
    text, weights = quantize_graph_weights(g.to_text(), g.weights)
    return text, weights, {}


def _unet_float_graph():
    g = build_unet(TINY)
    return g.to_text(), g.weights, dict(compute_dtype="bfloat16")


@pytest.mark.parametrize("make", [_unet_float_graph, _unet_u8_graph, _llama_int8_graph],
                         ids=["unet_bf16", "unet_uint8", "llama_int8"])
def test_kind_decision_matches_jax(make):
    """The same planned weights: every weight the JAX planner leaves in file
    layout gets the JAX executor's kind; a weight the port relayouts for a
    kernel (kernel 6's K-major int8 weights) gets the kind JAX gives it in
    file layout, where JAX would refuse only for want of the relayout."""
    text, weights, cfg = make()
    jax, port = _jax_kinds(text, weights, 4096, **cfg), _port_kinds(text, weights, 4096, **cfg)
    assert sorted(jax) == sorted(port)
    kinds = set()
    for name, (kind, transform) in port.items():
        jkind, jtransform = jax[name]
        assert jtransform is None
        assert kind == jkind, name
        kinds.add(kind)
    assert kinds - {None}, "no weight of the graph is synthesized"
    if make is _llama_int8_graph:
        assert {port[n] for n in port if port[n][0] == "s8"} == {("s8", "tnk")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8_weights"])
@pytest.mark.parametrize("cfg_name", ["LLAMA_TINY", "wide"])
def test_llama_synthetic_on_device_answers(cfg_name, int8, dtype):
    """LlamaPipeline(synthetic_on_device=True) answers a prompt with a token
    in the vocab, prefill and decode. At LLAMA_TINY every weight is under the
    gate and real; the wide config's big weights are synthesized (int8: s8
    on kernel 6's K-major route) and never materialized on the host."""
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    cfg = LLAMA_TINY if cfg_name == "LLAMA_TINY" else dataclasses.replace(LLAMA_TINY, dim=256, intermediate=1024,
                                                                          vocab_size=1024)
    p = LlamaPipeline(cfg, buckets=[8, 16, 32], device=CPU, synthetic_on_device=True, int8_weights=int8,
                      compute_dtype=dtype)
    tok, logits = p.forward([1, 5, 7, 9])
    assert 0 <= tok < cfg.vocab_size and np.isfinite(logits).all()
    tok2, _ = p.forward([tok])
    assert 0 <= tok2 < cfg.vocab_size
    big = [a for a in p._weight_bank.values() if isinstance(a, LazyArray) and a.size >= (1 << 18)]
    assert all(a._arr is None for a in big)
    assert len(big) == (0 if cfg_name == "LLAMA_TINY" else 8)
    routes = {r for s in p._sessions.values() for ex in s._executors.values() for r in ex.quant_routes.values()}
    assert routes == ({"w8a8_dyn_matmul"} if int8 else set())


@pytest.mark.parametrize("int8", [False, True], ids=["bfloat16", "int8_weights"])
def test_small_synthesized_weights_are_the_same_in_every_bucket_graph(int8):
    """A synthesized weight under the shared cache's 1 MiB is made by each
    bucket graph itself: seeded by its name, the prefill (8, 0) and decode
    (1, 8) graphs of one LlamaPipeline make the same one (an s8 weight with
    the same scale), as every rank does under a mesh."""
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
    from onnxstream_tpu_torch.runtime.executor import SHARED_CACHE_MIN_BYTES

    cfg = dataclasses.replace(LLAMA_TINY, vocab_size=503, dim=512, layers=2, heads=8, kv_heads=4, intermediate=1024,
                              max_pos=64)
    p = LlamaPipeline(cfg, buckets=[8, 16, 32], device=CPU, synthetic_on_device=True, int8_weights=int8,
                      compute_dtype="bfloat16")
    tok, _ = p.forward([1, 5, 7, 9])
    p.forward([tok])
    prefill, decode = (next(iter(p._sessions[k]._executors.values())) for k in ((8, 0), (1, 8)))
    small = [w for w in prefill.plan.arg_weights if synth_kind(w, prefill.config) is not None
             and math.prod(w.file_shape or w.shape) * w.upload_dtype.itemsize < SHARED_CACHE_MIN_BYTES]
    assert len(small) >= 2 * cfg.layers
    for w in small:
        a, qa, _ = prefill._resident[w.name]
        b, qb, _ = decode._resident[w.name]
        assert torch.equal(a, b), w.name
        if int8:
            assert torch.equal(qa[0], qb[0]) and qa[1] == qb[1], w.name

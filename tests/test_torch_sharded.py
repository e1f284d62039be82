"""The port's sharded serving paths on spawned gloo groups, on the CPU.

Counterpart of the JAX package's mesh tests (tests/test_models.py
``test_session_mesh_sharded_inference_matches_single``,
``test_sequence_parallel_mesh``, ``test_mesh_synthetic_weights_are_sharded``;
tests/test_session.py's pipeline-stage tests; tests/test_llm_sharded.py).
Two process groups are started once for the module (``parallel.launch
.spawn``, each with a 120 s timeout, so a deadlock fails its tests and not the
suite), and run every case of ``parallel.dryrun.rank_cases``:

  * eight ranks: the TINY UNet (batch 2) under ``make_mesh(8, dp=2, tp=4)``
    and, with a 16-token context that sp shards, ``make_mesh(8, dp=2, tp=2,
    sp=2)``; one-op attention graphs, causal or not, whose rows sp shards,
    under the same mesh; the TINY UNet with weights
    synthesized under ``make_mesh(8, dp=1, tp=8)``; LLAMA_TINY at tp = 4
    (``make_mesh(8, dp=2, tp=4)``: 2 kv heads do not divide, the cache is
    replicated); ``make_mesh``'s default and its errors;
  * two ranks: LLAMA_TINY at ``make_mesh(2, dp=1, tp=2)``, the cache sharded
    on its heads, in float32, bf16, on synthesized weights and with
    ``int8_weights``; the TINY UNet with ``force_uint8_storage_set`` at tp =
    2; the chain rule through a gather and a local slice
    (``dryrun.collective_grad_case``), and with the gather's backward broken;
  * the train step (``sharding.make_train_step``, one AdamW step of the TINY
    UNet) under ``make_mesh(8, dp=2)`` and ``make_mesh(8, dp=2, tp=2,
    sp=2)`` on the eight ranks;
  * the options a mesh once refused (``dryrun.session_case``,
    ``streamed_case``, ``pp_mesh_case``): calibrated W8A8 (kernels 3 and 4
    at tp-local shapes), QDQ with and without ranges, calibration, a 1 MiB
    budget and pipeline stages beside a mesh, on the two-conv net, a W8A8
    MatMul, the TINY VAE decoder, a QDQ graph whose shards' percentiles are
    not the whole tensor's and the TINY UNet (two ranks; the UNet streamed
    and the QDQ graph also under ``make_mesh(8, dp=2, tp=4)``).

While they run, this process makes the references: the port's one-device
runs and the JAX package's sharded runs on the conftest's eight virtual
devices (JAX's ``make_train_step`` on the same meshes). Bars: the JAX
suite's, rtol 2e-4 / atol 1e-5 on the UNet output, 2e-4 on logits, tokens
equal; the train step's loss within rtol 1e-6 of JAX's, each gradient within
5e-4 * max|g| of its tensor, NaN on the same 21 Pow exponents. The pipeline
stages (``pp_devices``, one process) run here over [cpu] * 4.
"""

import dataclasses
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from onnxstream_tpu.models.llm.llama import LLAMA_TINY as JAX_LLAMA_TINY
from onnxstream_tpu_torch.models.llm.llama import LlamaConfig
from onnxstream_tpu.models.llm.pipeline import LlamaPipeline as JaxPipeline
from onnxstream_tpu.models.sd.unet import TINY as JAX_TINY
from onnxstream_tpu.models.sd.unet import build_unet as jax_build_unet
from onnxstream_tpu.parallel.sharding import activation_sharding as jax_activation_sharding
from onnxstream_tpu.parallel.sharding import make_mesh as jax_make_mesh
from onnxstream_tpu.parallel.sharding import make_train_step as jax_make_train_step
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu.models.sd.vae import VAE_TINY as JAX_VAE_TINY
from onnxstream_tpu.models.sd.vae import build_vae_decoder as jax_build_vae_decoder
from onnxstream_tpu.convert.quantize import quantize_graph_weights as jax_quantize_graph_weights
from onnxstream_tpu_torch.parallel.dryrun import (LLM_BUCKETS, LLM_PROMPT, collective_grad_operands, llm_single,
                                                  rank_cases, run_session)
from onnxstream_tpu_torch.runtime.quantization import quantize_weight_percentile
from onnxstream_tpu_torch.parallel.launch import spawn
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy
from test_torch_ops_card import OP_CASES
from test_torch_parallel import SDPA_SP_CASES
from test_torch_qlinear import _two_conv_net
from test_torch_train import POW_EXPONENTS, assert_updated_weights_close

CPU = torch.device("cpu")
GROUP_TIMEOUT_S = 120
SYNTH = dict(synthetic_device_weights=True, synthetic_min_elements=1 << 8)
# weights big enough to be synthesized (>= 2^18 elements) and shared across
# the bucket graphs whole (>= 1 MiB), but not as a tp = 2 slice
SYNTH_LLAMA = LlamaConfig(vocab_size=503, dim=512, layers=2, heads=8, kv_heads=4, intermediate=1024, max_pos=64)


def _inputs(batch, context_len=7):
    rng = np.random.RandomState(0)
    return {"sample": rng.rand(batch, 4, 16, 16).astype(np.float32), "timestep": np.array([500.0], np.float32),
            "encoder_hidden_states": rng.rand(batch, context_len, 32).astype(np.float32)}


def _jax_unet(g, inputs, mesh=None, **config):
    s = JaxSession(config=JaxConfig(mesh=mesh, **config), weights_provider=JaxDict(g.weights))
    s.read_string(g.to_text())
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return np.asarray(s.run()["out_sample"], np.float32)


def _jax_session(text, weights, inputs, mesh=None, eager=False, **config):
    """The JAX package's session of a graph: its outputs as float32 numpy
    and its executor."""
    s = JaxSession(config=JaxConfig(mesh=mesh, **config), weights_provider=JaxDict(dict(weights)))
    s.read_string(text)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return {k: np.asarray(v, np.float32) for k, v in s.run(eager=eager).items()}, s._executor()


def _w8a8_matmul():
    """A MatMul with a uint8 weight of 40 columns (tp = 2 slices them, the
    rank's (20, 48) then K-major for kernel 3) and ranges for it and for its
    input, a graph input."""
    rng = np.random.RandomState(9)
    wf = rng.randn(48, 40).astype(np.float32)
    wq, scale, zero = quantize_weight_percentile(wf)
    x = rng.randn(2, 6, 48).astype(np.float32)
    model = f"mm:MatMul*input:x(2,6,48);w.bin(uint8[{scale},{zero}]:48,40)*output:y(2,6,40)\n"
    return model, {"w.bin": wq}, {"x": x}, {"x": (float(x.min()), float(x.max())), "mm": (-5.0, 5.0)}


def _halves(batch, rows, n):
    """y = x @ w, then y + relu(y): y is read twice, so QDQ quantizes it.
    w's last n / 2 columns are 85 times its first, so each tp shard of y
    (its columns) has percentiles of its own, far from the whole tensor's.
    x's rows are one-hot: y's rows are w's, small integers, exact in both
    packages, and the whole tensor's range is [-255, 255], whose scale (2)
    is exact however a package divides by 255. Big enough (rows x n past
    2^21) that QDQ's sample is strided."""
    rng = np.random.RandomState(4)
    x = np.eye(64, dtype=np.float32)[rng.randint(0, 64, (batch, rows))]
    w = rng.randint(-3, 4, (64, n)).astype(np.float32)
    w[:, n // 2:] *= 85
    model = (f"mm:MatMul*input:x({batch},{rows},64);w.bin(float32:64,{n})*output:y({batch},{rows},{n})\n"
             f"r:Relu*input:y({batch},{rows},{n})*output:yr({batch},{rows},{n})\n"
             f"o:Add*input:y({batch},{rows},{n});yr({batch},{rows},{n})*output:out({batch},{rows},{n})\n")
    return model, {"w.bin": w}, {"x": x}


HALVES = {"small": (1, 64, 32), "strided": (1, 3200, 1000), "strided_dp2tp4": (2, 1600, 1000)}
VAE_IN = {"latent": np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)}
BUDGET = 1 << 20


def _jax_llm(tp, int8_weights=False):
    """The JAX pipeline's prefill, five decode steps and on-device decode."""
    mesh = jax_make_mesh(n_devices=tp, dp=1, tp=tp) if tp > 1 else None
    pipe = JaxPipeline(JAX_LLAMA_TINY, buckets=list(LLM_BUCKETS), mesh=mesh, int8_weights=int8_weights)
    steps = [pipe.forward(list(LLM_PROMPT))]
    for _ in range(5):
        steps.append(pipe.forward([steps[-1][0]]))
    pipe.reset()
    return {"steps": steps, "generated": pipe.generate_on_device(list(LLM_PROMPT), max_new_tokens=6)}


def _jax_train(g, inputs, mesh):
    """One step of JAX's make_train_step (zero target): the loss, and per
    weight the updated value and optax's first and second moments."""
    s = JaxSession(config=JaxConfig(compute_dtype="float32"), weights_provider=JaxDict(g.weights))
    s.read_string(g.to_text())
    for k, v in inputs.items():
        s.add_tensor(k, v)
    ex = s._executor()
    step, init, _ = jax_make_train_step(ex, "out_sample", mesh)
    shape = (inputs["sample"].shape[0], 4, 16, 16)
    import jax

    with mesh:
        weights, state = init([np.asarray(ex.provider.get(w.name, w.file_dtype, w.shape))
                               for w in ex.plan.arg_weights])
        acts = {k: jax.device_put(np.asarray(v), jax_activation_sharding(mesh, np.shape(v)))
                for k, v in inputs.items()}
        target = jax.device_put(np.zeros(shape, np.float32), jax_activation_sharding(mesh, shape))
        weights, state, loss = step(weights, state, acts, target)
    names = [w.name for w in ex.plan.arg_weights]
    adam = state[0]
    return {"loss": float(loss), "names": names, "weights": dict(zip(names, map(np.asarray, weights))),
            "mu": dict(zip(names, map(np.asarray, adam.mu))), "nu": dict(zip(names, map(np.asarray, adam.nu)))}


def _u8_set(weights):
    """The TINY UNet's weights that force_uint8_storage_set quantizes at
    fetch: every 2-D one (per-channel u8, kernel 5's route) and every conv
    kernel (per tensor, dequantized on read)."""
    return {n for n, v in weights.items() if np.ndim(v) in (2, 4)}


@pytest.fixture(scope="module")
def runs():
    """Both groups' results, the references made while they run."""
    g2, g1 = jax_build_unet(JAX_TINY, batch=2), jax_build_unet(JAX_TINY, batch=1)
    g2sp = jax_build_unet(dataclasses.replace(JAX_TINY, context_len=16), batch=2)
    text2, w2, text1, w1 = g2.to_text(), dict(g2.weights), g1.to_text(), dict(g1.weights)
    text_sp, w_sp = g2sp.to_text(), dict(g2sp.weights)
    cases8 = [("dp2tp4", "unet", dict(text=text2, weights=w2, inputs=_inputs(2), mesh=dict(dp=2, tp=4))),
              ("sp", "unet", dict(text=text_sp, weights=w_sp, inputs=_inputs(2, 16), mesh=dict(dp=2, tp=2, sp=2))),
              ("sdpa_sp", "graphs", dict(graphs=[(k, text, {}, inputs)
                                                 for k, (text, inputs, _) in SDPA_SP_CASES.items()],
                                         mesh=dict(dp=2, tp=2, sp=2))),
              ("synth", "unet", dict(text=text1, weights=w1, inputs=_inputs(1), mesh=dict(dp=1, tp=8),
                                     return_weights=True, **SYNTH)),
              ("llm_tp4", "llm", dict(mesh=dict(dp=2, tp=4))),
              ("train_dp2", "train", dict(text=text2, weights=w2, inputs=_inputs(2), mesh=dict(dp=2))),
              ("train_sp", "train", dict(text=text_sp, weights=w_sp, inputs=_inputs(2, 16),
                                         mesh=dict(dp=2, tp=2, sp=2))),
              ("mesh", "mesh", {})]
    u8 = dict(force_uint8_storage_set=_u8_set(w1), uint8_per_channel=True)
    fconv, fconv_w, qconv, qconv_w, conv_x = _two_conv_net(32, 16)
    conv_ranges = run_session(fconv, fconv_w, {"x": conv_x}, CPU, range_data_calibrate=True)[1]._executor() \
        .range_data.data
    conv_cfg = {"w8a8": dict(use_uint8_arithmetic=True, range_data=dict(conv_ranges)),
                "qdq": dict(use_uint8_qdq=True, range_data=dict(conv_ranges)), "qdq_no_ranges": dict(use_uint8_qdq=True)}
    mm_text, mm_w, mm_in, mm_ranges = _w8a8_matmul()
    vae = jax_build_vae_decoder(JAX_VAE_TINY, seed=7)
    vae_text, vae_w = vae.to_text(), dict(vae.weights)
    vae_ranges = run_session(vae_text, vae_w, VAE_IN, CPU, range_data_calibrate=True,
                             fuse_ops_in_attention=True)[1]._executor().range_data.data
    vae_qtext, vae_qw = jax_quantize_graph_weights(vae_text, vae_w)
    vae_cfg = dict(fuse_ops_in_attention=True, use_uint8_arithmetic=True, range_data=dict(vae_ranges))
    halves = {k: _halves(*v) for k, v in HALVES.items()}
    tp2 = dict(dp=1, tp=2)
    cases8 += [("unet_streamed", "streamed", dict(text=text2, weights=w2, inputs=_inputs(2), mesh=dict(dp=2, tp=4),
                                                 budget=BUDGET)),
               ("qdq_strided_dp2tp4", "session", dict(text=halves["strided_dp2tp4"][0],
                                                      weights=halves["strided_dp2tp4"][1],
                                                      inputs=halves["strided_dp2tp4"][2], mesh=dict(dp=2, tp=4),
                                                      use_uint8_qdq=True))]
    cases2 = [("llm_tp2", "llm", dict(mesh=dict(dp=1, tp=2))),
              ("llm_tp2_int8", "llm", dict(mesh=dict(dp=1, tp=2), int8_weights=True)),
              ("unet_u8", "unet", dict(text=text1, weights=w1, inputs=_inputs(1), mesh=dict(dp=1, tp=2),
                                       return_weights=True, **u8)),
              ("grad", "collective_grad", {}),
              ("grad_broken", "collective_grad", dict(broken=True)),
              ("llm_tp2_bf16", "llm", dict(mesh=dict(dp=1, tp=2), compute_dtype="bfloat16")),
              ("llm_tp2_synth", "llm", dict(mesh=dict(dp=1, tp=2), cfg=SYNTH_LLAMA, synthetic_on_device=True)),
              ("ops_dp2", "graphs", dict(graphs=[(k, text, weights, inputs)
                                                 for k, (text, inputs, weights) in OP_CASES.items()],
                                         mesh=dict(dp=2))),
              ("mesh", "mesh", {})]
    cases2 += [(f"conv_{k}", "session", dict(text=qconv, weights=qconv_w, inputs={"x": conv_x}, mesh=tp2, **cfg))
               for k, cfg in conv_cfg.items()]
    cases2 += [("mm_w8a8", "session", dict(text=mm_text, weights=mm_w, inputs=mm_in, mesh=tp2,
                                           use_uint8_arithmetic=True, range_data=mm_ranges)),
               ("vae_calibration", "session", dict(text=vae_text, weights=vae_w, inputs=VAE_IN, mesh=tp2,
                                                   range_data_calibrate=True, fuse_ops_in_attention=True)),
               ("vae_w8a8", "session", dict(text=vae_qtext, weights=vae_qw, inputs=VAE_IN, mesh=tp2, **vae_cfg)),
               ("unet_streamed_tp2", "streamed", dict(text=text2, weights=w2, inputs=_inputs(2), mesh=tp2,
                                                      budget=BUDGET)),
               ("unet_streamed_synth", "streamed", dict(text=text1, weights=w1, inputs=_inputs(1), mesh=tp2,
                                                        budget=BUDGET, **SYNTH)),
               ("unet_streamed_u8", "streamed", dict(text=text1, weights=w1, inputs=_inputs(1), mesh=tp2,
                                                     budget=BUDGET // 4, **u8)),
               ("pp_mesh", "pp_mesh", dict(text=text1, weights=w1, inputs=_inputs(1), mesh=tp2, budget=BUDGET,
                                           stages=2))]
    cases2 += [(f"qdq_{k}", "session", dict(text=halves[k][0], weights=halves[k][1], inputs=halves[k][2], mesh=tp2,
                                            use_uint8_qdq=True)) for k in ("small", "strided")]
    with ThreadPoolExecutor(2) as pool:
        f8 = pool.submit(spawn, rank_cases, 8, "gloo", "cpu", GROUP_TIMEOUT_S, (cases8,))
        f2 = pool.submit(spawn, rank_cases, 2, "gloo", "cpu", GROUP_TIMEOUT_S, (cases2,))
        ref = {"port_dp2tp4": run_session(text2, w2, _inputs(2), CPU)[0],
               "jax_dp2tp4": _jax_unet(g2, _inputs(2), jax_make_mesh(8, dp=2, tp=4)),
               "port_sp": run_session(text_sp, w_sp, _inputs(2, 16), CPU)[0],
               "jax_sp": _jax_unet(g2sp, _inputs(2, 16), jax_make_mesh(8, dp=2, tp=2, sp=2)),
               "port_synth": run_session(text1, w1, _inputs(1), CPU, **SYNTH),
               "port_llm": llm_single(CPU), "jax_llm_tp2": _jax_llm(2), "jax_llm_tp4": _jax_llm(4),
               "port_llm_synth": llm_single(CPU, cfg=SYNTH_LLAMA, synthetic_on_device=True),
               "port_llm_int8": llm_single(CPU, int8_weights=True), "jax_llm_int8": _jax_llm(1, int8_weights=True),
               "port_unet_u8": run_session(text1, w1, _inputs(1), CPU, **u8),
               "jax_train_dp2": _jax_train(g2, _inputs(2), jax_make_mesh(8, dp=2)),
               "jax_train_sp": _jax_train(g2sp, _inputs(2, 16), jax_make_mesh(8, dp=2, tp=2, sp=2))}
        jtp2 = jax_make_mesh(2, dp=1, tp=2)
        ref["jax_conv"] = {k: _jax_session(qconv, qconv_w, {"x": conv_x}, jtp2, **cfg)[0]["y"]
                           for k, cfg in conv_cfg.items()}
        ref["jax_mm"] = _jax_session(mm_text, mm_w, mm_in, jtp2, use_uint8_arithmetic=True, range_data=mm_ranges)[0]
        ref["jax_vae_ranges"] = dict(_jax_session(vae_text, vae_w, VAE_IN, jtp2, eager=True, range_data_calibrate=True,
                                                  fuse_ops_in_attention=True)[1].range_data.data)
        ref["jax_vae_w8a8"] = _jax_session(vae_qtext, vae_qw, VAE_IN, jtp2, **vae_cfg)[0]
        ref["jax_halves"] = {k: _jax_session(*halves[k], jax_make_mesh(8, dp=2, tp=4) if "dp2" in k else jtp2,
                                             use_uint8_qdq=True)[0]["out"] for k in halves}
        ref["jax_unet_streamed"] = {"tp2": _jax_unet(g2, _inputs(2), jtp2, hbm_budget_bytes=BUDGET),
                                    "dp2tp4": _jax_unet(g2, _inputs(2), jax_make_mesh(8, dp=2, tp=4),
                                                        hbm_budget_bytes=BUDGET)}
        return {"ref": ref, 8: f8.result(), 2: f2.result()}


@pytest.mark.parametrize("case", ["dp2tp4", "sp"])
def test_sharded_unet_matches_single_device_and_jax(runs, case):
    """Under sp the context arrives split over sp, so the cross-attention's
    keys and values are gathered over it."""
    ref = runs["ref"]
    for rank, r in enumerate(runs[8]):
        y = r[case]["out"]
        np.testing.assert_allclose(y, ref[f"port_{case}"], rtol=2e-4, atol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(y, ref[f"jax_{case}"], rtol=2e-4, atol=1e-5, err_msg=f"rank {rank}")
        assert r[case]["gathers"]["tp"]["calls"] > 0
        if case == "sp":
            assert r[case]["gathers"]["sp"]["calls"] > 0


@pytest.mark.parametrize("case", list(SDPA_SP_CASES))
def test_attention_with_rows_over_sp_matches_one_device(runs, case):
    """Attention whose query rows sp shards, causal or not, on every rank of
    make_mesh(8, dp=2, tp=2, sp=2): the one-device output (float32 within
    1e-5 * max|out|, the op suite's bar), with keys gathered over sp."""
    text, inputs, _ = SDPA_SP_CASES[case]
    want = _one_device(text, inputs, {})["y0"]
    for rank, r in enumerate(runs[8]):
        got = r["sdpa_sp"][case]
        np.testing.assert_allclose(got["out"]["y0"], want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"rank {rank}")
        assert got["gathers"]["sp"]["calls"] > 0


def test_rank_holds_replicated_weights_and_a_quarter_of_the_sharded(runs):
    """make_mesh(8, dp=2, tp=4): replicated + sharded / 4 == one device's
    bytes, and hbm_stats() reports the rank's share."""
    for r in runs[8]:
        hbm = r["dp2tp4"]["hbm"]
        assert r["dp2tp4"]["mesh"] == {"dp": 2, "tp": 4}
        assert hbm["weight_bytes"] == hbm["replicated_weight_bytes"] + hbm["sharded_weight_bytes"]
        assert hbm["replicated_weight_bytes"] + 4 * hbm["sharded_weight_bytes"] == hbm["one_device_weight_bytes"]
        assert hbm["weight_bytes"] < hbm["one_device_weight_bytes"] / 3
    sp = runs[8][0]["sp"]
    assert sp["mesh"] == {"dp": 2, "tp": 2, "sp": 2}
    assert sp["hbm"]["replicated_weight_bytes"] + 2 * sp["hbm"]["sharded_weight_bytes"] == \
        sp["hbm"]["one_device_weight_bytes"]


def test_mesh_synthetic_weights_are_sharded_slices_of_the_one_device_weights(runs):
    """synthetic_device_weights under a mesh: each rank generates the whole
    weight from its seed and keeps its slice, so the shards are the
    one-device weights' and the output is the one-device output."""
    y0, s0 = runs["ref"]["port_synth"]
    ex0 = s0._executor()
    whole = {name: t.float().numpy() for name, t in ex0._fetch_segment_weights(ex0.segments[0]).items()}
    n_sharded = 0
    for r in runs[8]:
        case = r["synth"]
        np.testing.assert_allclose(case["out"], y0, rtol=2e-4, atol=1e-5)
        for name, local in case["weights"].items():
            shard = case["weight_shards"][name]
            want = whole[name]
            for axis, start, stop in shard or ():
                want = np.take(want, np.arange(start, stop), axis=axis)
            np.testing.assert_array_equal(local, want, err_msg=name)
            n_sharded += shard is not None
    assert n_sharded > 0, "no weight ended up tp-sharded"


def _check_llm(got, ref, tag):
    for step, (a, b) in enumerate(zip(ref["steps"], got["steps"])):
        assert a[0] == b[0], f"{tag}: tokens diverge at step {step}"
        dev = float(np.abs(a[1] - b[1]).max())
        assert dev < 2e-4, f"{tag}: step {step} logits max dev {dev}"
    assert got["generated"] == ref["generated"], tag


def test_tp2_llm_prefill_decode_and_on_device_decode(runs):
    """make_mesh(2, dp=1, tp=2): every rank's logits and tokens are the
    one-device pipeline's and the JAX sharded pipeline's; the cache is a
    (1, 1, P, 16) head shard; five decode steps cross bucket 8 -> 16."""
    for r in runs[2]:
        got = r["llm_tp2"]
        assert got["mesh"] == {"dp": 1, "tp": 2}
        assert got["kv_shape"] == (1, 1, 8, 16)
        assert got["cache_len"] == len(LLM_PROMPT) + 5
        _check_llm(got, runs["ref"]["port_llm"], "port one-device")
        _check_llm(got, runs["ref"]["jax_llm_tp2"], "jax tp=2")
        assert got["generated_cache_len"] == runs["ref"]["port_llm"]["generated_cache_len"]
        assert got["weight_bytes"] < runs["ref"]["port_llm"]["weight_bytes"]


def test_tp2_llm_on_synthesized_weights_matches_one_device(runs):
    """Weights synthesized on the device under a mesh: every bucket graph
    (prefill, decode at 8 and 16) reads the same slices, the prefill's, as
    the one-device pipeline's graphs read the same weights. A slice below the
    shared cache's size would otherwise be made again by each graph, seeded
    by its index in that graph's plan: other weights."""
    for r in runs[2]:
        _check_llm(r["llm_tp2_synth"], runs["ref"]["port_llm_synth"], "synthesized, tp=2")


def test_tp2_int8_llm_matches_one_device_int8(runs):
    """int8_weights under make_mesh(2, dp=1, tp=2): each rank quantizes its
    column slices of the MatMul weights as one device would and kernel 6
    runs at the local N (its activation rows quantized over the whole K):
    the logits within 2e-4 and the tokens of the one-device int8 pipeline,
    through prefill, decode and generate_on_device, whose tokens are JAX's
    one-device int8 pipeline's."""
    ref = runs["ref"]
    _check_llm(ref["port_llm_int8"], ref["jax_llm_int8"], "port vs jax, one device int8")
    for r in runs[2]:
        got = r["llm_tp2_int8"]
        assert got["kv_shape"] == (1, 1, 8, 16)
        _check_llm(got, ref["port_llm_int8"], "int8, tp=2")
        assert got["weight_bytes"] < ref["port_llm_int8"]["weight_bytes"]


def test_tp2_unet_with_weights_quantized_at_fetch_matches_one_device(runs):
    """force_uint8_storage_set under tp = 2 (per-channel u8 2-D weights, per
    tensor u8 conv kernels): the output is the one-device run's, and each
    rank's quantized weights, scales and zero points are the slices of the
    one device's, bit for bit."""
    y0, s0 = runs["ref"]["port_unet_u8"]
    ex0 = s0._executor()
    whole = {name: t.float().numpy() for name, t in ex0._fetch_segment_weights(ex0.segments[0]).items()}
    quant0 = {w.name: tuple(v.numpy() if isinstance(v, torch.Tensor) else v for v in w.quant)
              for w in ex0.plan.arg_weights if w.quant is not None}
    assert len(quant0) > 20
    for r in runs[2]:
        case = r["unet_u8"]
        np.testing.assert_allclose(case["out"], y0, rtol=2e-4, atol=1e-5)
        sliced = 0
        for name, local in case["weights"].items():
            shard = case["weight_shards"][name]
            np.testing.assert_array_equal(local, _take(whole[name], shard), err_msg=name)
            if name not in quant0:
                continue
            cols = [(a, b) for axis, a, b in shard or () if axis == np.ndim(whole[name]) - 1]
            for got, want in zip(case["quant"][name], quant0[name]):
                if isinstance(want, np.ndarray) and cols:
                    want = want[cols[0][0]:cols[0][1]]
                np.testing.assert_array_equal(got, want, err_msg=name)
            sliced += shard is not None
        assert sliced > 10, "few quantized weights ended up sliced"


def _take(a, shard):
    for axis, start, stop in shard or ():
        a = np.take(a, np.arange(start, stop), axis=axis)
    return a


@pytest.mark.parametrize("case", ["dp2", "sp"])
def test_train_step_matches_jax(runs, case):
    """One AdamW step under make_mesh(8, dp=2) (tp = 4) and make_mesh(8,
    dp=2, tp=2, sp=2) against JAX's make_train_step on the same mesh: the
    loss; the gradients themselves, each rank's slice against the slice of
    JAX's (read from optax's first moment, (1 - b1) g after one step: an
    update alone would not show a gradient tp times too large, Adam's first
    step being lr g / (|g| + eps)); the updated weights; each rank's AdamW
    exp_avg / exp_avg_sq against the slice of optax's mu / nu. The step went
    through the gathers' backward and the replicated weights' reduction."""
    want = runs["ref"][f"jax_train_{case}"]
    for rank, r in enumerate(runs[8]):
        got = r[f"train_{case}"]
        assert got["mesh"] == ({"dp": 2, "tp": 4} if case == "dp2" else {"dp": 2, "tp": 2, "sp": 2})
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6, err_msg=f"rank {rank}")
        assert sorted(got["names"]) == sorted(want["names"])
        nan = set()
        for name in got["names"]:
            shard = got["weight_shards"][name]
            mu, nu = want["mu"][name], want["nu"][name]
            for label, g, w, bar in (("grad", got["grads"][name], mu / 0.1, 5e-4),
                                     ("exp_avg", got["exp_avg"][name], mu, 5e-4),
                                     ("exp_avg_sq", got["exp_avg_sq"][name], nu, 1e-3)):
                scale = np.nanmax(np.abs(w)) if not np.isnan(w).all() else 0.0
                w = _take(w, shard)
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{name} {label} rank {rank}")
                np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(w), rtol=0, atol=bar * scale,
                                           err_msg=f"{name} {label} rank {rank}")
            if np.isnan(mu).any():
                nan.add(name)
            assert_updated_weights_close(name, got["weights"][name], _take(want["weights"][name], shard),
                                         _take(mu / 0.1, shard))
        assert len(nan) == POW_EXPONENTS
        assert got["tp_sharded"] > 0
        assert got["comm"]["tp.reduce_scatter"]["calls"] > 0 and got["comm"]["tp.all_reduce"]["calls"] > 0
        assert got["comm"]["dp.all_reduce"]["calls"] > 0
        if case == "sp":
            assert got["comm"]["sp.reduce_scatter"]["calls"] > 0


def test_gradients_through_a_gather_and_a_local_slice(runs):
    """dryrun.collective_grad_case on two ranks: with the gather's backward
    a reduce-scatter, each rank's gradient of its column slice of W and the
    summed gradient of the replicated V (used whole and through its column
    slice) are the one-device gradients; with a plain slice as the gather's
    backward they are not."""
    x, W, V = collective_grad_operands()
    W.requires_grad_(True)
    V.requires_grad_(True)
    y = x @ W
    ((y @ V).square().sum() + (y @ V).sum()).backward()
    for r, res in enumerate(runs[2]):
        cols = W.shape[1] // 2
        np.testing.assert_allclose(res["grad"]["grad_w"], W.grad[:, r * cols:(r + 1) * cols].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["grad"]["grad_v"], V.grad.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
    broken = [res["grad_broken"] for res in runs[2]]
    assert not all(np.allclose(b["grad_w"], W.grad[:, r * 3:(r + 1) * 3].numpy(), rtol=1e-3)
                   for r, b in enumerate(broken))


def test_gathers_move_the_compute_dtype(runs):
    """The same gathers in bf16 move half the bytes of float32: the
    RMSNorm's float32 upcast (requires_upcast, by op name) does not reach
    the gathers the pass puts before its ops."""
    for r in runs[2]:
        f32, bf16 = r["llm_tp2"]["gathers"]["tp"], r["llm_tp2_bf16"]["gathers"]["tp"]
        assert f32["calls"] == bf16["calls"] > 0
        assert f32["bytes"] == 2 * bf16["bytes"]


def _one_device(text, inputs, weights):
    s = Session(SessionConfig(device=CPU), weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s.run()


def test_every_op_case_under_dp2_matches_one_device(runs):
    """Each one-op graph of tests/test_torch_ops_card.py on the two ranks of
    make_mesh(2, dp=2): inputs with an even batch axis arrive split over dp,
    so every op type's rule (or its gather) runs; the gathered outputs equal
    the one-device run's (float32 within 1e-5 * max|out|, the op suite's bar;
    integer and bool results equal)."""
    split = [k for k, (_, inputs, _) in OP_CASES.items()
             if any(np.ndim(v) >= 1 and np.shape(v)[0] % 2 == 0 for v in inputs.values())]
    assert len(split) > len(OP_CASES) // 2
    for key, (text, inputs, weights) in OP_CASES.items():
        want = _one_device(text, inputs, weights)
        for rank, r in enumerate(runs[2]):
            got = r["ops_dp2"][key]["out"]
            assert set(got) == set(want), key
            for name, w in want.items():
                g = got[name]
                assert g.shape == w.shape and g.dtype == w.dtype, (key, name, rank)
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                               err_msg=f"{key} {name} rank {rank}")
                else:
                    np.testing.assert_array_equal(g, w, err_msg=f"{key} {name} rank {rank}")


def test_tp4_llm_with_indivisible_kv_heads_replicates_the_cache(runs):
    for r in runs[8]:
        got = r["llm_tp4"]
        assert got["kv_shape"] == (1, 2, 8, 16)
        _check_llm(got, runs["ref"]["port_llm"], "port one-device")
        _check_llm(got, runs["ref"]["jax_llm_tp4"], "jax tp=4")


@pytest.mark.parametrize("group", [8, 2])
def test_make_mesh_over_a_group(runs, group):
    """The default factorization (tp first: 8 -> 1 x 8, 2 -> 1 x 2), rank
    coordinates row-major, and a world size that is not the group's raises
    naming the launcher."""
    for rank, r in enumerate(runs[group]):
        m = r["mesh"]
        assert m["default"] == {"dp": 1, "tp": group}
        assert m["coordinate"] == [0, rank]
        assert len(m["errors"]) == 2 and all("torchrun" in e for e in m["errors"])


# --------------------------------------------------------- pipeline stages


def _pp_session(text, weights, stages, budget, **kw):
    s = Session(SessionConfig(device=CPU, hbm_budget_bytes=budget, pp_devices=[CPU] * stages, **kw),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    return s


def test_pp_unet_matches_single_device_and_keeps_stage_weights(monkeypatch):
    g = jax_build_unet(JAX_TINY)
    ins = _inputs(1)
    base = run_session(g.to_text(), dict(g.weights), ins, CPU)[0]
    jax_base = _jax_unet(g, ins)
    s = _pp_session(g.to_text(), dict(g.weights), 4, 1 << 20)
    for k, v in ins.items():
        s.add_tensor(k, v)
    y = s.run()["out_sample"]
    ex = s._executor()
    stages = [ex.seg_stage(i) for i in range(len(ex.segments))]
    assert len(ex.segments) > 1 and len(set(stages)) > 1 and stages == sorted(stages)
    np.testing.assert_array_equal(y, base)
    np.testing.assert_allclose(y, jax_base, rtol=2e-4, atol=1e-5)
    uploads = []
    monkeypatch.setattr(ex, "_upload", lambda w, device=None: uploads.append(w.name))
    np.testing.assert_array_equal(s.run()["out_sample"], base)
    assert uploads == [], "stage weights are resident: a second run uploads nothing"
    acc = ex.hbm_accounting()
    assert acc["mode"] == "pipeline" and len(acc["stage_weight_bytes"]) == 4


def _chain(n, tied_last=False, k=64, seed=0):
    rng = np.random.RandomState(seed)
    lines, weights = [], {}
    for i in range(n):
        src = "x" if i == 0 else f"t{i - 1}"
        wname = "w0.bin" if tied_last and i == n - 1 else f"w{i}.bin"
        lines.append(f"mm{i}:MatMul*input:{src}(1,{k});{wname}(float32:{k},{k})*output:t{i}(1,{k})")
        weights.setdefault(wname, (rng.randn(k, k) / np.sqrt(k)).astype(np.float32))
    return "\n".join(lines) + "\n", weights, rng.randn(1, k).astype(np.float32)


def test_pp_contiguous_placement_minimal_hops():
    """12 single-weight segments over 4 stages: contiguous blocks, balanced
    within one segment, hops == stages - 1."""
    text, weights, x = _chain(12)
    s = _pp_session(text, weights, 4, 64 * 64 * 4 + 1)
    s.add_tensor("x", x)
    y = s.run()["t11"]
    ex = s._executor()
    assign = [ex.seg_stage(si) for si in range(len(ex.segments))]
    assert len(assign) == 12 and len(set(assign)) == 4
    assert sum(a != b for a, b in zip(assign, assign[1:])) == 3
    counts = Counter(assign).values()
    assert max(counts) - min(counts) <= 1
    ref = x
    for i in range(12):
        ref = ref @ weights[f"w{i}.bin"]
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=1e-5)


def test_pp_weight_shared_across_stages_is_copied_between_devices():
    """A weight of segments on two stages: the second stage's copy comes from
    the first stage's device copy (the provider released the host copy)."""
    text, weights, x = _chain(4, tied_last=True)
    s = _pp_session(text, weights, 2, 64 * 64 * 4 + 1)
    s.add_tensor("x", x)
    y = s.run()["t3"]
    ex = s._executor()
    assert [ex.seg_stage(i) for i in range(4)] == [0, 0, 1, 1]
    assert {(0, "w0.bin"), (1, "w0.bin")} <= set(ex._resident)
    assert ex._resident[(0, "w0.bin")][0] is not ex._resident[(1, "w0.bin")][0]
    ref = x @ weights["w0.bin"] @ weights["w1.bin"] @ weights["w2.bin"] @ weights["w0.bin"]
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4)


def test_pp_runs_do_not_release_stage_weights():
    """Stage weights are resident, never released by a run (no donation):
    two runs of one session agree and hold the same device tensors."""
    text, weights, x = _chain(3, k=256)
    s = _pp_session(text, weights, 2, 256 * 256 * 4 + 1)
    s.add_tensor("x", x)
    y1 = s.run()["t2"]
    ex = s._executor()
    held = {k: v[0] for k, v in ex._resident.items()}
    y2 = s.run()["t2"]
    np.testing.assert_array_equal(y1, y2)
    assert all(ex._resident[k][0] is t for k, t in held.items())
    assert all(t.numel() for t in held.values())


# ----------------------------------------------- the options a mesh once refused


@pytest.mark.parametrize("case", ["w8a8", "qdq", "qdq_no_ranges"])
def test_two_conv_net_at_tp2_matches_jax(runs, case):
    """The two-conv net at widths tp = 2 shards (c1 32, c2 16 output
    channels) on both ranks, calibrated W8A8 (kernel 4 at O / 2 a rank), QDQ
    with the one-device ranges and QDQ with none (percentiles taken at run
    time), within rel 1e-5 of JAX's sharded session on two virtual devices.
    c2 reads c1's sharded output through the pass's gather: with the
    producer looked up in the rank's graph (the gather's name, no range) it
    quantizes with its own output range, and the W8A8 case fails."""
    want = runs["ref"]["jax_conv"][case]
    for rank, r in enumerate(runs[2]):
        got = r[f"conv_{case}"]
        assert _rel(got["out"]["y"], want) <= 1e-5, rank
        assert got["routes"] == ({"c1": "qconv", "c2": "qconv"} if case == "w8a8" else {})
        assert got["gathers"]["tp"]["calls"] > 0


def test_w8a8_matmul_at_tp2_matches_jax(runs):
    """A W8A8 MatMul on two ranks: each runs kernel 3's route on its (20, 48)
    K-major slice of the (48, 40) weight (tnk after the slice), the output
    gathered; within rel 1e-5 of JAX's sharded session."""
    want = runs["ref"]["jax_mm"]["y"]
    for r in runs[2]:
        got = r["mm_w8a8"]
        assert got["routes"] == {"mm": "qmatmul"}
        assert got["hbm"]["sharded_weight_bytes"] == 20 * 48
        assert _rel(got["out"]["y"], want) <= 1e-5


def test_tiny_vae_calibration_at_tp2_is_the_whole_tensors(runs):
    """Calibration of the TINY VAE decoder on two ranks records the whole
    tensors' ranges (each sharded output gathered) under the graph's own op
    and input names only, the same on both ranks, equal to JAX's (its
    run_eager is mesh-blind) within rtol 1e-6."""
    want = runs["ref"]["jax_vae_ranges"]
    got = [r["vae_calibration"]["ranges"] for r in runs[2]]
    assert got[0] == got[1]
    assert sorted(got[0]) == sorted(want) and "latent" in want and len(want) > 20
    assert not any("@" in k for k in got[0])
    for k, (lo, hi) in want.items():
        np.testing.assert_allclose(got[0][k], (lo, hi), rtol=1e-6, atol=1e-6 * max(abs(lo), abs(hi), 1.0), err_msg=k)


def test_tiny_vae_w8a8_decode_at_tp2_matches_jax(runs):
    """The TINY VAE decoder in W8A8 on two ranks with one device's ranges:
    kernel 4 at O / 2 where tp slices a conv, the same routes as one device,
    within rel 1e-5 of JAX's sharded session."""
    want = runs["ref"]["jax_vae_w8a8"]
    for r in runs[2]:
        got = r["vae_w8a8"]
        assert set(got["routes"].values()) == {"qconv", "qmatmul"} and len(got["routes"]) > 10
        assert got["hbm"]["sharded_weight_bytes"] > 0
        for k, w in want.items():
            assert _rel(got["out"][k], w) <= 1e-5, k


@pytest.mark.parametrize("case", list(HALVES))
def test_qdq_percentiles_are_the_whole_tensors(runs, case):
    """QDQ with no ranges where each shard's percentiles differ from the
    whole tensor's (halves of the columns 64 times apart): every rank
    quantizes its block with the whole tensor's (scale, zero), from the
    strided subsample one device takes (stride 3 past 2^21 elements), so the
    output equals JAX's sharded session's (exact integer arithmetic up to
    the quantization); at tp = 2 and, batch split too, at dp = 2 x tp = 4."""
    want = runs["ref"]["jax_halves"][case]
    group = runs[8] if "dp2" in case else runs[2]
    for rank, r in enumerate(group):
        got = r[f"qdq_{case}"]["out"]["out"]
        assert _rel(got, want) <= 1e-5, rank
    _, weights, inputs = _halves(*HALVES[case])
    y = inputs["x"] @ weights["w.bin"]
    assert np.abs(want - (y + np.maximum(y, 0))).max() > 0, "the quantization changed nothing"


@pytest.mark.parametrize("case", ["tp2", "dp2tp4", "synth", "u8"])
def test_streamed_unet_under_a_mesh(runs, case):
    """The TINY UNet at a 1 MiB budget a rank, under make_mesh(2, dp=1,
    tp=2) and make_mesh(8, dp=2, tp=4), on weights synthesized on the device
    and with weights quantized at fetch: two streamed runs bit for bit with
    the resident run of the same mesh on the same rank (at 256 KiB for the
    quantized weights, a quarter of the bytes); within the suite's
    bar of JAX's mesh + budget session (of the port's one-device run for
    the synthesized and quantized weights, which JAX does not make alike).
    A sharded weight crosses as its slice, never as the whole file's bytes."""
    group, label = (runs[8], "unet_streamed") if case == "dp2tp4" else (runs[2], f"unet_streamed_{case}")
    want = {"tp2": runs["ref"]["jax_unet_streamed"]["tp2"], "dp2tp4": runs["ref"]["jax_unet_streamed"]["dp2tp4"],
            "synth": runs["ref"]["port_synth"][0], "u8": runs["ref"]["port_unet_u8"][0]}[case]
    for rank, r in enumerate(group):
        got = r[label]
        np.testing.assert_array_equal(got["out"], got["resident"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["again"], got["resident"], err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["out"], want, rtol=2e-4, atol=1e-5, err_msg=f"rank {rank}")
        assert got["segments"] > 1 and got["hbm"]["mode"] == "streamed"
        sharded = [c for c in got["crossed"].values() if c["shard"]]
        assert sharded and not any(c["file_bytes"] for c in sharded)
        assert all(c["staged"] < c["upload"] + 256 for c in sharded)


def test_mesh_beside_pipeline_stages_is_the_staged_run(runs):
    """mesh + pp_devices on two ranks: the stages hold whole weights, so the
    pass does not run and each rank's output is the unsharded staged run's,
    bit for bit, with no gather."""
    for r in runs[2]:
        got = r["pp_mesh"]
        assert not got["sharded"] and not got["gathers"]
        assert sorted(set(got["stages"])) == [0, 1]
        np.testing.assert_array_equal(got["out"], got["plain"])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))

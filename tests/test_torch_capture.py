"""Captured segments, what the CPU can check: ``capture_problem`` names the
reason for every configuration that runs op by op, and none, decided
without a card, for a resident, streamed or staged plan on a CUDA device or
one with QDQ ranges taken from the data (the SD programs around a streamed
or staged model still name theirs); the captured run's segment loop with
each graph stood in for by its body (resident, streamed, staged, QDQ
without ranges) against eager runs and the JAX session; runs on the CPU
never capture, report no graph memory for any segment and stay where they
were against the JAX session, the bookkeeping
that a capture does around the kernel wrappers (launch counts, held
workspaces, kernel 6's quantized A), the registry of launch counters, how a
captured graph's kernel nodes are read and held to the launches the
wrappers recorded, and outputs a caller holds.

The captures themselves, and replays against the per-op oracle, run on the
card: tests/test_torch_capture_card.py.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from onnxstream_tpu.models.llm.pipeline import LlamaPipeline as JaxPipeline
from onnxstream_tpu.models.sd.unet import TINY as JAX_TINY
from onnxstream_tpu.models.sd.unet import build_unet as jax_build_unet
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig, kernels
from onnxstream_tpu_torch.kernels import gn_conv, qmatmul
from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY, build_llama
from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet
from onnxstream_tpu_torch.runtime import executor as executor_mod
from onnxstream_tpu_torch.runtime.executor import capture_problem, segment_fn_problem
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)


@dataclasses.dataclass
class _RankMesh:
    """One rank's view of a mesh, enough to plan its share (no process group)."""
    mesh_dim_names: tuple
    shape: tuple

    def get_coordinate(self):
        return [0] * len(self.shape)

    def get_group(self, dim):
        return dim


def _unet_graph():
    return build_unet(TINY, seed=1)


def _unet_inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"sample": rng.standard_normal((1, 4, 16, 16), dtype=np.float32),
            "timestep": np.array([900.0 - 200 * seed], np.float32),
            "encoder_hidden_states": rng.standard_normal((1, 7, 32), dtype=np.float32)}


def _llama_graph():
    return build_llama(LLAMA_TINY, new_len=8, past=0, seed=2)


def _llama_inputs() -> dict:
    return {"input_5F_ids": np.arange(3, 11, dtype=np.int64)[None],
            "position_5F_ids": np.arange(8, dtype=np.int64)[None],
            "last_5F_pos": np.array([7], np.int64)}


MODELS = {"unet": (_unet_graph, _unet_inputs), "llama": (_llama_graph, _llama_inputs)}


def _session(model: str, **config) -> Session:
    build, inputs = MODELS[model]
    g = build()
    s = Session(SessionConfig(**config), weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    s.read_string(g.to_text())
    for k, v in inputs().items():
        s.add_tensor(k, v)
    return s


# (config, words of the stated reason)
INELIGIBLE = {
    "cpu": (dict(device=CPU), "runs on cpu"),
    "mesh": (dict(device=CARD, mesh=_RankMesh(("dp", "tp"), (1, 2))), "runs under a mesh"),
    "ops_printf": (dict(device=CARD, ops_printf=True), "ops_printf: Session.run takes the per-op interpreter"),
    "ops_times_printf": (dict(device=CARD, ops_times_printf=True), "ops_times_printf"),
    "calibration": (dict(device=CARD, range_data_calibrate=True), "range_data_calibrate"),
}

# configurations captured a graph a segment on a card: (config, segments at least)
CAPTURED = {
    "streamed": (dict(device=CARD, hbm_budget_bytes=64 << 10), 3),
    "pp_devices": (dict(device=CARD, hbm_budget_bytes=64 << 10, pp_devices=[CARD, CARD]), 3),
    "qdq_without_ranges": (dict(device=CARD, use_uint8_qdq=True), 1),
}


def _no_card(monkeypatch) -> None:
    """Planning for cuda:0 on a machine without one, and asking the
    predicates, must call nothing of torch.cuda."""
    def no_card(*args, **kw):
        raise AssertionError("touched the card")

    for name in ("is_available", "current_stream", "synchronize", "memory_reserved", "graph_pool_handle"):
        monkeypatch.setattr(torch.cuda, name, no_card)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_capture_problem_states_each_reason(model, case):
    config, words = INELIGIBLE[case]
    ex = Session._executor(_session(model, **config))
    problem = capture_problem(ex)
    assert problem is not None and words in problem, problem


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_resident_plan_on_a_card_is_captured_without_touching_it(model, monkeypatch):
    """The predicate reads the config and the plan only: planning for cuda:0
    on a machine without one, and asking, call nothing of torch.cuda."""
    _no_card(monkeypatch)
    ex = Session._executor(_session(model, device=CARD, compute_dtype="bfloat16"))
    assert capture_problem(ex) is None
    assert not ex.captured and ex.memory_analysis() is None


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("case", sorted(CAPTURED))
def test_capture_problem_is_none_for_streamed_staged_and_qdq_runs(model, case, monkeypatch):
    """Streamed segments, pipeline stages and QDQ ranges taken from the data
    are captured, a graph a segment, planned for cuda:0 without touching
    it; what a device program's segment function cannot stand for stays
    named (segment_fn_problem)."""
    _no_card(monkeypatch)
    config, segments = CAPTURED[case]
    ex = Session._executor(_session(model, **config))
    assert capture_problem(ex) is None and len(ex.segments) >= segments
    assert not ex.captured and ex.graph_launches() is None and ex.graph_memory() is None
    words = {"streamed": "streamed: weights cross", "pp_devices": "pipeline stages on 2"}.get(case)
    problem = segment_fn_problem(ex)
    assert (problem is None) if words is None else (words in problem), problem


class _GraphStandIn:
    """A captured CUDA graph stood in for on the CPU: the tensors its body
    made at the capture are its memory; a replay runs the body again and
    writes the values into those same tensors, where the later graphs read
    them at their capture, as graphs that share a pool do."""

    def __init__(self, body):
        self.body, self.memory = body, body()
        self.outputs = dict(self.memory)

    def replay(self):
        for name, v in self.body().items():
            self.memory[name].copy_(v)


def _request(model: str, i: int) -> dict:
    if model == "unet":
        return _unet_inputs(i)
    req = _llama_inputs()
    req["input_5F_ids"] = np.random.default_rng(i).integers(3, 500, (1, 8)).astype(np.int64)
    return req


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("case", ["resident", "streamed", "pp_devices", "qdq_without_ranges"])
def test_the_segment_loop_with_its_graphs_stood_in_for(model, case, monkeypatch):
    """The captured run's loop on the CPU, each graph stood in for by its
    body (``_GraphStandIn``): the first run op by op, the second captures a
    graph a segment and replays it, later ones replay, over the static
    inputs, the slots refilled between the segments; every run's outputs
    equal an eager run of the same inputs (``Executor.eager``) and the JAX
    session's within the repo's float32 bars."""
    captured = []

    def stand_in(body, device, pool, what, failed_at, static=(), holds=()):
        captured.append(what)
        return _GraphStandIn(body)

    monkeypatch.setattr(executor_mod, "capture_graph", stand_in)
    monkeypatch.setattr(executor_mod, "capture_problem", lambda ex: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    config = {"resident": {}, "streamed": dict(hbm_budget_bytes=64 << 10),
              "pp_devices": dict(hbm_budget_bytes=64 << 10, pp_devices=[CPU, CPU]),
              "qdq_without_ranges": dict(use_uint8_qdq=True)}[case]
    s = _session(model, device=CPU, **config)
    s.graph_pool = ("a pool",)  # the executors' graphs share it: no pool handle is asked of a card
    g = MODELS[model][0]()
    js = JaxSession(JaxConfig(**{k: v for k, v in config.items() if k != "pp_devices"}),
                    weights_provider=JaxDict(dict(g.weights)))
    js.read_string(g.to_text())
    for i in range(4):
        for k, v in _request(model, i).items():
            s.add_tensor(k, v)
            js.add_tensor(k, v)
        ex = s._executor()
        got = s.run()
        assert ex.captured == (i > 0) and captured == [f"segment {si}" for si in range(len(ex.segments))] * (i > 0)
        with ex.eager():
            want = s.run()
        for name, w in js.run().items():
            np.testing.assert_array_equal(got[name], want[name])
            if case != "qdq_without_ranges":
                np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4)
    assert len(ex.segments) >= (1 if case in ("resident", "qdq_without_ranges") else 3)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_memory_analysis_is_none_for_every_segment_on_the_cpu(model):
    s = _session(model, device=CPU, hbm_budget_bytes=64 << 10)
    for _ in range(3):
        s.run()
    ex = s._executor()
    assert len(ex.segments) >= 3 and not ex.captured
    assert all(ex.memory_analysis(si) is None for si in range(len(ex.segments)))
    assert ex.graph_memory() is None and ex.graph_launches() is None and "graph_bytes" not in ex.hbm_accounting()


@pytest.mark.parametrize("case", ["streamed", "pp_devices"])
def test_the_sd_programs_name_a_streamed_or_staged_model(case, monkeypatch):
    """Planned for cuda:0 without touching it: a streamed or staged UNet
    and tile decoder capture their own segments (capture_problem None), but
    generate_on_device's step and the tiled decode, whose bodies then call
    Session.run, stay op by op around it: loop_capture_problem and
    tile_capture_problem name segment_fn_problem's reason, and nothing for
    the resident models."""
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    _no_card(monkeypatch)
    sessions = (port.unet, port.vae_tile_session)
    for sess in sessions:
        sess.config.device = CARD
        sess._executors.clear()
    assert port.loop_capture_problem() is None and port.tile_capture_problem() is None
    config, words = {"streamed": (dict(hbm_budget_bytes=64 << 10), "streamed: weights cross"),
                     "pp_devices": (dict(hbm_budget_bytes=64 << 10, pp_devices=[CARD, CARD]),
                                    "pipeline stages on 2")}[case]
    for sess in sessions:
        for k, v in config.items():
            setattr(sess.config, k, v)
        sess._executors.clear()
    assert words in port.loop_capture_problem() and words in port.tile_capture_problem()
    for ex in (port._loop_executor(1), port._tile_executor(port._tile_size)[1]):
        assert capture_problem(ex) is None and len(ex.segments) > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_runs_never_capture_and_stay_on_the_jax_session(dtype):
    s = _session("unet", device=CPU, compute_dtype=dtype)
    g = jax_build_unet(JAX_TINY, seed=1)
    js = JaxSession(JaxConfig(compute_dtype=dtype), weights_provider=JaxDict(g.weights))
    js.read_string(g.to_text())
    for i in range(3):
        for k, v in _unet_inputs(i).items():
            s.add_tensor(k, v)
            js.add_tensor(k, v)
        got, want = s.run()["out_sample"], js.run()["out_sample"]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert float(np.abs(got - want).max()) <= 5e-2 * float(np.abs(want).max())
        ex = s._executor()
        assert not ex.captured and ex.memory_analysis() is None and "graph_bytes" not in ex.hbm_accounting()
    assert "graph_bytes" not in s.hbm_stats() and s.graph_pool is None


def test_cpu_llama_pipelines_keep_jax_tokens_and_no_pool():
    port = LlamaPipeline(LLAMA_TINY, buckets=[8, 16, 32], device=CPU)
    jax = JaxPipeline(LLAMA_TINY, buckets=[8, 16, 32])
    for prompt in ([3, 17, 99, 5], [7, 1, 2], [9, 9, 4, 4, 8]):
        port.reset()
        jax.reset()
        assert port.generate_on_device(prompt, max_new_tokens=8) == jax.generate_on_device(prompt, max_new_tokens=8)
    assert port._graph_pool is None
    for s in port._sessions.values():
        assert s.graph_pool is None and not any(ex.captured for ex in s._executors.values())


def test_cpu_sd_pipeline_shares_no_pool():
    p = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    assert all(s.graph_pool is None for s in (p.text_encoder, p.unet, p.vae_decoder, p.vae_tile_session))


def test_held_device_outputs_are_not_overwritten_by_a_later_run():
    s = _session("unet", device=CPU)
    held = []
    for i in range(3):
        for k, v in _unet_inputs(i).items():
            s.add_tensor(k, v)
        out = s.run(device_outputs=True)["out_sample"]
        held.append((out, out.clone()))
    for out, copy in held:
        assert torch.equal(out, copy)
    assert not torch.equal(held[0][0], held[1][0])


def test_a_changed_scalar_option_changes_the_dispatch_key():
    ex = _session("unet", device=CPU)._executor()
    key = ex._dispatch_key()
    assert ("use_flash_attention", True) in key and ex._dispatch_key() == key
    ex.config.use_flash_attention = False
    assert ex._dispatch_key() != key


def test_capturing_restores_the_counts_and_records_launches_and_holds():
    x = torch.zeros((1, 8, 4, 4), dtype=torch.bfloat16)
    fa = kernels.counted()["flash_attention_packed"]
    start = kernels.launch_counts()
    qmatmul._QUANTIZED_A[CPU] = (x, x._version, x)
    with kernels.capturing() as rec:
        assert qmatmul._QUANTIZED_A == {}  # no quantized A from outside the graph
        fa.launches += 10
        kernels.counted()["w8a8_dyn_matmul"].launches += 155
        slab = gn_conv._slab(x)
        qmatmul._QUANTIZED_A[CPU] = (x, x._version, x)
    assert kernels.launch_counts() == start and qmatmul._QUANTIZED_A == {}
    assert rec.launches == {"flash_attention_packed": 10, "w8a8_dyn_matmul": 155}
    assert len(rec.holds) == 1 and rec.holds[0] is slab and slab.numel() >= x.numel() * 2
    replayed, nodes = dict(kernels.replayed), dict(kernels.replayed_nodes)
    kernels.add_replay(rec.launches, {"fa_wgmma_kernel": 10, "nvjet_tst": 3})
    kernels.add_replay(rec.launches, {"fa_wgmma_kernel": 10, "nvjet_tst": 3})
    after = kernels.launch_counts()
    assert after["flash_attention_packed"] == start["flash_attention_packed"] + 20
    assert after["w8a8_dyn_matmul"] == start["w8a8_dyn_matmul"] + 310
    assert kernels.replayed["flash_attention_packed"] == replayed.get("flash_attention_packed", 0) + 20
    assert kernels.replayed_nodes["nvjet_tst"] == nodes.get("nvjet_tst", 0) + 6
    for name, n in rec.launches.items():
        kernels.counted()[name].launches -= 2 * n
        kernels.replayed[name] -= 2 * n
    kernels.replayed_nodes.subtract({"fa_wgmma_kernel": 20, "nvjet_tst": 6})
    assert gn_conv._slab(x) is slab  # outside a capture nothing is held
    assert len(rec.holds) == 1


def test_the_counters_are_the_wrappers_registered_at_import(monkeypatch):
    """A name rebound in a wrapper's module (a call recorder standing in
    for it) does not take the wrapper's place in the registry."""
    from onnxstream_tpu_torch.kernels import flash_attention, matmul

    registry = kernels.counted()
    assert set(registry) == {"flash_attention_packed", "flash_attention", "w8a8_dyn_matmul", "w8_matmul", "qmatmul",
                             "qconv", "gn_silu", "gn_silu_conv", "matmul"}
    wrappers = matmul.matmul, flash_attention.flash_attention
    monkeypatch.setattr(matmul, "matmul", lambda *a, **k: None)
    monkeypatch.setattr(flash_attention, "flash_attention", lambda *a, **k: None)
    assert (kernels.counted()["matmul"], kernels.counted()["flash_attention"]) == wrappers
    before = kernels.launch_counts()["flash_attention"]
    kernels.count("flash_attention")  # a launch counts on the registered wrapper, not on the name's new value
    assert kernels.launch_counts()["flash_attention"] == before + 1
    kernels.counted()["flash_attention"].launches -= 1


# (a graph node's mangled name, the profiler's demangled one, the function's name)
KERNEL_NAMES = [
    ("_Z15fa_wgmma_kernelI13__nv_bfloat16Li64EEv8FaParamsiiiPf",
     "void fa_wgmma_kernel<__nv_bfloat16, 64>(FaParams, int, int, int, float*)", "fa_wgmma_kernel"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi8ENS0_21CUDAFunctorOnSelf_addIN3c108BFloat16EEESt5arrayIPcLm2EEEEviT0_T1_",
     "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctorOnSelf_add<c10::BFloat16>, "
     "std::array<char*, 2ul> >(int, at::native::CUDAFunctorOnSelf_add<c10::BFloat16>, std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel"),
    ("_ZN43_GLOBAL__N__b6de9c8c_10_SoftMax_cu_9f978f6320softmax_warp_forwardIfffLi6ELb0ELb0EEEvPT0_PKT_iiiPKbib",
     "void (anonymous namespace)::softmax_warp_forward<float, float, float, 6, false, false>(float*, float const*, "
     "int, int, int, bool const*, int, bool)", "softmax_warp_forward"),
    ("_Z23implicit_convolve_sgemmI13__nv_bfloat16S0_Li128ELi5ELi5ELi3ELi3ELi3ELi1ELb0ELb0ELb1EEviiiPKT_iPT0_S3_18kernel_"
     "conv_paramsyiffiPKS4_S8_bbii", "void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 128, 5, 5, 3, 3, 3, "
     "1, false, false, true>(int, int, int, __nv_bfloat16 const*, int)", "implicit_convolve_sgemm"),
    ("nvjet_tst_64x8_64x16_1x4_h_bz_NNT", "nvjet_tst_64x8_64x16_1x4_h_bz_NNT", "nvjet_tst_64x8_64x16_1x4_h_bz_NNT"),
    ("_ZN8internal5gemvx6kernelIiiffffLb0ELb1ELb0ELb0ELi6ELb0E18cublasGemvParamsExIi30cublasGemvTensorStridedBatchedIKfE"
     "S5_S3_IfEfEEENSt9enable_ifIXntT5_EvE4typeET11_",
     "std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, float, float, false, true, "
     "false, false, 6, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
     "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx)",
     "kernel"),
]


@pytest.mark.parametrize("mangled,demangled,want", KERNEL_NAMES, ids=[k[2] for k in KERNEL_NAMES[:-1]] + ["gemvx"])
def test_kernel_name_is_the_same_from_a_graph_node_and_a_profiler_event(mangled, demangled, want):
    assert kernels.kernel_name(mangled) == kernels.kernel_name(demangled) == want


# CUDA's DOT description of a captured graph (cudaGraphDebugDotPrint, no
# flags), as the card wrote it for three kernels and a device copy
GRAPH_DOT = '''digraph dot {
subgraph cluster_4 {
label="graph_4" graph[style="dashed"];
"graph_4_node_0"[style="bold" shape="octagon" label="0
nvjet_tst_64x8_64x16_1x4_h_bz_NNT
"];

"graph_4_node_1"[style="bold" shape="octagon" label="1
_Z15fa_wgmma_kernelI13__nv_bfloat16Li64EEv8FaParamsiiiPf
"];

"graph_4_node_2"[style="solid" shape="trapezium"label="2
MEMCPY
(DtoD,8192)
"];

"graph_4_node_3"[style="bold" shape="octagon" label="3
_Z15fa_wgmma_kernelI13__nv_bfloat16Li64EEv8FaParamsiiiPf
"];

"graph_4_node_0" -> "graph_4_node_1";
"graph_4_node_1" -> "graph_4_node_2";
"graph_4_node_2" -> "graph_4_node_3";
}
}
'''


def test_dot_kernels_counts_the_kernel_nodes_by_name():
    assert kernels.dot_kernels(GRAPH_DOT) == {"nvjet_tst_64x8_64x16_1x4_h_bz_NNT": 1, "fa_wgmma_kernel": 2}


HELD = [
    ({"flash_attention_packed": 2}, {"fa_wgmma_kernel": 2, "nvjet": 5}, None),
    ({"flash_attention": 1, "flash_attention_packed": 1}, {"fa_tf32_kernel": 1, "fa_fma_kernel": 1}, None),
    ({"w8a8_dyn_matmul": 155}, {"dyn_gemv_nk_kernel": 154, "dyn_wgmma_kernel": 1, "dyn_quant_rows_kernel": 1}, None),
    ({"qmatmul": 39, "qconv": 35}, {"qgemm_wgmma_kernel": 39}, None),
    ({"flash_attention_packed": 10}, {"fa_wgmma_kernel": 9}, r"flash_attention_packed\+flash_attention: 10 recorded"),
    ({}, {"gn_conv_wgmma_kernel": 1}, "gn_silu_conv: 0 recorded, 1 nodes"),
    ({"qmatmul": 4, "qconv": 5}, {"qgemm_kernel": 4}, "qconv: 5 recorded"),
]


@pytest.mark.parametrize("launches,nodes,error", HELD, ids=[f"case{i}" for i in range(len(HELD))])
def test_held_to_graph_holds_the_record_to_the_graphs_nodes(launches, nodes, error):
    if error is not None:
        with pytest.raises(RuntimeError, match=error):
            kernels.held_to_graph(launches, nodes)
        return
    got = kernels.held_to_graph(launches, nodes)
    flash = got["flash_attention_packed+flash_attention"]
    assert flash == launches.get("flash_attention_packed", 0) + launches.get("flash_attention", 0)
    assert got["w8a8_dyn_matmul"] == launches.get("w8a8_dyn_matmul", 0)
    assert got["qmatmul"] == launches.get("qmatmul", 0)

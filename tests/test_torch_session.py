"""The UNet slice end to end: the port's Session against the JAX Session.

The TINY UNet graph and weights come from the JAX package's builder and go
through both Sessions on the CPU with the same seeded inputs. float32 must
agree to rtol = atol = 1e-4; bfloat16 to max|port - jax| <= 5e-2 * max|jax|.
The same bars hold under the GroupNorm and small-conv routes (``fuse_groupnorm``,
``fuse_gn_conv``, ``use_pallas_smallconv``), where the JAX session runs its
Pallas kernels in interpret mode and the port its kernels' plain twins.
"""

import numpy as np
import pytest
import torch

from onnxstream_tpu.models.sd.unet import TINY, build_unet
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.runtime.planner import PlanError
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    g = build_unet(TINY)
    rng = np.random.default_rng(0)
    inputs = {
        "sample": rng.standard_normal((1, 4, 16, 16), dtype=np.float32),
        "timestep": np.array([500.0], np.float32),
        "encoder_hidden_states": rng.standard_normal((1, 7, 32), dtype=np.float32),
    }
    return g, inputs


def _port(g, inputs, **cfg):
    s = Session(SessionConfig(device=CPU, **cfg),
                weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    s.read_string(g.to_text())
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s


def _jax(g, inputs, **cfg):
    s = JaxSession(JaxConfig(**cfg), weights_provider=JaxDict(g.weights))
    s.read_string(g.to_text())
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_unet_matches_jax(tiny, dtype):
    g, inputs = tiny
    ps = _port(g, inputs, compute_dtype=dtype)
    # the same fused graph: 14 packed-head attention sites
    assert sum(op.op_type == "ostpu.sdpa" and op.attr_int("heads", 0) > 0 for op in ps.graph.ops) == 14
    got = ps.run()["out_sample"]
    want = _jax(g, inputs, compute_dtype=dtype).run()["out_sample"]
    assert got.shape == want.shape == (1, 4, 16, 16) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        ratio = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"bf16 TINY UNet: max|port - jax| / max|jax| = {ratio:.4e}")
        assert ratio <= 5e-2


def test_run_eager_matches_run_and_segments(tiny):
    """run_eager (all weights at once, per-op loop) is the oracle for run();
    a small HBM budget splits the graph into streamed segments with the same
    result."""
    g, inputs = tiny
    s = _port(g, inputs)
    out = s.run()["out_sample"]
    np.testing.assert_allclose(s.run(eager=True)["out_sample"], out, rtol=1e-6, atol=1e-6)
    streamed = _port(g, inputs, hbm_budget_bytes=64 << 10)
    np.testing.assert_allclose(streamed.run()["out_sample"], out, rtol=1e-6, atol=1e-6)
    assert len(streamed._executor().segments) > 1 == len(s._executor().segments)
    # on the CPU there is no CUDA allocator to read: only the weight bytes
    # and the executors' accounting
    assert set(s.hbm_stats()) == {"weight_bytes", "accounting"} and s.hbm_stats()["weight_bytes"] > 0
    assert s.hbm_stats()["accounting"]["mode"] == "resident"
    assert streamed.hbm_stats()["accounting"]["segments"] == len(streamed._executor().segments)


def test_strict_shapes_plan_error():
    text = "t/Add:Add*input:a(2,3);b(2,3)*output:y(2,4)"
    s = Session(SessionConfig(device=CPU), weights_provider=DictWeightsProvider({}))
    s.read_string(text)
    s.add_tensor("a", np.ones((2, 3), np.float32))
    s.add_tensor("b", np.ones((2, 3), np.float32))
    with pytest.raises(PlanError, match="check_output_shape"):
        s.run()
    s = Session(SessionConfig(device=CPU, strict_shapes=False), weights_provider=DictWeightsProvider({}))
    s.read_string(text)
    s.add_tensor("a", np.ones((2, 3), np.float32))
    s.add_tensor("b", np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(s.run()["y"], np.full((2, 3), 2.0, np.float32))


@pytest.mark.parametrize("name", ["flash_packed_nopad", "force_fp16_storage", "use_nhwc_layout"])
def test_unimplemented_options_raise(name):
    with pytest.raises(NotImplementedError):
        SessionConfig(device=CPU, **{name: True})
    s = Session(SessionConfig(device=CPU))
    with pytest.raises(NotImplementedError):
        s.set_option(name, True)
    s.set_option(name, False)  # the default is accepted


@pytest.mark.parametrize("name", ["fuse_gn_conv", "fuse_groupnorm", "use_pallas_smallconv"])
def test_kernel_route_options_are_taken(name):
    """The GroupNorm and small-conv routes are off by default; the config and
    set_option take them, and set_option re-fuses the loaded graph."""
    assert getattr(SessionConfig(device=CPU), name) is False
    assert getattr(SessionConfig(device=CPU, **{name: True}), name) is True
    g = build_unet(TINY)
    s = Session(SessionConfig(device=CPU), weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    s.read_string(g.to_text())
    before = len(s.graph.ops)
    s.set_option(name, True)
    assert getattr(s.config, name) is True
    assert (len(s.graph.ops) < before) == name.startswith("fuse_")
    s.set_option(name, False)
    assert len(s.graph.ops) == before


def test_session_requires_a_device_and_known_options():
    """device=None means the first CUDA card: without one the Session names
    the missing card instead of running on the CPU."""
    if torch.cuda.is_available():
        assert Session(SessionConfig()).config.device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(SessionConfig())
    with pytest.raises(ValueError, match="unknown option"):
        Session(SessionConfig(device=CPU)).set_option("no_such_option", True)


def test_quantized_weights_and_unported_ops_raise():
    """uint8 weights run through the weight-only route (w8_matmul), and ops
    outside the slice have no impl: they refuse instead of computing
    something else."""
    w = torch.tensor([[0, 255], [3, 7], [128, 1]], dtype=torch.uint8)
    s = Session(SessionConfig(device=CPU), weights_provider=DictWeightsProvider({"w": w}))
    s.read_string("t/mm:MatMul*input:a(2,3);w(uint8[0.5,3]:3,2)*output:y(2,2)")
    a = np.array([[1.0, 2.0, -1.0], [0.5, 0.0, 4.0]], np.float32)
    s.add_tensor("a", a)
    np.testing.assert_allclose(s.run()["y"], a @ ((w.numpy().astype(np.float32) - 3) * 0.5), rtol=1e-6)
    assert s._executor().quant_routes == {"t/mm": "w8_matmul"}
    s = Session(SessionConfig(device=CPU))
    s.read_string("t/gn:ostpu.groupnorm*input:a(1,2,2,4)*output:y(1,2,2,4)*groups:2")
    s.add_tensor("a", np.ones((1, 2, 2, 4), np.float32))
    with pytest.raises(PlanError, match="ostpu.groupnorm"):
        s.run()


def test_tiny_unet_from_quantize_graph_weights_matches_jax(tiny):
    """A ``--quantize-uint8`` graph (per-tensor uint8[scale,zp] weights, the
    converter's exclusions, no range data): every 2-D uint8 MatMul weight runs
    through w8_matmul (the JAX executor: its Pallas kernel in interpret mode),
    Conv and other uint8 weights dequantize on read. float32, within
    1e-4 * max|jax|."""
    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights

    g, inputs = tiny
    text, weights = quantize_graph_weights(g.to_text(), g.weights)
    ps = Session(SessionConfig(device=CPU), weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    js = JaxSession(JaxConfig(), weights_provider=JaxDict(weights))
    for s in (ps, js):
        s.read_string(text)
        for k, v in inputs.items():
            s.add_tensor(k, v)
    got, want = ps.run()["out_sample"], js.run()["out_sample"]
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    ex = ps._executor()
    u8_matmuls = [op.name for op in ps.graph.ops if op.op_type == "MatMul" and len(op.inputs) == 2
                  and op.inputs[1].is_weight and ex._arg_by_name.get(op.inputs[1].name) is not None
                  and ex._arg_by_name[op.inputs[1].name].quant is not None]
    assert u8_matmuls and ex.quant_routes == {n: "w8_matmul" for n in u8_matmuls}
    assert any(w.quant is not None and len(w.shape) == 4 for w in ex.plan.arg_weights)  # u8 convs


# ------------------------------------------- the GroupNorm and small-conv routes
ROUTES = {
    "groupnorm": dict(fuse_groupnorm=True),
    "gn_conv": dict(fuse_gn_conv=True),
    "A": dict(fuse_gn_conv=True, fuse_groupnorm=True),
    "B": dict(use_pallas_smallconv=True, fuse_groupnorm=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tiny_unet_routes_match_jax(tiny, route, dtype):
    g, inputs = tiny
    ps = _port(g, inputs, compute_dtype=dtype, **ROUTES[route])
    got = ps.run()["out_sample"]
    want = _jax(g, inputs, compute_dtype=dtype, pallas_interpret=True, **ROUTES[route]).run()["out_sample"]
    kinds = [op.op_type for op in ps.graph.ops]
    assert ("ostpu.gn_silu" in kinds) == ("fuse_groupnorm" in ROUTES[route])
    assert ("ostpu.gn_silu_conv" in kinds) == ("fuse_gn_conv" in ROUTES[route])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float(np.abs(got - want).max()) <= 5e-2 * float(np.abs(want).max())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tiny_unet_routes_match_the_decomposed_graph(tiny, route):
    """Fused against decomposed within the port (the JAX suite's bar,
    tests/test_gn_silu.py: rtol 5e-4, atol 5e-5), run against run_eager, and
    the same result when a small budget streams the weights in segments, the
    (9, O, C) relayout of a fused conv's weight included."""
    g, inputs = tiny
    base = _port(g, inputs).run()["out_sample"]
    s = _port(g, inputs, **ROUTES[route])
    out = s.run()["out_sample"]
    np.testing.assert_allclose(out, base, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(s.run(eager=True)["out_sample"], out, rtol=1e-6, atol=1e-6)
    streamed = _port(g, inputs, hbm_budget_bytes=64 << 10, **ROUTES[route])
    np.testing.assert_allclose(streamed.run()["out_sample"], out, rtol=1e-6, atol=1e-6)
    assert len(streamed._executor().segments) > 1


def test_transformed_weight_streams_in_file_layout(tiny):
    """A fused conv's weight: the plan holds the (9, O, C) device shape, the
    provider is asked for the (O, C, 3, 3) file shape, its upload bytes are
    those of the weight, and the device copy is the relayout of the file."""
    from onnxstream_tpu_torch.kernels.gn_conv import oihw_to_w9
    from onnxstream_tpu_torch.runtime.executor import upload_bytes

    g, inputs = tiny
    s = _port(g, inputs, fuse_gn_conv=True, hbm_budget_bytes=64 << 10)
    ex = s._executor()
    moved = [w for w in ex.plan.arg_weights if w.transform]
    assert len(moved) == sum(op.op_type == "ostpu.gn_silu_conv" for op in s.graph.ops) > 0
    entries = {name: shape for name, _, shape in ex.plan.stream_entries()}
    for w in moved:
        o, c = w.file_shape[:2]
        assert w.transform == "t9oc" and w.shape == (9, o, c) and tuple(w.file_shape) == (o, c, 3, 3)
        assert tuple(entries[w.name]) == (o, c, 3, 3)
        assert upload_bytes(w) == g.weights[w.name].size * 4 and w.quant is None
        np.testing.assert_array_equal(ex._upload(w).numpy(), oihw_to_w9(g.weights[w.name]))
    # build_segments counts the transformed weight: only a single op may pass the budget
    assert all(seg.weight_bytes <= 64 << 10 or len(seg.op_indices) == 1 for seg in ex.segments)


def test_shared_cache_keys_a_transformed_weight_by_its_device_shape(tiny):
    g, inputs = tiny
    cache = {}
    fused = _port(g, inputs, fuse_gn_conv=True, shared_device_weight_cache=cache)
    plain = _port(g, inputs, shared_device_weight_cache=cache)
    w = next(w for w in fused._executor().plan.arg_weights if w.transform)
    for s in (fused, plain):
        _, key = s._executor()._cache_slot(next(a for a in s._executor().plan.arg_weights if a.name == w.name))
        assert key == w.name or key[1] == (w.shape if s is fused else tuple(w.file_shape))
    np.testing.assert_allclose(fused.run()["out_sample"], plain.run()["out_sample"], rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("route", ["groupnorm", "A"])
def test_vae_tiny_routes_match_jax(route):
    from onnxstream_tpu.models.sd.vae import VAE_TINY, build_vae_decoder

    g = build_vae_decoder(VAE_TINY, seed=7)
    inputs = {"latent": np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)}
    ps = _port(g, inputs, **ROUTES[route])
    got = next(iter(ps.run().values()))
    want = next(iter(_jax(g, inputs, pallas_interpret=True, **ROUTES[route]).run().values()))
    assert "InstanceNormalization" not in [op.op_type for op in ps.graph.ops]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, next(iter(_port(g, inputs).run().values())), rtol=5e-4, atol=5e-5)


def test_calibration_under_fuse_groupnorm_names_the_fused_ops():
    """Calibration keys its ranges by op name, so under a fusion the fused
    op's output range is recorded under the fused op's name, as in the JAX
    session: a calibrated decoder has to run under the options it was
    calibrated with. Same names, same ranges."""
    from onnxstream_tpu.models.sd.vae import VAE_TINY, build_vae_decoder

    g = build_vae_decoder(VAE_TINY, seed=7)
    inputs = {"latent": np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)}
    cfg = dict(range_data_calibrate=True, fuse_groupnorm=True)
    ps, js = _port(g, inputs, **cfg), _jax(g, inputs, **cfg)
    ps.run(eager=True), js.run(eager=True)
    pr, jr = ps._executor().range_data.data, js._executor().range_data.data
    assert sorted(pr) == sorted(jr) and any(k.endswith("_gn_silu") for k in pr)
    for k, (lo, hi) in jr.items():
        np.testing.assert_allclose(pr[k], (lo, hi), rtol=1e-5, atol=1e-5 * max(abs(lo), abs(hi), 1.0))


def test_quantized_graph_keeps_its_uint8_convs_out_of_the_fusion(tiny):
    """A --quantize-uint8 graph under config A: uint8 conv weights are no
    float weights, so their chains go to ostpu.gn_silu and the conv stays on
    the quantized route; the same graph as the JAX passes give, and the same
    output."""
    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights

    g, inputs = tiny
    text, weights = quantize_graph_weights(g.to_text(), g.weights)
    ps = Session(SessionConfig(device=CPU, **ROUTES["A"]),
                 weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    js = JaxSession(JaxConfig(pallas_interpret=True, **ROUTES["A"]), weights_provider=JaxDict(weights))
    for s in (ps, js):
        s.read_string(text)
        for k, v in inputs.items():
            s.add_tensor(k, v)
    assert [(op.name, op.op_type) for op in ps.graph.ops] == [(op.name, op.op_type) for op in js.graph.ops]
    for op in ps.graph.ops:
        if op.op_type == "ostpu.gn_silu_conv":
            assert op.inputs[5].dtype.is_float
    got, want = ps.run()["out_sample"], js.run()["out_sample"]
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())

"""The UNet slice end to end: the port's Session against the JAX Session.

The TINY UNet graph and weights come from the JAX package's builder and go
through both Sessions on the CPU with the same seeded inputs. float32 must
agree to rtol = atol = 1e-4; bfloat16 to max|port - jax| <= 5e-2 * max|jax|.
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
    assert set(s.hbm_stats()) == {"weight_bytes"} and s.hbm_stats()["weight_bytes"] > 0


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


@pytest.mark.parametrize("name", ["fuse_gn_conv", "fuse_groupnorm", "use_pallas_smallconv"])
def test_unimplemented_options_raise(name):
    with pytest.raises(NotImplementedError):
        SessionConfig(device=CPU, **{name: True})
    s = Session(SessionConfig(device=CPU))
    with pytest.raises(NotImplementedError):
        s.set_option(name, True)
    s.set_option(name, False)  # the default is accepted


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
    s.read_string("t/sm:Softmax*input:a(2,3)*output:y(2,3)*axis:-1")
    s.add_tensor("a", np.ones((2, 3), np.float32))
    with pytest.raises(PlanError, match="Softmax"):
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

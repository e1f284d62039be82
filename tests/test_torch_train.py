"""The port's train path on one device: ``Executor.segment_fn`` and
``parallel.sharding.make_train_step``, against the JAX package on the CPU.

  * ``segment_fn(0)`` gives ``Session.run``'s output bit for bit (the TINY
    UNet, float32 and bf16);
  * the loss and every gradient of one step on one device against
    ``jax.value_and_grad`` over JAX's ``Executor._segment_fn(0)``: the loss
    within rtol 1e-6, each gradient within 5e-4 * max|g_jax| of its tensor,
    NaN on the same 21 weights (the exponent 2 of each LayerNorm's
    (x - mean)^2, d(x^y)/dy = x^y ln x, NaN for x < 0, in both packages);
  * the step's AdamW update against optax's (JAX ``make_train_step`` on a
    one-device mesh);
  * the refusals: a plan that routes an op to a hand-written kernel (no
    kernel has a backward) names the option to turn off, and a plan of
    several segments is refused as JAX asserts.

The sharded steps run on ``tests/test_torch_sharded.py``'s spawned groups.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnxstream_tpu.models.sd.unet import TINY as JAX_TINY
from onnxstream_tpu.models.sd.unet import build_unet as jax_build_unet
from onnxstream_tpu.parallel.sharding import make_mesh as jax_make_mesh
from onnxstream_tpu.parallel.sharding import make_train_step as jax_make_train_step
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch.parallel.dryrun import _session, tiny_unet, tiny_unet_inputs, train_case
from onnxstream_tpu_torch.parallel.sharding import kernel_routes, make_train_step

CPU = torch.device("cpu")
POW_EXPONENTS = 21  # the LayerNorm (x - mean)^2 exponents of the TINY UNet


def _jax_executor(g, inputs):
    s = JaxSession(config=JaxConfig(compute_dtype="float32"), weights_provider=JaxDict(g.weights))
    s.read_string(g.to_text())
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s._executor()


def _jax_weights(ex):
    return [np.asarray(ex.provider.get(w.name, w.file_dtype, w.shape)).astype(np.float32)
            for w in ex.plan.arg_weights]


@pytest.fixture(scope="module")
def tiny():
    """The TINY UNet at batch 2 (context 7) for both packages, and its inputs."""
    text, weights = tiny_unet(2)
    return text, weights, tiny_unet_inputs(2), jax_build_unet(JAX_TINY, batch=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_fn_is_session_run(tiny, dtype):
    text, weights, inputs, _ = tiny
    s = _session(text, weights, inputs, CPU, compute_dtype=dtype)
    want = s.run()["out_sample"]
    ex = s._executor()
    assert len(ex.segments) == 1
    assert [w.name for w in ex.segments[0].weight_args] == [w.name for w in ex.plan.arg_weights]
    held = ex._fetch_segment_weights(ex.segments[0])  # the resident weights of the run
    out = ex.segment_fn(0)([held[w.name] for w in ex.plan.arg_weights], inputs)
    assert set(out) == {"out_sample"}
    assert out["out_sample"].dtype == ex.config.torch_compute_dtype
    np.testing.assert_array_equal(out["out_sample"].float().numpy(), want)


def test_segment_fn_chains_the_segments_of_a_budgeted_plan(tiny):
    """Each segment of a streamed plan as a function, segment 0 on the graph
    inputs and the later ones on the boundary tensors the earlier ones
    return: the fetched output is Session.run's, bit for bit."""
    text, weights, inputs, _ = tiny
    s = _session(text, weights, inputs, CPU, use_flash_attention=False, hbm_budget_bytes=1 << 16)
    want = s.run()["out_sample"]
    ex = s._executor()
    assert len(ex.segments) > 2
    env, out = dict(inputs), {}
    for si, seg in enumerate(ex.segments):
        later = {n for nxt in ex.segments[si + 1:] for n in nxt.in_names}
        held = {w.name: ex._upload(w) for w in seg.weight_args}
        out = ex.segment_fn(si, also=sorted(later & set(seg.out_names)))([held[w.name] for w in seg.weight_args], env)
        env.update(out)
    np.testing.assert_array_equal(out["out_sample"].float().numpy(), want)


def _assert_grads_close(names, got, want, bar=5e-4):
    """Per tensor: NaN in the same places, else within bar * max|want|."""
    nan = set()
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        if np.isnan(w).any() or np.isnan(g).any():
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
            nan.add(name)
            w, g = np.nan_to_num(w), np.nan_to_num(g)
        np.testing.assert_allclose(g, w, rtol=0, atol=bar * np.abs(w).max(), err_msg=name)
    return nan


def test_loss_and_gradients_match_jax_value_and_grad(tiny):
    text, weights, inputs, g = tiny
    target = np.zeros((2, 4, 16, 16), np.float32)
    got = train_case(0, CPU, text, weights, inputs, None, target=target)
    jex = _jax_executor(g, inputs)
    assert [w.name for w in jex.plan.arg_weights] == got["names"]
    fn = jex._segment_fn(0)

    def loss_fn(ws):
        return jnp.mean(jnp.square(fn(ws, inputs)["out_sample"].astype(jnp.float32) - target))

    loss, grads = jax.value_and_grad(loss_fn)(_jax_weights(jex))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
    nan = _assert_grads_close(got["names"], [got["grads"][n] for n in got["names"]], grads)
    assert len(nan) == POW_EXPONENTS
    text_pows = {line.split("*input:")[1].split(";")[1].split("(")[0] for line in text.splitlines()
                 if line.split(":")[1].startswith("Pow*")}
    assert nan <= text_pows, "only the Pow exponents take a NaN gradient"


def test_one_device_step_matches_optax(tiny):
    """JAX's make_train_step on a one-device mesh: the loss, the updated
    weights and optax's first and second moments."""
    text, weights, inputs, g = tiny
    got = train_case(0, CPU, text, weights, inputs, None)
    jex = _jax_executor(g, inputs)
    mesh = jax_make_mesh(1, dp=1, tp=1)
    step, init, _ = jax_make_train_step(jex, "out_sample", mesh)
    with mesh:
        ws, state = init(_jax_weights(jex))
        ws, state, loss = step(ws, state, {k: np.asarray(v) for k, v in inputs.items()},
                               np.zeros((2, 4, 16, 16), np.float32))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
    adam = state[0]
    names = got["names"]
    _assert_grads_close(names, [got["exp_avg"][n] for n in names], [np.asarray(m) for m in adam.mu])
    _assert_grads_close(names, [got["exp_avg_sq"][n] for n in names], [np.asarray(v) for v in adam.nu], 1e-3)
    for name, w_jax, mu in zip(names, ws, adam.mu):
        assert_updated_weights_close(name, got["weights"][name], np.asarray(w_jax), np.asarray(mu) / 0.1)


def assert_updated_weights_close(name, got, want, grad_jax, lr=1e-4, eps=1e-8):
    """One AdamW step moves a weight by lr * g / (|g| + eps) (plus the
    decay): within 1e-6 where the step is settled, |g| > 1e-6 * max|g| and
    |g| > 10 eps; where |g| is near eps the step swings with the gradient's
    last bits (lr eps / (|g| + eps)^2 per unit of g) and is held to 2 lr.
    NaN in the same places."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    g = np.nan_to_num(np.abs(grad_jax))
    settled = (g > 1e-6 * g.max()) & (g > 10 * eps)
    diff = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    assert not settled.any() or diff[settled].max() <= 1e-6, (name, diff[settled].max())
    assert diff.max() <= 2 * lr, (name, diff.max())


def _planned(text, weights, inputs, **config):
    s = _session(text, weights, inputs, CPU, **config)
    return s._executor()


def _mm_graph():
    """x (4, 64) @ W (64, 32), a weight the 8-bit routes take."""
    rng = np.random.RandomState(0)
    text = "mm:MatMul*input:x(4,64);w.bin(float32:64,32)*output:y(4,32)\n"
    return text, {"w.bin": rng.randn(64, 32).astype(np.float32)}, {"x": rng.randn(4, 64).astype(np.float32)}


def _conv_graph():
    """A 3 x 3 conv the small-conv route takes (C = O = 128, 8 x 8)."""
    from onnxstream_tpu_torch.convert.builder import GraphBuilder

    gb = GraphBuilder(seed=7)
    gb.conv(gb.input("x", (2, 128, 8, 8)), 128, k=3)
    return gb.to_text(), dict(gb.weights), {"x": np.random.RandomState(1).randn(2, 128, 8, 8).astype(np.float32)}


ROUTES = {
    "use_flash_attention": ("unet", dict(use_flash_attention=True), "ostpu.sdpa (use_flash_attention)"),
    "fuse_groupnorm": ("unet", dict(fuse_groupnorm=True), "ostpu.gn_silu (fuse_groupnorm)"),
    "fuse_gn_conv": ("unet", dict(fuse_gn_conv=True), "ostpu.gn_silu_conv (fuse_gn_conv)"),
    "use_pallas_smallconv": ("conv", dict(use_pallas_smallconv=True),
                             "ostpu.conv3x3_im2col (use_pallas_smallconv)"),
    "use_nhwc_layout": ("unet", dict(use_nhwc_layout=True), "the ohwi upload layout (use_nhwc_layout"),
    "use_w8_matmul": ("mm", dict(force_uint8_storage_set={"w.bin"}), "w8_matmul (use_w8_matmul)"),
    "use_w8a8_dyn_matmul": ("mm", dict(force_uint8_storage_set={"w.bin"}, int8_symmetric_storage=True),
                            "w8a8_dyn_matmul (use_w8a8_dyn_matmul)"),
    # 8-bit weights that no kernel takes, dequantized on read: a float32 leaf
    # cast to uint8 would be truncated and lose its gradient
    "force_uint8_storage_set_conv": ("conv", dict(force_uint8_storage_set={"conv_1.weight_nchw.bin"}),
                                     "integer storage of conv_1.weight_nchw.bin (force_uint8_storage_set"),
    "force_uint8_storage_set_matmul": ("mm", dict(force_uint8_storage_set={"w.bin"}, use_w8_matmul=False),
                                       "integer storage of w.bin (force_uint8_storage_set"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_step_refuses_kernel_routes(tiny, route):
    """Each kernel route raises, naming its option; the same plan with the
    option off trains."""
    graph, options, names = ROUTES[route]
    text, weights, inputs = (tiny[0], tiny[1], tiny[2]) if graph == "unet" else {"mm": _mm_graph,
                                                                                  "conv": _conv_graph}[graph]()
    off = {"use_flash_attention": False} if graph == "unet" else {}
    ex = _planned(text, weights, inputs, **{**off, **options})
    if route.startswith("force_uint8_storage_set"):
        assert ex.quant_routes == {} and all(w.transform is None for w in ex.plan.arg_weights)
    assert any(names in r for r in kernel_routes(ex))
    with pytest.raises(ValueError, match=re.escape(names)):
        make_train_step(ex, ex.plan.fetch_names[0], None)
    ex_off = _planned(text, weights, inputs, **off)
    assert kernel_routes(ex_off) == []
    step, init, placements = make_train_step(ex_off, ex_off.plan.fetch_names[0], None)
    assert placements == [[] for _ in ex_off.plan.arg_weights]


def test_train_step_refuses_several_segments(tiny):
    text, weights, inputs, _ = tiny
    ex = _planned(text, weights, inputs, use_flash_attention=False, hbm_budget_bytes=1 << 16)
    assert len(ex.segments) > 1
    with pytest.raises(ValueError, match="single-segment"):
        make_train_step(ex, "out_sample", None)

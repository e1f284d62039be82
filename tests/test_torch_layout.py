"""The port's channel-last layout pass (runtime/layout.py) and the ops it
emits, against the JAX package.

Every case of tests/test_layout.py is mirrored: the port's ``rewrite_nhwc``
output equals the JAX pass's op for op (type, name, attributes, every input
and output spec) on the TINY UNet, the VAE_TINY decoder and the pool /
resize / concat, split / global-pool, fallback and extra-output graphs, and
the channel-last graphs run through both Sessions on the CPU to float32
atol 1e-4. ``ostpu.groupnorm`` is held to the JAX op at 1e-5 in float32 and
1e-2 in bfloat16. The graphs and weights come from the JAX package's
builder.
"""

import collections
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from onnxstream_tpu.convert.builder import GraphBuilder
from onnxstream_tpu.ir import OpNode as JaxOpNode
from onnxstream_tpu.ir import TensorSpec as JaxTensorSpec
from onnxstream_tpu.ir import parse_model_txt as jax_parse
from onnxstream_tpu.models.sd.unet import TINY, build_unet
from onnxstream_tpu.models.sd.vae import VAE_TINY, build_vae_decoder
from onnxstream_tpu.ops import Ctx as JaxCtx
from onnxstream_tpu.ops import get_impl as jax_get_impl
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.layout import rewrite_nhwc as jax_rewrite_nhwc
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.ir import OpNode, TensorSpec, parse_model_txt
from onnxstream_tpu_torch.ops import Ctx, get_impl
from onnxstream_tpu_torch.runtime.layout import rewrite_nhwc
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")


def _spec(t):
    return (t.name, tuple(t.shape), t.dtype.value, t.transform,
            None if t.file_shape is None else tuple(t.file_shape))


def _ops(graph):
    return [(op.name, op.op_type, dict(op.attrs), [_spec(t) for t in op.inputs], [_spec(t) for t in op.outputs])
            for op in graph.ops]


def _same_ops(port_graph, jax_graph):
    got, want = _ops(port_graph), _ops(jax_graph)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == b


def _both(g, inputs, extra=(), **cfg):
    """The builder graph through the port's Session (CPU) and the JAX Session
    under the same config; returns (port session, port outputs, jax session,
    jax outputs)."""
    ps = Session(SessionConfig(device=CPU, **cfg), weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    js = JaxSession(JaxConfig(**cfg), weights_provider=JaxDict(dict(g.weights)))
    outs = []
    for s in (ps, js):
        s.read_string(g.to_text())
        for name in extra:
            s.add_extra_output(name)
        for k, v in inputs.items():
            s.add_tensor(k, v)
        outs.append({k: np.asarray(v, np.float32) for k, v in s.run().items()})
    return ps, outs[0], js, outs[1]


def _unet_inputs():
    rng = np.random.RandomState(0)
    return {
        "sample": rng.rand(1, 4, 16, 16).astype(np.float32),
        "timestep": np.array([500.0], np.float32),
        "encoder_hidden_states": rng.rand(1, 7, 32).astype(np.float32),
    }


def test_tiny_unet_rewrite_equals_jax():
    g = build_unet(TINY)
    inputs = _unet_inputs()
    ps0, base, _, _ = _both(g, inputs, use_nhwc_layout=False)
    ps, out, js, jout = _both(g, inputs, use_nhwc_layout=True)
    _same_ops(ps.graph, js.graph)
    np.testing.assert_allclose(out["out_sample"], jout["out_sample"], atol=1e-4)
    np.testing.assert_allclose(out["out_sample"], base["out_sample"], atol=1e-4)

    c = collections.Counter(op.op_type for op in ps.graph.ops)
    assert c["ostpu.groupnorm"] > 0, "GroupNorm clusters must fuse"
    assert c["ostpu.reshape"] > 0, "to_seq/to_sp boundaries must merge"
    convs = [op for op in ps.graph.ops if op.op_type == "Conv"]
    assert convs and all(op.attr("layout") == "NHWC" for op in convs)
    tr = [op for op in ps.graph.ops if op.op_type == "Transpose"]
    boundary = [op for op in tr if op.name.endswith("_tonhwc") or op.name.endswith("_tonchw")]
    assert len(boundary) == 2  # sample in, out_sample out
    # every channel-last Conv weight is uploaded channels-last, read by that Conv alone
    ex = ps._executor()
    conv_weights = {op.inputs[1].name for op in convs}
    assert {w.name for w in ex.plan.arg_weights if w.transform == "ohwi"} == conv_weights


def test_vae_decoder_rewrite_equals_jax():
    g = build_vae_decoder(VAE_TINY)
    z = np.random.RandomState(4).randn(1, 4, 8, 8).astype(np.float32)
    ps, out, js, jout = _both(g, {"latent": z}, use_nhwc_layout=True)
    _same_ops(ps.graph, js.graph)
    _, base, _, _ = _both(g, {"latent": z})
    for k in out:
        np.testing.assert_allclose(out[k], jout[k], atol=1e-4)
        np.testing.assert_allclose(out[k], base[k], atol=1e-4)
    assert any(op.op_type == "Resize" and op.attr("layout") == "NHWC" for op in ps.graph.ops)


@pytest.mark.parametrize("cfg", [
    dict(use_nhwc_layout=False),
    dict(use_nchw_convs=True),
    dict(use_uint8_arithmetic=True),
    dict(use_uint8_qdq=True),
    dict(range_data_calibrate=True),
])
def test_pass_disabled_modes(cfg):
    """The pass is off under the same options as the JAX pass. The port has
    no use_nchw_convs field; the pass reads it with getattr, so a config
    object that carries it turns the pass off too."""
    text = build_unet(TINY).to_text()
    if "use_nchw_convs" in cfg:
        config = types.SimpleNamespace(use_nhwc_layout=True, **cfg)
    else:
        config = SessionConfig(device=CPU, **{"use_nhwc_layout": True, **cfg})
    graph = rewrite_nhwc(parse_model_txt(text), config)
    assert all(op.attr("layout") is None for op in graph.ops)
    assert len(graph.ops) == len(jax_rewrite_nhwc(jax_parse(text), JaxConfig(**{"use_nhwc_layout": True, **cfg})).ops)


def _pool_resize_graph():
    g = GraphBuilder(seed=3)
    x = g.input("x", (1, 8, 12, 12))
    y = g.conv(x, 16, 3, name="c1")
    y = g.emit("MaxPool", [y], [(1, 16, 6, 6)],
               {"kernel_shape": "2,2", "strides": "2,2", "pads": "0,0,0,0"}, name="mp")
    y = g.emit("AveragePool", [y], [(1, 16, 3, 3)],
               {"kernel_shape": "2,2", "strides": "2,2", "pads": "0,0,0,0"}, name="ap")
    y = g.emit("Resize", [y, None, g.weight("sc", np.array([1, 1, 4, 4], np.float32))],
               [(1, 16, 12, 12)],
               {"coordinate_transformation_mode": "asymmetric", "mode": "nearest",
                "nearest_mode": "floor"}, name="rs")
    y = g.concat([y, g.conv(x, 4, 1, pad=0, name="c2")], axis=1, name="cat")
    g.emit("Sigmoid", [y], [y.shape], name="sig", out_names=["out"])
    return g


def test_pool_resize_concat_nhwc():
    """Conv -> MaxPool -> AveragePool -> Resize(nearest 4x) -> Concat(skip)."""
    g = _pool_resize_graph()
    inputs = {"x": np.random.RandomState(1).rand(1, 8, 12, 12).astype(np.float32)}
    _, base, _, _ = _both(g, inputs, use_nhwc_layout=False)
    s, out, js, jout = _both(g, inputs, use_nhwc_layout=True)
    _same_ops(s.graph, js.graph)
    np.testing.assert_allclose(out["out"], base["out"], atol=1e-5)
    np.testing.assert_allclose(out["out"], jout["out"], atol=1e-4)
    kinds = {op.op_type: op for op in s.graph.ops}
    assert kinds["MaxPool"].attr("layout") == "NHWC"
    assert kinds["AveragePool"].attr("layout") == "NHWC"
    assert kinds["Resize"].attr("layout") == "NHWC"
    assert kinds["Concat"].attr("axis") == "3"


def test_split_and_global_pool_nhwc():
    g = GraphBuilder(seed=5)
    x = g.input("x", (1, 6, 8, 8))
    y = g.conv(x, 8, 3, name="c")
    a, b = g.split(y, [4, 4], axis=1)
    z = g.emit("GlobalAveragePool", [a], [(1, 4, 1, 1)], name="gap")
    w = g.add(b, z, out_shape=(1, 4, 8, 8), name="bcast")
    g.emit("Relu", [w], [w.shape], name="r", out_names=["out"])
    inputs = {"x": np.random.RandomState(2).rand(1, 6, 8, 8).astype(np.float32)}
    _, base, _, _ = _both(g, inputs, use_nhwc_layout=False)
    s, out, js, jout = _both(g, inputs, use_nhwc_layout=True)
    _same_ops(s.graph, js.graph)
    np.testing.assert_allclose(out["out"], base["out"], atol=1e-5)
    np.testing.assert_allclose(out["out"], jout["out"], atol=1e-4)
    kinds = {op.op_type: op for op in s.graph.ops}
    assert kinds["Split"].attr("axis") == "3"
    assert kinds["GlobalAveragePool"].attr("layout") == "NHWC"


def test_unhandled_op_falls_back():
    """A spatial Slice between convs (unhandled by the pass) forces a clean
    NCHW round-trip."""
    g = GraphBuilder(seed=7)
    x = g.input("x", (1, 4, 8, 8))
    y = g.conv(x, 8, 3, name="c1")
    y = g.emit(
        "Slice",
        [y, g.weight("st", np.array([1], np.int64)), g.weight("en", np.array([7], np.int64)),
         g.weight("ax", np.array([2], np.int64))],
        [(1, 8, 6, 8)], name="sl")
    y = g.conv(y, 8, 3, name="c2")
    g.emit("Relu", [y], [y.shape], name="r", out_names=["out"])
    inputs = {"x": np.random.RandomState(3).rand(1, 4, 8, 8).astype(np.float32)}
    _, base, _, _ = _both(g, inputs, use_nhwc_layout=False)
    s, out, js, jout = _both(g, inputs, use_nhwc_layout=True)
    _same_ops(s.graph, js.graph)
    np.testing.assert_allclose(out["out"], base["out"], atol=1e-5)
    np.testing.assert_allclose(out["out"], jout["out"], atol=1e-4)
    sl = next(op for op in s.graph.ops if op.op_type == "Slice")
    assert sl.attr("layout") is None
    assert all(op.attr("layout") == "NHWC" for op in s.graph.ops if op.op_type == "Conv")


def test_fused_ops_fall_back_to_nchw():
    """The port's fused ops (ostpu.gn_silu, ostpu.gn_silu_conv,
    ostpu.conv3x3_im2col) are unknown to the pass: every tagged tensor is
    transposed back to NCHW in front of them, and the outputs stay the NCHW
    run's."""
    g = build_unet(TINY)
    inputs = _unet_inputs()
    for cfg in (dict(fuse_gn_conv=True, fuse_groupnorm=True), dict(use_pallas_smallconv=True, fuse_groupnorm=True)):
        ps = Session(SessionConfig(device=CPU, use_nhwc_layout=True, **cfg),
                     weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
        base = Session(SessionConfig(device=CPU, **cfg), weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
        for s in (ps, base):
            s.read_string(g.to_text())
            for k, v in inputs.items():
                s.add_tensor(k, v)
        fused = [op for op in ps.graph.ops if op.op_type.startswith(("ostpu.gn_silu", "ostpu.conv3x3"))]
        assert fused and all(t.name not in {o.outputs[0].name for o in ps.graph.ops
                                            if o.attr("layout") == "NHWC"} for op in fused for t in op.inputs)
        assert any(op.attr("layout") == "NHWC" for op in ps.graph.ops)
        np.testing.assert_allclose(ps.run()["out_sample"], base.run()["out_sample"], atol=1e-4)


def test_extra_output_in_the_channel_last_region():
    """An extra output naming a mid-graph NHWC-tagged tensor still fetches in
    its original NCHW shape, in both packages."""
    g = build_unet(TINY)
    target = next(op.outputs[0].name for op in g.ops
                  if op.op_type == "Conv" and op.name == "down0/res0/conv1")
    ps, out, js, jout = _both(g, _unet_inputs(), extra=[target], use_nhwc_layout=True)
    _same_ops(ps.graph, js.graph)
    _, base, _, _ = _both(g, _unet_inputs(), extra=[target], use_nhwc_layout=False)
    assert out[target].shape == base[target].shape == jout[target].shape
    np.testing.assert_allclose(out[target], base[target], atol=1e-4)
    np.testing.assert_allclose(out[target], jout[target], atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_matches_oracle_and_jax(dtype):
    rng = np.random.RandomState(0)
    n, c, h, w, groups = 2, 12, 5, 4, 3
    x = rng.randn(n, c, h, w).astype(np.float32)
    scale = rng.rand(groups).astype(np.float32) + 0.5
    bias = rng.randn(groups).astype(np.float32)
    xr = x.reshape(n, groups, -1)
    mu, var = xr.mean(-1, keepdims=True), xr.var(-1, keepdims=True)
    ref = ((xr - mu) / np.sqrt(var + 1e-5) * scale[None, :, None] + bias[None, :, None]).reshape(n, c, h, w)

    attrs = {"groups": str(groups), "epsilon": "1e-05", "layout": "NHWC"}
    x_nhwc = x.transpose(0, 2, 3, 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.dtype(ml_dtypes.bfloat16)
    jop = JaxOpNode("gn", "ostpu.groupnorm", [JaxTensorSpec("x"), JaxTensorSpec("s"), JaxTensorSpec("b")],
                    [JaxTensorSpec("y")], attrs)
    want = np.asarray(jax_get_impl("ostpu.groupnorm").fn(
        JaxCtx(jnp, "device", JaxConfig(), "gn"), jop,
        [jnp.asarray(x_nhwc).astype(jdt), jnp.asarray(scale), jnp.asarray(bias)])[0].astype(jnp.float32))
    op = OpNode("gn", "ostpu.groupnorm", [TensorSpec("x"), TensorSpec("s"), TensorSpec("b")],
                [TensorSpec("y")], attrs)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = get_impl("ostpu.groupnorm").fn(Ctx("device", SessionConfig(device=CPU), "gn"), op,
                                         [torch.from_numpy(x_nhwc.copy()).to(tdt), torch.from_numpy(scale),
                                          torch.from_numpy(bias)])[0]
    assert got.dtype == tdt and tuple(got.shape) == (n, h, w, c)
    got = got.float().numpy()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(got.transpose(0, 3, 1, 2), ref, atol=2e-5)


def test_layout_ops_raise_on_shapes_they_cannot_take():
    op = OpNode("gn", "ostpu.groupnorm", [TensorSpec("x"), TensorSpec("s"), TensorSpec("b")],
                [TensorSpec("y")], {"groups": "5", "layout": "NHWC"})
    ctx = Ctx("device", SessionConfig(device=CPU), "gn")
    with pytest.raises(ValueError, match="multiple of groups"):
        get_impl("ostpu.groupnorm").fn(ctx, op, [torch.ones(1, 2, 2, 12), torch.ones(5), torch.zeros(5)])
    rs = OpNode("r", "ostpu.reshape", [TensorSpec("x")], [TensorSpec("y")], {"shape": "1,5"})
    with pytest.raises(RuntimeError):
        get_impl("ostpu.reshape").fn(ctx, rs, [torch.ones(1, 4)])
    mp = OpNode("mp", "MaxPool", [TensorSpec("x")], [TensorSpec("y")], {"kernel_shape": "2", "layout": "NHWC"})
    with pytest.raises(ValueError, match="4-D"):
        get_impl("MaxPool").fn(ctx, mp, [torch.ones(1, 4, 2)])

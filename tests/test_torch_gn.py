"""The GroupNorm routes: kernels 7 and 8's twins, the fusion passes and the upload transform.

``fuse_groupnorm`` and ``fuse_gn_conv`` of the port against the JAX package
on the CPU, inputs made from a seed with numpy:

  * the plain twins ``gn_silu_reference`` and ``gn_silu_conv_reference``
    against the JAX Pallas kernels in interpret mode and against the jnp
    references, at the JAX suite's own cases and bars (``tests/test_gn_silu.py``:
    2e-5 float32, 2e-2 bfloat16; ``tests/test_gn_conv.py``: 1e-5);
  * ``oihw_to_w9`` / ``w9_to_oihw`` / ``WEIGHT_TRANSFORMS["t9oc"]`` against
    the JAX ones;
  * the fused graphs op for op against the JAX passes' output on the TINY
    UNet, the VAE_TINY decoder and a gn -> silu -> conv chain graph, and the
    passes' selectivity (1 x 1, stride 2, a tied weight, an extra output
    inside a chain, a forced-uint8 weight stay decomposed);
  * ``gn_conv_problem``, the predicate that takes the place of the TPU
    kernel's VMEM block picker.

The CUDA kernels themselves are held against the twins by the ``gpu``-marked
tests (skipped without a card) and by ``chip_smoke.py``. Session-level parity
is in ``tests/test_torch_session.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnxstream_tpu.convert import builder as jax_graphs
from onnxstream_tpu.kernels import gn_conv as jax_gn_conv
from onnxstream_tpu.kernels import gn_silu as jax_gn_silu
from onnxstream_tpu.models.sd.unet import TINY as JAX_TINY
from onnxstream_tpu.models.sd.unet import build_unet as jax_build_unet
from onnxstream_tpu.models.sd.vae import VAE_TINY as JAX_VAE_TINY
from onnxstream_tpu.models.sd.vae import build_vae_decoder as jax_build_vae_decoder
from onnxstream_tpu.runtime import planner as jax_planner
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.ir import parse_model_txt
from onnxstream_tpu_torch.kernels.gn_conv import (
    gn_conv_problem,
    gn_silu_conv,
    gn_silu_conv_reference,
    oihw_to_w9,
    w9_to_oihw,
)
from onnxstream_tpu_torch.kernels.gn_silu import gn_silu, gn_silu_problem, gn_silu_reference
from onnxstream_tpu_torch.runtime import fusion
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
T = torch.from_numpy


def _bf16(a: np.ndarray) -> torch.Tensor:
    return T(a).to(torch.bfloat16)


# ------------------------------------------------------------- kernel 7's twin
def _gn_inputs(n, c, h, w, groups, seed=0):
    """The operands of tests/test_gn_silu.py ``_mk``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w).astype(np.float32)
    sg = (1.0 + 0.1 * rng.randn(groups)).astype(np.float32)
    sb = (0.05 * rng.randn(groups)).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    return x, sg, sb, gamma, beta


def _jax_gn_silu(oracle, args, groups, silu):
    if oracle == "pallas":
        return jax_gn_silu.gn_silu_pallas(*args, groups=groups, eps=1e-5, silu=silu, interpret=True)
    return jax_gn_silu.gn_silu_reference(*args, groups, 1e-5, silu)


GN_CASES = [
    (1, 64, 8, 8, 32, True),     # C/G = 2, tiny spatial
    (1, 320, 16, 16, 32, True),  # the SD1.5 channel count, C/G = 10
    (2, 40, 4, 4, 8, False),     # batch 2, no SiLU, C/G = 5
    (1, 24, 5, 7, 4, True),      # H W = 35
]


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
@pytest.mark.parametrize("n,c,h,w,groups,silu", GN_CASES)
def test_gn_silu_twin_matches_jax(n, c, h, w, groups, silu, oracle):
    arrs = _gn_inputs(n, c, h, w, groups)
    want = np.asarray(_jax_gn_silu(oracle, [jnp.asarray(a) for a in arrs], groups, silu))
    got = gn_silu(*[T(a) for a in arrs], groups, 1e-5, silu)  # a CPU tensor: the wrapper takes the twin
    assert got.dtype == torch.float32 and got.shape == (n, c, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert gn_silu.launches == 0


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_gn_silu_twin_bf16_matches_jax(oracle):
    x, *rest = _gn_inputs(1, 64, 8, 8, 32, seed=3)
    args = [jnp.asarray(x, jnp.bfloat16)] + [jnp.asarray(a) for a in rest]
    want = np.asarray(_jax_gn_silu(oracle, args, 32, True), np.float32)
    got = gn_silu_reference(_bf16(x), *[T(a) for a in rest], 32, 1e-5, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_gn_silu_twin_takes_the_graphs_affine_shape():
    """The converter stores gamma / beta as (C, 1, 1)."""
    x, sg, sb, gamma, beta = (T(a) for a in _gn_inputs(2, 40, 4, 4, 8))
    flat = gn_silu_reference(x, sg, sb, gamma, beta, 8, 1e-5, True)
    shaped = gn_silu_reference(x, sg, sb, gamma.reshape(40, 1, 1), beta.reshape(40, 1, 1), 8, 1e-5, True)
    assert torch.equal(flat, shaped)


@pytest.mark.parametrize("shape,groups,dtype,ok", [
    ((1, 320, 64, 64), 32, torch.bfloat16, True),
    ((1, 128, 512, 512), 32, torch.float16, True),
    ((2, 24, 5, 7), 4, torch.float32, True),
    ((1, 30, 8, 8), 4, torch.float32, False),      # C % G != 0
    ((1, 32, 8, 8), 8, torch.float64, False),      # no float64 kernel
    ((4, 32), 8, torch.float32, False),            # no spatial axis
])
def test_gn_silu_problem(shape, groups, dtype, ok):
    assert (gn_silu_problem(shape, groups, dtype) is None) == ok


# ------------------------------------------------------------- kernel 8's twin
def _conv_inputs(n, c, g, h, w, o, bias):
    """The operands of tests/test_gn_conv.py ``test_kernel_matches_oracle``."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, c, h, w).astype(np.float32)
    sg = rng.rand(g).astype(np.float32) + 0.5
    sb = rng.randn(g).astype(np.float32)
    gamma = rng.rand(c).astype(np.float32) + 0.5
    beta = rng.randn(c).astype(np.float32)
    wt = 0.1 * rng.randn(o, c, 3, 3).astype(np.float32)
    bv = rng.randn(o).astype(np.float32) if bias else None
    return x, sg, sb, gamma, beta, wt, bv


GN_CONV_CASES = [
    (2, 16, 4, 5, 7, 16, True),   # odd spatial: border masks on every edge
    (1, 32, 8, 8, 8, 24, False),  # no bias, O != C
    (1, 20, 4, 4, 4, 8, True),    # C/G = 5
]


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
@pytest.mark.parametrize("n,c,g,h,w,o,bias", GN_CONV_CASES)
def test_gn_silu_conv_twin_matches_jax(n, c, g, h, w, o, bias, oracle):
    x, sg, sb, gamma, beta, wt, bv = _conv_inputs(n, c, g, h, w, o, bias)
    jargs = [jnp.asarray(a) for a in (x, sg, sb, gamma, beta, jax_gn_conv.oihw_to_w9(wt))]
    jb = None if bv is None else jnp.asarray(bv)
    if oracle == "pallas":
        want = jax_gn_conv.gn_silu_conv_pallas(*jargs, jb, groups=g, eps=1e-5, interpret=True)
    else:
        want = jax_gn_conv.gn_silu_conv_reference(*jargs, jb, g, 1e-5)
    got = gn_silu_conv(*[T(a) for a in (x, sg, sb, gamma, beta, oihw_to_w9(wt))],
                       None if bv is None else T(bv), groups=g, eps=1e-5)
    assert got.shape == (n, o, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert gn_silu_conv.launches == 0


def test_gn_silu_conv_twin_bf16_matches_jax_reference():
    """bfloat16: the activated slab is rounded once, then float32 accumulation."""
    x, sg, sb, gamma, beta, wt, bv = _conv_inputs(1, 32, 8, 8, 8, 24, True)
    w9 = oihw_to_w9(wt)
    want = jax_gn_conv.gn_silu_conv_reference(
        jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(a) for a in (sg, sb, gamma, beta)],
        jnp.asarray(w9, jnp.bfloat16), jnp.asarray(bv), 8, 1e-5)
    got = gn_silu_conv_reference(_bf16(x), T(sg), T(sb), T(gamma), T(beta), _bf16(w9), T(bv), 8, 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_padding_is_zero_of_the_activated_tensor():
    """A constant slab normalises to beta everywhere: the border outputs see
    zeros outside the image, not SiLU(beta)."""
    c, o = 8, 4
    x = torch.full((1, c, 4, 4), 3.0)
    beta = torch.full((c,), 2.0)
    w9 = torch.ones(9, o, c)
    out = gn_silu_conv_reference(x, torch.ones(2), torch.zeros(2), torch.ones(c), beta, w9, None, 2, 1e-5)
    act = float(2.0 * torch.sigmoid(torch.tensor(2.0)))
    np.testing.assert_allclose(out[0, 0, 1, 1].item(), 9 * c * act, rtol=1e-5)  # interior: nine taps
    np.testing.assert_allclose(out[0, 0, 0, 0].item(), 4 * c * act, rtol=1e-5)  # corner: four taps


# ------------------------------------------------------------ upload transform
def test_w9_transforms_match_jax():
    wt = np.random.RandomState(1).randn(24, 16, 3, 3).astype(np.float32)
    w9 = oihw_to_w9(wt)
    np.testing.assert_array_equal(w9, jax_gn_conv.oihw_to_w9(wt))
    np.testing.assert_array_equal(w9_to_oihw(T(w9)).numpy(), wt)
    np.testing.assert_array_equal(w9_to_oihw(T(w9)).numpy(), np.asarray(jax_gn_conv.w9_to_oihw(jnp.asarray(w9))))
    got = WEIGHT_TRANSFORMS["t9oc"](T(wt))
    assert got.is_contiguous() and tuple(got.shape) == (9, 24, 16)
    np.testing.assert_array_equal(got.numpy(), jax_planner.WEIGHT_TRANSFORMS["t9oc"](wt))
    assert sorted(WEIGHT_TRANSFORMS) == sorted(jax_planner.WEIGHT_TRANSFORMS)


# ------------------------------------------------------------------ the passes
def _chain_graph():
    """tests/test_gn_conv.py ``_build_chain_graph``: gn -> silu -> conv3x3
    (fusable), gn -> silu -> conv1x1 and gn -> silu -> conv3x3 stride 2 (not)."""
    gb = jax_graphs.GraphBuilder(seed=11)
    x = gb.input("x", (2, 32, 8, 8))
    h = gb.conv(gb.silu(gb.group_norm(x, groups=8, name="gn1")), 32, k=3, name="conv1")
    h = gb.conv(gb.silu(gb.group_norm(h, groups=8, name="gn2")), 32, k=1, name="conv2")
    gb.conv(gb.silu(gb.group_norm(h, groups=8, name="gn3")), 32, k=3, stride=2, name="conv3")
    rng = np.random.RandomState(3)
    for nm in ("gn1", "gn2", "gn3"):
        gb.weights[nm + ".weight"] = rng.rand(32, 1, 1).astype(np.float32) + 0.5
        gb.weights[nm + ".bias"] = 0.3 * rng.randn(32, 1, 1).astype(np.float32)
        gb.weights[nm + ".inorm_scale"] = rng.rand(8).astype(np.float32) + 0.5
        gb.weights[nm + ".inorm_bias"] = 0.2 * rng.randn(8).astype(np.float32)
    return gb


GRAPHS = {
    "unet": lambda: jax_build_unet(JAX_TINY),
    "vae": lambda: jax_build_vae_decoder(JAX_VAE_TINY),
    "chain": _chain_graph,
}
ROUTES = {
    "groupnorm": dict(fuse_groupnorm=True),
    "gn_conv": dict(fuse_gn_conv=True),
    "both": dict(fuse_gn_conv=True, fuse_groupnorm=True),
}


def _spec(t):
    return (t.name, tuple(t.shape), t.dtype.value, t.transform,
            None if t.file_shape is None else tuple(t.file_shape))


def _ops_of(op):
    return (op.name, op.op_type, dict(op.attrs), [_spec(t) for t in op.inputs], [_spec(t) for t in op.outputs])


def _ops(graph):
    return [_ops_of(op) for op in graph.ops]


def _sessions(g, **cfg):
    ps = Session(SessionConfig(device=CPU, **cfg),
                 weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    js = JaxSession(JaxConfig(**cfg), weights_provider=JaxDict(dict(g.weights)))
    for s in (ps, js):
        s.read_string(g.to_text())
    return ps, js


def _tpu_gate(c, o, h, w, dtype, groups=1, n=1):
    """The JAX pass's one TPU-specific rule, its VMEM block picker, in the
    place of the port's predicate: with it the two passes must agree."""
    return None if jax_gn_conv._pick_bn(o, c, h * w, dtype.itemsize) else "no VMEM-feasible O block"


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fused_graph_equals_the_jax_passes(graph, route, monkeypatch):
    """Op for op: types, names, attributes, every input and output spec. The
    port's own predicate fuses more (test_port_predicate_fuses_what_the_tpu_gate_refuses),
    so the comparison runs the port's pass under the JAX gate."""
    monkeypatch.setattr(fusion, "gn_conv_problem", _tpu_gate)
    ps, js = _sessions(GRAPHS[graph](), **ROUTES[route])
    got, want = _ops(ps.graph), _ops(js.graph)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == b
    kinds = [op.op_type for op in ps.graph.ops]
    raw = [op.op_type for op in parse_model_txt(GRAPHS[graph]().to_text()).ops]
    n_chains = raw.count("InstanceNormalization")
    fused = kinds.count("ostpu.gn_silu") + kinds.count("ostpu.gn_silu_conv")
    assert fused > 0 and fused + kinds.count("InstanceNormalization") == n_chains
    if route != "gn_conv":
        assert "InstanceNormalization" not in kinds
    for op in ps.graph.ops:
        if op.op_type == "ostpu.gn_silu_conv":
            w = op.inputs[5]
            o, c = w.file_shape[0], w.file_shape[1]
            assert w.transform == "t9oc" and tuple(w.shape) == (9, o, c) and tuple(w.file_shape) == (o, c, 3, 3)


def test_port_predicate_fuses_what_the_tpu_gate_refuses():
    """The TINY UNet's conv_out has O = 4, which the TPU block picker refuses
    (no 8-multiple divisor); the CUDA kernel masks a ragged O, so the port
    fuses that chain too and everything else as the JAX pass does."""
    ps, js = _sessions(jax_build_unet(JAX_TINY), fuse_gn_conv=True)
    count = lambda s: sum(op.op_type == "ostpu.gn_silu_conv" for op in s.graph.ops)
    assert count(ps) == count(js) + 1
    extra = {op.name for op in ps.graph.ops} - {op.name for op in js.graph.ops}
    assert len(extra) == 1
    fused = next(op for op in ps.graph.ops if op.name in extra)
    assert fused.op_type == "ostpu.gn_silu_conv" and fused.inputs[5].shape[1] == 4
    shared = {op.name for op in js.graph.ops if op.op_type == "ostpu.gn_silu_conv"}
    port_ops = {op.name: op for op in ps.graph.ops}
    for op in js.graph.ops:
        if op.name in shared:
            assert _ops_of(port_ops[op.name]) == _ops_of(op)


def test_chain_graph_selectivity():
    """Only the 3 x 3 stride-1 conv absorbs its chain; the 1 x 1 and the
    stride-2 chains stay decomposed for fuse_gn_conv and go to ostpu.gn_silu
    under fuse_groupnorm."""
    ps, _ = _sessions(_chain_graph(), fuse_gn_conv=True)
    kinds = [op.op_type for op in ps.graph.ops]
    assert kinds.count("ostpu.gn_silu_conv") == 1 and kinds.count("InstanceNormalization") == 2
    fused = next(op for op in ps.graph.ops if op.op_type == "ostpu.gn_silu_conv")
    assert fused.name.endswith("_gn_silu_conv") and fused.outputs[0].name.startswith("conv1")
    assert len(fused.inputs) == 7 and fused.attrs["groups"] == "8"  # the bias is the 7th input
    ps, _ = _sessions(_chain_graph(), fuse_gn_conv=True, fuse_groupnorm=True)
    kinds = [op.op_type for op in ps.graph.ops]
    assert kinds.count("ostpu.gn_silu_conv") == 1 and kinds.count("ostpu.gn_silu") == 2
    assert all(op.attrs["silu"] == "1" for op in ps.graph.ops if op.op_type == "ostpu.gn_silu")


def _tied_weight_graph():
    gb = jax_graphs.GraphBuilder(seed=2)
    x = gb.input("x", (1, 16, 4, 4))
    h = gb.silu(gb.group_norm(x, groups=4, name="gn1"))
    wspec = gb.weight("wshared", gb.randn(16, 16, 3, 3))
    attrs = {"dilations": "1,1", "group": 1, "kernel_shape": "3,3", "pads": "1,1,1,1", "strides": "1,1"}
    c1 = gb.emit("Conv", [h, wspec], [(1, 16, 4, 4)], attrs, name="convA")
    c2 = gb.emit("Conv", [x, wspec], [(1, 16, 4, 4)], attrs, name="convB")
    gb.add(c1, c2)
    return gb


def test_tied_weight_is_not_relayouted():
    """A conv weight consumed by two ops cannot be relayouted for one."""
    ps, js = _sessions(_tied_weight_graph(), fuse_gn_conv=True)
    assert all(op.op_type != "ostpu.gn_silu_conv" for op in ps.graph.ops)
    assert _ops(ps.graph) == _ops(js.graph)


@pytest.mark.parametrize("route", ["groupnorm", "both"])
def test_extra_output_inside_a_chain_blocks_its_fusion(route, monkeypatch):
    monkeypatch.setattr(fusion, "gn_conv_problem", _tpu_gate)  # conv_out apart, see above
    g = jax_build_unet(JAX_TINY)
    inorm_out = next(op.outputs[0].name for op in parse_model_txt(g.to_text()).ops
                     if op.op_type == "InstanceNormalization")
    ps, js = _sessions(g, extra_outputs=[inorm_out], **ROUTES[route])
    kinds = [op.op_type for op in ps.graph.ops]
    assert kinds.count("InstanceNormalization") == 1  # that chain only
    assert _ops(ps.graph) == _ops(js.graph)


def test_forced_uint8_weight_is_left_to_the_quantized_route():
    gb = _chain_graph()
    wname = next(op.inputs[1].name for op in parse_model_txt(gb.to_text()).ops if op.name.startswith("conv1"))
    ps, js = _sessions(gb, fuse_gn_conv=True, force_uint8_storage_set={wname})
    assert all(op.op_type != "ostpu.gn_silu_conv" for op in ps.graph.ops)
    assert _ops(ps.graph) == _ops(js.graph)


@pytest.mark.parametrize("c,o,h,w,dtype,ok", [
    (320, 320, 64, 64, torch.bfloat16, True),
    (960, 640, 64, 64, torch.bfloat16, True),    # a slab the TPU kernel's VMEM plan refuses
    (320, 4, 64, 64, torch.bfloat16, True),      # conv_out: ragged O is masked in the kernel
    (128, 128, 512, 512, torch.float16, True),   # the VAE's largest slab
    (20, 8, 5, 7, torch.float32, True),
    (32, 32, 8, 8, torch.float64, False),
    (32, 0, 8, 8, torch.float32, False),
])
def test_gn_conv_problem(c, o, h, w, dtype, ok):
    assert (gn_conv_problem(c, o, h, w, dtype) is None) == ok


# ------------------------------------------------------- the kernels on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
@pytest.mark.parametrize("n,c,h,w,groups,silu", GN_CASES + [(1, 320, 64, 64, 32, True), (1, 128, 256, 256, 32, False)])
def test_gn_silu_kernel_matches_twin_on_card(n, c, h, w, groups, silu, dtype, tol):
    dev = _card()
    x, *rest = _gn_inputs(n, c, h, w, groups)
    args = [T(x).to(dev, dtype)] + [T(a).to(dev, dtype) for a in rest]
    before = gn_silu.launches
    got = gn_silu(*args, groups, 1e-5, silu)
    torch.cuda.synchronize()
    assert gn_silu.launches == before + 1
    want = gn_silu_reference(*args, groups, 1e-5, silu)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
@pytest.mark.parametrize("n,c,g,h,w,o,bias", GN_CONV_CASES + [(1, 320, 32, 64, 64, 320, True), (1, 320, 32, 64, 64, 4, True),
                                                             (2, 64, 8, 33, 17, 70, False)])
def test_gn_silu_conv_kernel_matches_twin_on_card(n, c, g, h, w, o, bias, dtype, tol):
    dev = _card()
    x, sg, sb, gamma, beta, wt, bv = _conv_inputs(n, c, g, h, w, o, bias)
    args = [T(a).to(dev, dtype) for a in (x, sg, sb, gamma, beta, oihw_to_w9(wt))]
    b = None if bv is None else T(bv).to(dev, dtype)
    before = gn_silu_conv.launches
    torch.backends.cudnn.allow_tf32 = False
    got = gn_silu_conv(*args, b, groups=g, eps=1e-5)
    torch.cuda.synchronize()
    assert gn_silu_conv.launches == before + 1
    want = gn_silu_conv_reference(*args, b, g, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * max(1.0, want.float().abs().max().item()))

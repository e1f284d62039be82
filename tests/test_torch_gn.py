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
    kernel's VMEM block picker;
  * kernel 7's ``gn_silu_problem`` and ``gn_silu_plan`` (K, the CTAs of a
    group's cluster, and what a CTA keeps resident): the pieces cover every
    group exactly at every ``ostpu.gn_silu`` site of the full-width SD1.5
    UNet (config B, config A) and VAE_SD (``fuse_groupnorm``, config A) and
    at the card tests' cases, which reach K = 1, 2, 4 and 8.

The CUDA kernels themselves are held against the twins by the ``gpu``-marked
tests of tests/test_torch_gn_card.py (skipped without a card), which also holds
the operands and cases shared with this module, and by ``chip_smoke.py``.
Session-level parity is in ``tests/test_torch_session.py``.
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
    gn_conv_plan,
    gn_conv_problem,
    gn_conv_variant,
    gn_silu_conv,
    gn_silu_conv_reference,
    oihw_to_w9,
    w9_to_oihw,
)
from onnxstream_tpu_torch.kernels.gn_silu import (
    CLUSTER_MAX,
    PIECE_RESIDENT_BYTES,
    RESIDENT_BYTES,
    gn_silu,
    gn_silu_pieces,
    gn_silu_plan,
    gn_silu_problem,
    gn_silu_reference,
)
from onnxstream_tpu_torch.runtime import fusion
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy
from test_torch_gn_card import GN_CASES, GN_CLUSTER_CASES, GN_CONV_CASES, GN_SITE_CASES, _conv_inputs, _gn_inputs

CPU = torch.device("cpu")
T = torch.from_numpy


def _bf16(a: np.ndarray) -> torch.Tensor:
    return T(a).to(torch.bfloat16)


# ------------------------------------------------------------- kernel 7's twin
def _jax_gn_silu(oracle, args, groups, silu):
    if oracle == "pallas":
        return jax_gn_silu.gn_silu_pallas(*args, groups=groups, eps=1e-5, silu=silu, interpret=True)
    return jax_gn_silu.gn_silu_reference(*args, groups, 1e-5, silu)


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
    ((1, 1, 32768, 32768), 1, torch.bfloat16, True),  # a 2^30-element group: past the moments pass's 65535 chunks
    ((1, 4096, 2, 2), 1, torch.float32, True),         # 4096 channels a group: the largest (A_c, B_c) table
    ((1, 8192, 2, 2), 1, torch.float32, False),        # 8192: the table would not fit beside the piece
    ((1, 2, 65536, 32768), 1, torch.bfloat16, False),  # a group of 2^32 elements: past 32-bit offsets
    ((1, 30, 8, 8), 4, torch.float32, False),      # C % G != 0
    ((1, 32, 8, 8), 8, torch.float64, False),      # no float64 kernel
    ((4, 32), 8, torch.float32, False),            # no spatial axis
])
def test_gn_silu_problem(shape, groups, dtype, ok):
    assert (gn_silu_problem(shape, groups, dtype) is None) == ok


def _assert_plan_covers(n, c, hw, groups, dtype):
    """The plan's pieces cover every group of x exactly, in rank order, none
    empty, and a CTA's shared memory stays within 227 KB; returns the plan."""
    plan = gn_silu_plan(n, c, hw, groups, dtype)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    length = c // groups * hw
    assert 1 <= plan.cluster <= CLUSTER_MAX == 16 and plan.cluster & (plan.cluster - 1) == 0
    assert plan.smem_bytes == plan.resident * 16 + -(-c // groups * 8 // 16) * 16
    assert plan.smem_bytes <= RESIDENT_BYTES <= 227 * 1024 and plan.resident * 16 <= PIECE_RESIDENT_BYTES
    for ng in range(n * groups):
        pieces = gn_silu_pieces(plan, length, ng * length, itemsize)
        assert len(pieces) == plan.cluster and pieces[0][0] == ng * length and pieces[-1][1] == (ng + 1) * length
        for (b, e, res), nxt in zip(pieces, pieces[1:] + [((ng + 1) * length,)]):
            assert b < e == nxt[0] and 0 <= res <= plan.resident and res * 16 <= (e - b) * itemsize
    return plan


def _streams(plan, n, c, hw, groups, dtype):
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return any(res * 16 < (e - b) * itemsize - 32 for b, e, res in gn_silu_pieces(plan, c // groups * hw, 0, itemsize))


def test_gn_silu_card_cases_reach_every_cluster_size():
    """The card tests' cases (tests/test_torch_gn_card.py) reach K = 1, 4, 8
    and 16 through the plan (K = 2 only through the forced plans of
    test_gn_silu_kernel_takes_every_cluster_size_on_card), a group that
    streams part of each piece, and K > 1 where groups start off a 16-byte
    boundary; every case's pieces cover its groups."""
    seen, streamed, ragged = set(), False, False
    for n, c, h, w, groups, _ in GN_CASES + GN_SITE_CASES + GN_CLUSTER_CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            plan = _assert_plan_covers(n, c, h * w, groups, dtype)
            seen.add(plan.cluster)
            streamed |= _streams(plan, n, c, h * w, groups, dtype)
            ragged |= plan.cluster > 1 and (c // groups * h * w * torch.empty(0, dtype=dtype).element_size()) % 16 != 0
    assert seen == {1, 4, 8, 16} and streamed and ragged


@pytest.mark.parametrize("n,c,h,w,groups", [(1, 24, 5, 7, 4), (3, 6, 1, 1, 3), (1, 2, 3, 5, 1), (2, 64, 17, 19, 32),
                                            (1, 4096, 1, 1, 1), (1, 9, 1024, 1024, 3), (1, 32, 4, 4, 32)])
def test_gn_silu_plan_covers_ragged_groups(n, c, h, w, groups):
    for dtype in (torch.float32, torch.bfloat16):
        _assert_plan_covers(n, c, h * w, groups, dtype)


def _fused_gn_sites(gb, routes):
    """(N, C, H, W, groups) of every ostpu.gn_silu of a full-width graph
    under these routes, the passes run in the session's order (weights left
    lazy: only shapes are read)."""
    raw = parse_model_txt(gb.to_text())
    cfg = SessionConfig(device=CPU, **routes)
    load = lambda name, dt, shape: np.asarray(gb.weights[name])
    g = fusion.fuse_groupnorm(fusion.rewrite_smallconv(fusion.fuse_gn_conv(raw, cfg, load), cfg, load), cfg, load)
    return [(*op.inputs[0].shape, int(op.attrs["groups"])) for op in g.ops if op.op_type == "ostpu.gn_silu"]


@pytest.mark.parametrize("model,routes,count", [
    ("SD15", dict(use_pallas_smallconv=True, fuse_groupnorm=True), 61),  # config B
    ("SD15", dict(fuse_gn_conv=True, fuse_groupnorm=True), 16),          # config A
    ("VAE_SD", dict(fuse_groupnorm=True), 30),
    ("VAE_SD", dict(fuse_gn_conv=True, fuse_groupnorm=True), 1),
])
def test_every_sd_gn_silu_site_has_a_plan(model, routes, count):
    """Every ostpu.gn_silu of the SD1.5 UNet and the SD VAE decoder at full
    width: the kernel takes it in bf16, and the plan's pieces cover each group
    exactly with a CTA's shared memory within 227 KB and K within the
    cluster limit; the UNet's 8 x 8 level keeps one CTA a group, the VAE's 1
    to 4 MB groups take 16, each CTA streaming the part of its piece past 32
    KB."""
    from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder

    gb = build_unet(SD15, lazy_weights=True) if model == "SD15" else build_vae_decoder(VAE_SD, lazy_weights=True)
    sites = _fused_gn_sites(gb, routes)
    assert len(sites) == count
    for n, c, h, w, groups in sites:
        assert gn_silu_problem((n, c, h, w), groups, torch.bfloat16) is None
        plan = _assert_plan_covers(n, c, h * w, groups, torch.bfloat16)
        if h * w <= 8 * 8:
            assert plan.cluster == 1
        if c // groups * h * w * 2 >= 2**20:
            assert plan.cluster == CLUSTER_MAX and _streams(plan, n, c, h * w, groups, torch.bfloat16)


# ------------------------------------------------------------- kernel 8's twin
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
    # the port adds upload forms of its own ("t9co", tests/test_torch_matmul.py)
    assert set(jax_planner.WEIGHT_TRANSFORMS) <= set(WEIGHT_TRANSFORMS)


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


# ------------------------------------------- kernel 8's variants at the SD sites
def _fused_conv_sites(gb):
    """(N, C, H, W, O) of every ostpu.gn_silu_conv that fuse_gn_conv makes
    of a full-width graph (weights left lazy: only shapes are read)."""
    raw = parse_model_txt(gb.to_text())
    cfg = SessionConfig(device=CPU, fuse_gn_conv=True, fuse_groupnorm=True)
    g = fusion.fuse_gn_conv(raw, cfg, lambda name, dt, shape: np.asarray(gb.weights[name]))
    return [(*op.inputs[0].shape, op.outputs[0].shape[1]) for op in g.ops if op.op_type == "ostpu.gn_silu_conv"]


@pytest.mark.parametrize("model,count", [("SD15", 45), ("VAE_SD", 29)])
def test_every_sd_gn_conv_site_takes_the_wgmma_variant(model, count):
    """All 45 chains of the SD1.5 UNet and all 29 of the SD VAE decoder fuse,
    and every one takes the wgmma variant in 16 bits (C a multiple of 64:
    whole k-tiles) with a plan that splits K only where the tiles leave SMs
    idle, never into an empty split; float32 keeps the FMA kernel."""
    from onnxstream_tpu_torch.kernels.matmul import SMS
    from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder

    gb = build_unet(SD15, lazy_weights=True) if model == "SD15" else build_vae_decoder(VAE_SD, lazy_weights=True)
    sites = _fused_conv_sites(gb)
    assert len(sites) == count
    for n, c, h, w, o in sites:
        assert c % 64 == 0 and gn_conv_problem(c, o, h, w, torch.bfloat16, 32, n) is None
        assert gn_conv_variant(torch.bfloat16, c, 0) == gn_conv_variant(torch.float16, c, 256) == "wgmma"
        assert gn_conv_variant(torch.float32, c, 0) == "fma"
        bm, splits = gn_conv_plan(n, c, h, w, o)
        nkt, tiles = 9 * c // 64, -(-o // bm) * -(-(n * h * w) // 128)
        per = -(-nkt // splits)
        assert bm in (64, 128) and (splits - 1) * per < nkt
        assert splits == 1 or (tiles * splits <= SMS and per >= 4)
        # split: the UNet's 32 x 32 and smaller levels and its conv_out (O = 4); never the VAE's
        assert (splits > 1) == (model == "SD15" and (h * w <= 32 * 32 or o < 64))


@pytest.mark.parametrize("dtype,c,w9_ptr,want", [
    (torch.bfloat16, 320, 0, "wgmma"),
    (torch.float16, 72, 4096, "wgmma"),   # C % 64 != 0: the last k-tile of a tap is zero past C
    (torch.bfloat16, 20, 0, "mma"),       # C % 8 != 0: a channel run is not whole 16-byte pieces
    (torch.bfloat16, 320, 2, "mma"),      # w9 off a 16-byte boundary
    (torch.float32, 320, 0, "fma"),       # full float32: wgmma has no float32 form
])
def test_gn_conv_variant_cases(dtype, c, w9_ptr, want):
    assert gn_conv_variant(dtype, c, w9_ptr) == want

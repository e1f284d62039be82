"""The small-conv route: kernel 9's twin, its plan, the im2col convolution and the Conv rewrite.

``matmul_reference`` and ``conv3x3_im2col`` of the port against the JAX
package on the CPU (``matmul_pallas`` / ``conv3x3_im2col_pallas`` in interpret
mode, and ``jnp.dot`` / ``lax.conv``), inputs made from a seed with numpy, at
the JAX suite's own cases and bars (``tests/test_matmul_kernel.py``: rtol 1e-5
/ atol 1e-4 sqrt(K / 128) for the product, 1e-4 for the conv, 2e-2 for a
bfloat16 output); ``matmul_supported`` against the JAX predicate; the ``t9co``
upload transform, the ``rewrite_smallconv`` pass and its exclusions;
``matmul_plan`` and ``matmul_variant`` at the SD1.5 sites; and a Session whose
``use_pallas_smallconv`` sends the eligible 3 x 3 convolutions through the
route, against the JAX session and the default path.

The CUDA kernel itself is held against the twin by the ``gpu``-marked tests
of tests/test_torch_matmul_card.py (skipped without a card), which also holds
the product cases shared with this module, and by ``chip_smoke.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnxstream_tpu.convert import builder as jax_graphs
from onnxstream_tpu.kernels import matmul as jax_matmul
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.kernels import matmul as port_matmul
from onnxstream_tpu_torch.kernels.matmul import (SMS, TILE_K, conv3x3_im2col, matmul, matmul_plan, matmul_reference,
                                                 matmul_supported, matmul_variant, oihw_to_w9co, smallconv_eligible)
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy
from test_torch_matmul_card import MATMUL_CASES

CPU = torch.device("cpu")
T = torch.from_numpy


def _bf16(a: np.ndarray) -> torch.Tensor:
    return T(a).to(torch.bfloat16)


@pytest.mark.parametrize("oracle", ["pallas", "dot"])
@pytest.mark.parametrize("m,k,n,bias", MATMUL_CASES)
def test_matmul_twin_matches_jax(m, k, n, bias, oracle):
    assert matmul_supported(m, k, n)
    rng = np.random.RandomState(0)
    a = rng.randn(m, k).astype(np.float32)
    b = (0.02 * rng.randn(k, n)).astype(np.float32)
    bv = rng.randn(n).astype(np.float32) if bias else None
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    if oracle == "pallas":
        want = jax_matmul.matmul_pallas(ja, jb, None if bv is None else jnp.asarray(bv),
                                        out_dtype=jnp.float32, interpret=True)
    else:
        want = jnp.dot(ja, jb, preferred_element_type=jnp.float32)
        if bias:
            want = want + jnp.asarray(bv)
    # a CPU tensor: the wrapper takes the twin
    got = matmul(_bf16(a), _bf16(b), None if bv is None else T(bv), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-5, atol=1e-4 * np.sqrt(k / 128))
    assert matmul.launches == 0


def test_matmul_twin_rounds_once_to_bf16():
    rng = np.random.RandomState(1)
    a, b = rng.randn(32, 256).astype(np.float32), rng.randn(256, 128).astype(np.float32)
    want = jax_matmul.matmul_pallas(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), interpret=True)
    got = matmul_reference(_bf16(a), _bf16(b))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
    # one rounding: equal to the float32 product rounded, not to a bf16 matmul of roundings
    exact = (_bf16(a).float() @ _bf16(b).float()).to(torch.bfloat16)
    assert torch.equal(got, exact)


@pytest.mark.parametrize("m,k,n", list(itertools.product((8, 16, 24, 35, 64, 1024, 1032, 2048), (128, 100, 11520), (128, 130))))
def test_matmul_supported_is_the_jax_predicate(m, k, n):
    assert matmul_supported(m, k, n) == jax_matmul.matmul_supported(m, k, n)


def test_matmul_refuses_what_does_not_chain():
    with pytest.raises(ValueError, match="do not chain"):
        matmul(torch.zeros(4, 8), torch.zeros(9, 4))
    with pytest.raises(TypeError):
        matmul(torch.zeros(4, 8), torch.zeros(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bias"):
        matmul(torch.zeros(4, 8), torch.zeros(8, 4), torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        matmul(torch.zeros(4, 8, device="meta"), torch.zeros(8, 4, device="meta"))


@pytest.mark.parametrize("oracle", ["pallas", "lax"])
@pytest.mark.parametrize("cin,cout,h,w,batch", [(128, 128, 8, 8, 2), (256, 128, 5, 7, 1)])
def test_conv3x3_im2col_matches_jax(cin, cout, h, w, batch, oracle):
    rng = np.random.RandomState(2)
    x = rng.randn(batch, h, w, cin).astype(np.float32)
    wt = (0.05 * rng.randn(cout, cin, 3, 3)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias)
    if oracle == "pallas":
        want = jax_matmul.conv3x3_im2col_pallas(jx, jw, jb, out_dtype=jnp.float32, interpret=True)
    else:
        dn = jax.lax.conv_dimension_numbers(jx.shape, jw.shape, ("NHWC", "OIHW", "NHWC"))
        want = jax.lax.conv_general_dilated(jx, jw, (1, 1), [(1, 1), (1, 1)], dimension_numbers=dn,
                                            preferred_element_type=jnp.float32) + jb
    got = conv3x3_im2col(T(x), oihw_to_w9co(T(wt)), T(bias), out_dtype=torch.float32)
    assert got.shape == (batch, h, w, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match=r"\(9 C, O\)"):
        conv3x3_im2col(T(x), T(wt), T(bias))  # the OIHW weight is relayouted at upload, not here


def test_t9co_transform_is_the_im2col_weight():
    wt = np.random.RandomState(3).randn(24, 16, 3, 3).astype(np.float32)
    got = WEIGHT_TRANSFORMS["t9co"](T(wt))
    assert got.is_contiguous() and tuple(got.shape) == (9 * 16, 24)
    np.testing.assert_array_equal(got.numpy(), wt.transpose(2, 3, 1, 0).reshape(9 * 16, 24))
    np.testing.assert_array_equal(oihw_to_w9co(T(wt)).numpy(), got.numpy())


# SD1.5 at 512 x 512: the (M, K, N) of the 34 convs use_pallas_smallconv reroutes in one UNet run
SD15_SITES = [(64, 11520, 1280), (64, 23040, 1280), (256, 5760, 1280), (256, 11520, 1280), (256, 17280, 1280),
              (256, 23040, 1280), (1024, 5760, 640), (1024, 11520, 640), (1024, 11520, 1280), (1024, 17280, 640)]


@pytest.mark.parametrize("m,k,n", SD15_SITES)
def test_matmul_plan_fills_the_card_at_the_sd15_sites(m, k, n):
    bm, bn, splits = matmul_plan(m, k, n)
    assert bm in (64, 128) and bn == 128 and splits >= 1
    nkt = -(-k // TILE_K)
    tiles = -(-m // bm) * -(-n // bn)
    per = -(-nkt // splits)
    assert (splits - 1) * per < nkt                      # no empty split
    assert tiles * splits <= SMS                         # one wave
    # at least 100 blocks, or as fine as a split goes, or no room for a second split (80 tiles of 128 rows)
    assert tiles * splits >= 100 or splits == nkt // 4 or SMS // tiles == 1
    assert per >= 4


@pytest.mark.parametrize("m,k,n,want", [
    (64, 11520, 1280, (64, 128, 13)),    # 10 tiles x 13 splits: 4.3 MB of partials against 29.5 MB of B
    (64, 23040, 1280, (64, 128, 13)),
    (1024, 5760, 640, (128, 128, 3)),
    (4096, 2880, 1280, (128, 128, 1)),   # 320 tiles fill the card: no split
    (4096, 2880, 320, (128, 128, 1)),    # 96 tiles of 128 rows in one wave, not 192 of 64 rows in two
    (1024, 11520, 1280, (128, 128, 1)),  # 80 tiles leave no room for a split: the taller tile, one wave
    (64, 64, 128, (64, 128, 1)),         # one k-tile cannot split
    (35, 100, 33, (64, 128, 1)),
])
def test_matmul_plan_cases(m, k, n, want):
    assert matmul_plan(m, k, n) == want
    bm, _, splits = want
    if (m, k, n) == (64, 11520, 1280):
        assert splits * m * n * 4 == 4_259_840  # workspace bytes


@pytest.mark.parametrize("dtype,m,k,n,a_ptr,b_ptr,want", [
    (torch.bfloat16, 64, 11520, 1280, 0, 0, "wgmma"),
    (torch.float16, 77, 16, 8, 256, 512, "wgmma"),
    (torch.bfloat16, 35, 100, 33, 0, 0, "mma"),       # ragged K and N
    (torch.bfloat16, 64, 128, 132, 0, 0, "mma"),      # N % 8 != 0
    (torch.bfloat16, 64, 124, 128, 0, 0, "mma"),      # K % 8 != 0
    (torch.bfloat16, 64, 128, 128, 2, 0, "mma"),      # a view that starts off a 16-byte boundary
    (torch.float16, 64, 128, 128, 0, 8, "mma"),
    (torch.float32, 64, 128, 128, 0, 0, "fma"),       # float32 stays full float32
])
def test_matmul_variant_is_a_function_of_dtype_shape_and_alignment(dtype, m, k, n, a_ptr, b_ptr, want):
    assert matmul_variant(dtype, m, k, n, a_ptr, b_ptr) == want


# ----------------------------------------------------------------- the session
def _smallconv_graph():
    """tests/test_matmul_kernel.py: an eligible conv (C = O = 128, H W = 64,
    s1 p1) and one whose O is no multiple of 128."""
    gb = jax_graphs.GraphBuilder(seed=7)
    x = gb.input("x", (2, 128, 8, 8))
    y = gb.conv(x, 128, k=3)
    gb.conv(y, 130, k=3)
    return gb


@pytest.fixture
def routed(monkeypatch):
    """Counts the convolutions the Conv op sends through conv3x3_im2col."""
    import onnxstream_tpu_torch.ops.standard as standard

    calls = []

    def spy(x, w, b=None, **kw):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return port_matmul.conv3x3_im2col(x, w, b, **kw)

    monkeypatch.setattr(standard, "conv3x3_im2col", spy)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_session_smallconv_matches_jax(routed, dtype):
    gb = _smallconv_graph()
    xv = np.random.RandomState(0).randn(2, 128, 8, 8).astype(np.float32)
    outs = {}
    for tag, cfg in (("default", {}), ("route", dict(use_pallas_smallconv=True))):
        s = Session(SessionConfig(device=CPU, compute_dtype=dtype, **cfg),
                    weights_provider=DictWeightsProvider(params_from_numpy(gb.weights)))
        s.read_string(gb.to_text())
        s.add_tensor("x", xv)
        outs[tag] = next(iter(s.run().values()))
        if tag == "route":
            outs["eager"] = next(iter(s.run(eager=True).values()))
    # the eligible conv only, NHWC in and the (9 C, O) weight, in run and in run_eager
    assert routed == [((2, 8, 8, 128), (9 * 128, 128))] * 2
    js = JaxSession(JaxConfig(use_pallas_smallconv=True, pallas_interpret=True, compute_dtype=dtype),
                    weights_provider=JaxDict(dict(gb.weights)))
    js.read_string(gb.to_text())
    js.add_tensor("x", xv)
    want = next(iter(js.run().values()))
    if dtype == "float32":
        np.testing.assert_allclose(outs["route"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(outs["route"], outs["default"], rtol=2e-4, atol=2e-4)
    else:
        top = float(np.abs(want).max())
        assert float(np.abs(outs["route"] - want).max()) <= 5e-2 * top
        assert float(np.abs(outs["route"] - outs["default"]).max()) <= 5e-2 * top
    np.testing.assert_array_equal(outs["eager"], outs["route"])


@pytest.mark.parametrize("attrs,shape", [
    (dict(stride=2), (2, 128, 8, 8)),      # stride 2
    (dict(k=1), (2, 128, 8, 8)),           # 1 x 1
    (dict(), (1, 128, 40, 40)),            # H W > 1024
    (dict(), (1, 96, 8, 8)),               # C % 128 != 0
    (dict(), (1, 128, 3, 3)),              # N H W % 8 != 0
])
def test_conv_gate_leaves_other_convs_alone(routed, attrs, shape):
    gb = jax_graphs.GraphBuilder(seed=1)
    x = gb.input("x", shape)
    gb.conv(x, 128, **{"k": 3, **attrs})
    s = Session(SessionConfig(device=CPU, use_pallas_smallconv=True),
                weights_provider=DictWeightsProvider(params_from_numpy(gb.weights)))
    s.read_string(gb.to_text())
    s.add_tensor("x", np.random.RandomState(0).randn(*shape).astype(np.float32))
    out = next(iter(s.run().values()))
    assert np.isfinite(out).all() and routed == []


def _plan_of(s):
    return next(iter(s._executors.values())).plan


def test_rewritten_conv_carries_the_upload_transform(routed):
    """The eligible conv becomes ostpu.conv3x3_im2col with a (9 C, O) weight
    that the executor relayouts at upload; the other conv stays a Conv. Also
    under a weight budget, where the transform runs at every fetch."""
    gb = _smallconv_graph()
    xv = np.random.RandomState(0).randn(2, 128, 8, 8).astype(np.float32)
    outs = {}
    for tag, cfg in (("resident", {}), ("streamed", dict(hbm_budget_bytes=700 << 10))):
        s = Session(SessionConfig(device=CPU, use_pallas_smallconv=True, **cfg),
                    weights_provider=DictWeightsProvider(params_from_numpy(gb.weights)))
        s.read_string(gb.to_text())
        assert [op.op_type for op in s.graph.ops] == ["ostpu.conv3x3_im2col", "Conv"]
        op = s.graph.ops[0]
        w = op.inputs[1]
        assert (w.transform, tuple(w.shape), tuple(w.file_shape)) == ("t9co", (9 * 128, 128), (128, 128, 3, 3))
        assert len(op.inputs) == 3 and op.inputs[2].is_weight  # the bias rides along
        s.add_tensor("x", xv)
        outs[tag] = next(iter(s.run().values()))
        outs[tag + "2"] = next(iter(s.run().values()))
        arg = next(a for a in _plan_of(s).arg_weights if a.name == w.name)
        assert (arg.transform, tuple(arg.shape), tuple(arg.file_shape)) == ("t9co", (9 * 128, 128), (128, 128, 3, 3))
        assert dict((n, sh) for n, _, sh in _plan_of(s).stream_entries())[w.name] == (128, 128, 3, 3)
    assert len(routed) == 4
    np.testing.assert_array_equal(outs["streamed"], outs["resident"])
    np.testing.assert_array_equal(outs["streamed2"], outs["resident"])
    np.testing.assert_array_equal(outs["resident2"], outs["resident"])


def _conv_attrs():
    return {"dilations": "1,1", "group": 1, "kernel_shape": "3,3", "pads": "1,1,1,1", "strides": "1,1"}


def _tied_graph():
    gb = jax_graphs.GraphBuilder(seed=2)
    x = gb.input("x", (1, 128, 8, 8))
    wspec = gb.weight("wshared", gb.randn(128, 128, 3, 3))
    c1 = gb.emit("Conv", [x, wspec], [(1, 128, 8, 8)], _conv_attrs(), name="convA")
    c2 = gb.emit("Conv", [c1, wspec], [(1, 128, 8, 8)], _conv_attrs(), name="convB")
    gb.add(c1, c2)
    return gb


@pytest.mark.parametrize("case", ["tied", "forced_uint8"])
def test_rewrite_leaves_tied_and_forced_quantized_weights_alone(routed, case):
    """A weight with two consumers cannot be relayouted for one, and the
    quantizer of force_uint8_storage_set wants the file layout: both stay
    plain Convs and match the default path."""
    if case == "tied":
        gb, cfg, shape = _tied_graph(), {}, (1, 128, 8, 8)
    else:
        gb, shape = _smallconv_graph(), (2, 128, 8, 8)
        wname = parse_first_conv_weight(gb)
        cfg = dict(force_uint8_storage_set={wname})
    xv = np.random.RandomState(0).randn(*shape).astype(np.float32)
    outs = []
    for route in (True, False):
        s = Session(SessionConfig(device=CPU, use_pallas_smallconv=route, **cfg),
                    weights_provider=DictWeightsProvider(params_from_numpy(gb.weights)))
        s.read_string(gb.to_text())
        assert all(op.op_type != "ostpu.conv3x3_im2col" for op in s.graph.ops)
        assert all(t.transform is None for op in s.graph.ops for t in op.inputs)
        s.add_tensor("x", xv)
        outs.append(next(iter(s.run().values())))
    assert routed == []
    np.testing.assert_array_equal(outs[0], outs[1])


def parse_first_conv_weight(gb) -> str:
    from onnxstream_tpu_torch.ir import parse_model_txt
    return next(op.inputs[1].name for op in parse_model_txt(gb.to_text()).ops if op.op_type == "Conv")


@pytest.mark.parametrize("x,w,kw,want", [
    ((2, 128, 8, 8), (128, 128, 3, 3), {}, True),
    ((1, 2560, 8, 8), (1280, 2560, 3, 3), {}, True),
    ((1, 640, 32, 32), (640, 640, 3, 3), {}, True),
    ((1, 320, 64, 64), (320, 320, 3, 3), {}, False),             # H W > 1024, C % 128 != 0
    ((2, 128, 8, 8), (130, 128, 3, 3), {}, False),               # O % 128 != 0
    ((2, 128, 8, 8), (128, 128, 1, 1), dict(pads=(0, 0, 0, 0)), False),
    ((2, 128, 8, 8), (128, 128, 3, 3), dict(strides=(2, 2)), False),
    ((2, 128, 8, 8), (128, 128, 3, 3), dict(dilations=(2, 2)), False),
    ((2, 128, 8, 8), (128, 64, 3, 3), dict(group=2), False),
    ((1, 128, 3, 3), (128, 128, 3, 3), {}, False),               # N H W % 8 != 0
])
def test_smallconv_eligible_is_the_route_s_gate(x, w, kw, want):
    assert smallconv_eligible(x, w, **kw) is want

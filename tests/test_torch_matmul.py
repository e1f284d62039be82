"""The small-conv route: kernel 9's twin, the im2col convolution and the Conv gate.

``matmul_reference`` and ``conv3x3_im2col`` of the port against the JAX
package on the CPU (``matmul_pallas`` / ``conv3x3_im2col_pallas`` in interpret
mode, and ``jnp.dot`` / ``lax.conv``), inputs made from a seed with numpy, at
the JAX suite's own cases and bars (``tests/test_matmul_kernel.py``: rtol 1e-5
/ atol 1e-4 sqrt(K / 128) for the product, 1e-4 for the conv, 2e-2 for a
bfloat16 output); ``matmul_supported`` against the JAX predicate; and a
Session whose ``use_pallas_smallconv`` sends the eligible 3 x 3 convolutions
through the route, against the JAX session and the default path.

The CUDA kernel itself is held against the twin by the ``gpu``-marked tests
(skipped without a card) and by ``chip_smoke.py``.
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
from onnxstream_tpu_torch.kernels.matmul import conv3x3_im2col, matmul, matmul_reference, matmul_supported
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
T = torch.from_numpy


def _bf16(a: np.ndarray) -> torch.Tensor:
    return T(a).to(torch.bfloat16)


MATMUL_CASES = [
    (64, 1152, 128, False),     # one M block (the 8 x 8 level's shape class)
    (128, 2560, 256, True),     # several K steps, with bias
    (512, 1280, 640, True),     # the 16 x 16 level's 1 x 1 conv class
    (256, 11520, 1280, False),  # a full 9 C sweep (3 x 3 im2col, C = 1280)
]


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
    got = conv3x3_im2col(T(x), T(wt), T(bias), out_dtype=torch.float32)
    assert got.shape == (batch, h, w, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


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
    # the eligible conv only, NHWC in, in run and in run_eager
    assert routed == [((2, 8, 8, 128), (128, 128, 3, 3))] * 2
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


# -------------------------------------------------------- the kernel on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,out_dtype,tol", [(torch.float32, torch.float32, 1e-4), (torch.bfloat16, torch.float32, 1e-3),
                                                 (torch.bfloat16, torch.bfloat16, 2e-2), (torch.float16, torch.float16, 2e-2)])
@pytest.mark.parametrize("m,k,n,bias", MATMUL_CASES + [(35, 100, 33, True), (64, 23040, 1280, True)])
def test_matmul_kernel_matches_twin_on_card(m, k, n, bias, dtype, out_dtype, tol):
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    a = T(rng.randn(m, k).astype(np.float32)).to(dev, dtype)
    b = T((0.02 * rng.randn(k, n)).astype(np.float32)).to(dev, dtype)
    bv = T(rng.randn(n).astype(np.float32)).to(dev) if bias else None
    before = matmul.launches
    got = matmul(a, b, bv, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = matmul_reference(a, b, bv, out_dtype=out_dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * max(1.0, want.float().abs().max().item()))

"""Calibrated W8A8 (uint8 x uint8) products of the port against the JAX package.

The plain twins of ``kernels/qmatmul.py qmatmul`` and ``kernels/qconv.py qconv``
(what the wrappers compute on CPU tensors) must equal the JAX package's exact
oracles ``qmatmul_reference`` / ``qconv_reference`` to float32 rounding and the
JAX kernels run in interpret mode within 1e-4 of max|out| (the JAX kernel
accumulates in float32); ``quantize_activation`` must be bit-equal to JAX's.
The executor's calibrated paths (W8A8 routes, QDQ of intermediates, range
calibration) must agree with the JAX sessions. The CUDA kernel itself is held
against the twins on the card by tests/test_torch_qlinear_card.py, which
imports no JAX, and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxstream_tpu.kernels.qconv import qconv as jax_qconv
from onnxstream_tpu.kernels.qconv import qconv_reference as jax_qconv_reference
from onnxstream_tpu.kernels.qmatmul import qmatmul as jax_qmatmul
from onnxstream_tpu.kernels.qmatmul import qmatmul_reference as jax_qmatmul_reference
from onnxstream_tpu.kernels.qmatmul import quantize_activation as jax_quantize_activation
from onnxstream_tpu.convert.quantize import quantize_graph_weights as jax_quantize_graph_weights
from onnxstream_tpu.models.sd.vae import VAE_TINY as JAX_VAE_TINY
from onnxstream_tpu.models.sd.vae import VaeConfig as JaxVaeConfig
from onnxstream_tpu.models.sd.vae import build_vae_decoder as jax_build_vae_decoder
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.kernels import qconv as qconv_mod
from onnxstream_tpu_torch.kernels import qmatmul as qmatmul_mod
from onnxstream_tpu_torch.kernels.qconv import qconv, qconv_variant
from onnxstream_tpu_torch.kernels.qmatmul import (qconv_takes_nhwc, qgemm_takes_kmajor, qgemm_variant, qmatmul,
                                                  qmatmul_reference, quantize_activation)
from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, VaeConfig, build_vae_decoder
from onnxstream_tpu_torch.runtime.planner import WEIGHT_TRANSFORMS
from onnxstream_tpu_torch.runtime.quantization import quantize_weight_percentile
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy
from test_torch_qlinear_card import QCONV_CASES, SA, SW, ZA, ZW, _qconv_case, _u8

CPU = torch.device("cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# -------------------------------------------------------------- kernel 3: qmatmul
# (lead..., M, K, N): the VAE mid-block projections cut in M, K 36 / N 3 (the
# VAE's conv_in / conv_out widths), ragged M, K, N, a batched A
QMM_CASES = [(64, 512, 512), (77, 36, 3), (5, 100, 300), (130, 64, 257), (2, 7, 33, 48)]


def _qmm_via(route, a, w, **kw):
    """qmatmul of uint8 (..., M, K) x (K, N), or the same product as a 1 x 1
    qconv: the M rows as the pixels of a (1, K, 1, M) input and the weight
    as OIHW (N, K, 1, 1), kernel 4's (N, K) B operand. qconv takes its bias
    in model units: the accumulator-unit bias times a_scale * w_scale."""
    a, w = torch.from_numpy(a), torch.from_numpy(w)
    if route == "qmatmul":
        return qmatmul(a, w, SA, ZA, SW, ZW, **kw).numpy()
    (k, n), lead = w.shape, a.shape[:-1]
    if kw.get("bias") is not None:
        kw["bias"] = kw["bias"] * (SA * SW)
    x = a.reshape(-1, k).t().reshape(1, k, 1, -1).contiguous()
    y = qconv(x, w.t().reshape(n, k, 1, 1).contiguous(), SA, ZA, SW, ZW, **kw)
    return y.reshape(n, -1).t().reshape(*lead, n).numpy()


@pytest.mark.parametrize("route", ["qmatmul", "qconv_1x1"])
@pytest.mark.parametrize("shape", QMM_CASES)
def test_qmatmul_twin_equals_exact_oracle(shape, route):
    *lead, k, n = shape
    rng = np.random.RandomState(0)
    a, w = _u8(rng, *lead, k), _u8(rng, k, n)
    bias = np.trunc(rng.randn(n) * 3000).astype(np.float32)  # accumulator units, as qconv passes it
    got = _qmm_via(route, a, w, bias=torch.from_numpy(bias))
    want = jax_qmatmul_reference(a, w, SA, ZA, SW, ZW, bias=bias)
    assert got.dtype == np.float32 and got.shape == want.shape
    # qconv's float32 division of the bias may truncate to the neighbouring integer: 1 accumulator unit
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() + (SA * SW if route == "qconv_1x1" else 0.0)
    # requantized uint8: the oracle rounds in float64, the twin in float32
    got8 = _qmm_via(route, a, w, out_scale=0.7, out_zero=110, bias=torch.from_numpy(bias))
    want8 = jax_qmatmul_reference(a, w, SA, ZA, SW, ZW, out_scale=0.7, out_zero=110, bias=bias)
    assert got8.dtype == np.uint8 and (np.abs(got8.astype(int) - want8.astype(int)) <= 1).all()
    assert (got8 == want8).mean() > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", QMM_CASES[:4])
def test_qmatmul_twin_matches_jax_kernel(shape, dtype):
    *lead, k, n = shape
    rng = np.random.RandomState(1)
    a, w = _u8(rng, *lead, k), _u8(rng, k, n)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_qmatmul(jnp.asarray(a), jnp.asarray(w), SA, ZA, SW, ZW, out_dtype=jdt,
                                  interpret=True).astype(jnp.float32))
    got = qmatmul(torch.from_numpy(a), torch.from_numpy(w), SA, ZA, SW, ZW, out_dtype=tdt)
    assert got.dtype == tdt
    # the JAX kernel sums bf16 products in float32: exact only below 2^24
    assert _rel(got.float().numpy(), want) <= (1e-4 if dtype == "float32" else 1e-2)


# ---------------------------------------------------------------- kernel 4: qconv
@pytest.mark.parametrize("case", QCONV_CASES)
def test_qconv_twin_equals_exact_oracle(case):
    x, w, bias, kw = _qconv_case(case)
    got = qconv(torch.from_numpy(x), torch.from_numpy(w), SA, ZA, SW, ZW, bias=torch.from_numpy(bias), **kw)
    # JAX's qconv divides the bias in float32 before truncating; its oracle in
    # float64: the two may take neighbouring integers, 1 accumulator unit
    want = jax_qconv_reference(x, w, SA, ZA, SW, ZW, bias=bias, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max() + SA * SW
    got8 = qconv(torch.from_numpy(x), torch.from_numpy(w), SA, ZA, SW, ZW, bias=torch.from_numpy(bias),
                 out_scale=0.7, out_zero=110, **kw).numpy()
    want8 = jax_qconv_reference(x, w, SA, ZA, SW, ZW, bias=bias, out_scale=0.7, out_zero=110, **kw)
    assert (np.abs(got8.astype(int) - want8.astype(int)) <= 1).all() and (got8 == want8).mean() > 0.999
    # without a bias the two are the same arithmetic up to float32 rounding
    got = qconv(torch.from_numpy(x), torch.from_numpy(w), SA, ZA, SW, ZW, **kw)
    assert _rel(got.numpy(), jax_qconv_reference(x, w, SA, ZA, SW, ZW, **kw)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QCONV_CASES[:4])
def test_qconv_twin_matches_jax_kernel(case, dtype):
    x, w, bias, kw = _qconv_case(case, seed=2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_qconv(jnp.asarray(x), jnp.asarray(w), SA, ZA, SW, ZW, bias=jnp.asarray(bias),
                                out_dtype=jdt, interpret=True, **kw).astype(jnp.float32))
    got = qconv(torch.from_numpy(x), torch.from_numpy(w), SA, ZA, SW, ZW, bias=torch.from_numpy(bias),
                out_dtype=tdt, **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert _rel(got.float().numpy(), want) <= (1e-4 if dtype == "float32" else 1e-2)


def test_quantize_activation_is_bit_equal_to_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(4096) * 5).astype(np.float32)
    # ties: x / scale lands on k + 0.5, rounded half to even; the clip ends
    x[:8] = (np.array([0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0, 0.0]) * np.float32(0.05)).astype(np.float32)
    for scale, zero in ((0.05, 0), (0.037, 128), (1.3e-3, 255)):
        got = quantize_activation(torch.from_numpy(x), scale, zero).numpy()
        want = np.asarray(jax_quantize_activation(jnp.asarray(x), scale, zero))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # a bf16 activation is widened first, as the executor hands it over
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(quantize_activation(xb, 0.05, 7).numpy(),
                                  np.asarray(jax_quantize_activation(jnp.asarray(xb.float().numpy()), 0.05, 7)))
    # an M-major activation (the VAE's attention projections) comes out
    # row-major, so kernel 3 reads it in place
    for xt in (torch.from_numpy(x).reshape(64, 64).t(), xb.reshape(64, 64).t()):
        q = quantize_activation(xt, 0.05, 7)
        assert q.is_contiguous() and torch.equal(q, quantize_activation(xt.contiguous(), 0.05, 7))


# ------------------------------------------------------------ wrappers' routing
@pytest.mark.parametrize("kernel", ["qmatmul", "qconv"])
def test_cuda_tensors_never_reach_the_twin(kernel, monkeypatch):
    """A tensor that says it is on CUDA launches the kernel or raises; it is
    never computed by the twin (faked here: is_cuda on a CPU tensor)."""
    calls = []
    monkeypatch.setattr(qmatmul_mod, "qmatmul_reference", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(qconv_mod, "qconv_reference", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises((ValueError, RuntimeError)):
        if kernel == "qmatmul":
            qmatmul(torch.zeros(3, 64, dtype=torch.uint8), torch.zeros(64, 8, dtype=torch.uint8), 0.5, 3, 0.1, 4)
        else:
            qconv(torch.zeros(1, 4, 6, 6, dtype=torch.uint8), torch.zeros(8, 4, 3, 3, dtype=torch.uint8),
                  0.5, 3, 0.1, 4, pads=(1, 1, 1, 1))
    assert not calls


@pytest.mark.parametrize("bad", ["a_dtype", "w_rank", "chain", "zero_point", "vector_scale", "k_too_large"])
def test_qmatmul_refuses_what_the_kernel_does_not_take(bad):
    a, w = torch.zeros(2, 16, dtype=torch.uint8), torch.zeros(16, 8, dtype=torch.uint8)
    kw = dict(a_scale=0.5, a_zero=3, w_scale=0.1, w_zero=4)
    if bad == "a_dtype":
        a = a.float()
    elif bad == "w_rank":
        w = w.reshape(2, 8, 8)
    elif bad == "chain":
        a = torch.zeros(2, 15, dtype=torch.uint8)
    elif bad == "zero_point":
        kw["a_zero"] = 256
    elif bad == "vector_scale":
        kw["w_scale"] = torch.ones(8)
    else:  # the int32 accumulator could overflow: 255^2 K >= 2^31
        a, w = torch.zeros(2, 33026, dtype=torch.uint8), torch.zeros(33026, 8, dtype=torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        qmatmul(a, w, **kw)
    with pytest.raises((TypeError, ValueError)):
        qmatmul_reference(a, w, **kw)


@pytest.mark.parametrize("bad", ["groups", "rank", "empty", "k_too_large"])
def test_qconv_refuses_what_the_kernel_does_not_take(bad):
    x, w = torch.zeros(1, 4, 6, 6, dtype=torch.uint8), torch.zeros(8, 4, 3, 3, dtype=torch.uint8)
    if bad == "groups":
        w = torch.zeros(8, 2, 3, 3, dtype=torch.uint8)
    elif bad == "rank":
        x = x[0]
    elif bad == "empty":
        x = torch.zeros(1, 4, 2, 2, dtype=torch.uint8)
    else:  # K = C kh kw = 33030 > 33025
        x, w = torch.zeros(1, 3670, 3, 3, dtype=torch.uint8), torch.zeros(8, 3670, 3, 3, dtype=torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        qconv(x, w, 0.5, 3, 0.1, 4)


# ------------------------------------------------------- the executor's paths
def _two_conv_net():
    """The JAX suite's calibrated two-conv net (tests/test_qconv.py:88-110):
    Conv -> SiLU as Sigmoid * x -> Conv, float and uint8[scale,zp] weights."""
    rng = np.random.RandomState(3)
    w1 = (rng.randn(8, 4, 3, 3) * 0.3).astype(np.float32)
    b1 = (rng.randn(8) * 0.1).astype(np.float32)
    w2 = (rng.randn(4, 8, 3, 3) * 0.3).astype(np.float32)
    b2 = (rng.randn(4) * 0.1).astype(np.float32)
    x = rng.randn(1, 4, 16, 16).astype(np.float32)

    def model(wspec1, wspec2):
        return (
            f"c1:Conv*input:x(1,4,16,16);{wspec1};b1.bin(float32:8)*output:h(1,8,16,16)*pads:1,1,1,1\n"
            "s1:Sigmoid*input:h(1,8,16,16)*output:hs(1,8,16,16)\n"
            "m1:Mul*input:h(1,8,16,16);hs(1,8,16,16)*output:hm(1,8,16,16)\n"
            f"c2:Conv*input:hm(1,8,16,16);{wspec2};b2.bin(float32:4)*output:y(1,4,16,16)*pads:1,1,1,1\n"
        )

    q1, sc1, zp1 = quantize_weight_percentile(w1)
    q2, sc2, zp2 = quantize_weight_percentile(w2)
    fmodel = model("w1.bin(float32:8,4,3,3)", "w2.bin(float32:4,8,3,3)")
    qmodel = model(f"w1.bin(uint8[{sc1},{zp1}]:8,4,3,3)", f"w2.bin(uint8[{sc2},{zp2}]:4,8,3,3)")
    return (fmodel, {"w1.bin": w1, "b1.bin": b1, "w2.bin": w2, "b2.bin": b2},
            qmodel, {"w1.bin": q1, "b1.bin": b1, "w2.bin": q2, "b2.bin": b2}, x)


def _run_both(model, weights, inputs, eager=False, **cfg):
    """(port session, port outputs, JAX session, JAX outputs)."""
    ps = Session(SessionConfig(device=CPU, **cfg), weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    js = JaxSession(JaxConfig(**cfg), weights_provider=JaxDict(dict(weights)))
    outs = []
    for s in (ps, js):
        s.read_string(model)
        for k, v in inputs.items():
            s.add_tensor(k, v)
        outs.append({k: np.asarray(v, np.float32) for k, v in s.run(eager=eager).items()})
    return ps, outs[0], js, outs[1]


def test_calibration_of_the_two_conv_net_matches_jax():
    fmodel, fw, _, _, x = _two_conv_net()
    ps, got, js, want = _run_both(fmodel, fw, {"x": x}, range_data_calibrate=True)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    pr, jr = ps._executor().range_data.data, js._executor().range_data.data
    assert sorted(pr) == sorted(jr) == ["c1", "c2", "m1", "s1", "x"]
    for k in jr:
        np.testing.assert_allclose(pr[k], jr[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["use_uint8_arithmetic", "use_uint8_qdq"])
def test_w8a8_and_qdq_sessions_match_jax(mode):
    fmodel, fw, qmodel, qw, x = _two_conv_net()
    ranges = _run_both(fmodel, fw, {"x": x}, range_data_calibrate=True)[2]._executor().range_data.data
    ps, got, _, want = _run_both(qmodel, qw, {"x": x}, range_data=dict(ranges), **{mode: True})
    assert _rel(got["y"], want["y"]) <= 1e-5
    ex = ps._executor()
    if mode == "use_uint8_arithmetic":
        assert ex.quant_routes == {"c1": "qconv", "c2": "qconv"}
    else:
        # h feeds s1 and m1 (refcount 2): quantized; hs is single-use and
        # consumed by the next op: skipped, as in the reference
        assert not ex.quant_routes and "hs" in ex._qdq_skip and "h" not in ex._qdq_skip


def test_qdq_without_ranges_matches_jax():
    """use_uint8_qdq with no calibration: the percentiles estimated on the
    device from the tensor itself, as the JAX executor does."""
    _, _, qmodel, qw, x = _two_conv_net()
    _, got, _, want = _run_both(qmodel, qw, {"x": x}, use_uint8_qdq=True)
    assert _rel(got["y"], want["y"]) <= 1e-5


def test_w8a8_matmul_session_matches_jax():
    """A MatMul with a uint8 weight and a range for its input (a graph input:
    the range recorded under the tensor's name) runs through qmatmul."""
    rng = np.random.RandomState(9)
    wf = rng.randn(48, 40).astype(np.float32)
    wq, scale, zero = quantize_weight_percentile(wf)
    x = rng.randn(2, 6, 48).astype(np.float32)
    model = f"mm:MatMul*input:x(2,6,48);w.bin(uint8[{scale},{zero}]:48,40)*output:y(2,6,40)\n"
    ranges = {"x": (float(x.min()), float(x.max())), "mm": (-5.0, 5.0)}
    ps, got, _, want = _run_both(model, {"w.bin": wq}, {"x": x}, use_uint8_arithmetic=True, range_data=ranges)
    ex = ps._executor()
    assert ex.quant_routes == {"mm": "qmatmul"}
    # the weight uploads K-major for kernel 3's wgmma pipeline
    (w,) = ex.plan.arg_weights
    assert (w.transform, w.shape, w.file_shape) == ("tnk", (40, 48), (48, 40))
    assert got["y"].shape == (2, 6, 40)
    assert _rel(got["y"], want["y"]) <= 1e-5
    assert _rel(got["y"], x @ ((wq.astype(np.float32) - zero) * scale)) < 0.05


def test_vae_calibration_matches_jax():
    """The TINY VAE decoder calibrated eagerly: the same op and input names
    and the same ranges (rtol 1e-6) as the JAX session."""
    g, jg = build_vae_decoder(VAE_TINY, seed=7), jax_build_vae_decoder(JAX_VAE_TINY, seed=7)
    z = np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)
    ps = Session(SessionConfig(device=CPU, range_data_calibrate=True),
                 weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    js = JaxSession(JaxConfig(range_data_calibrate=True), weights_provider=JaxDict(dict(jg.weights)))
    for s, text in ((ps, g.to_text()), (js, jg.to_text())):
        s.read_string(text)
        s.add_tensor("latent", z)
        s.run(eager=True)
    pr, jr = ps._executor().range_data.data, js._executor().range_data.data
    assert sorted(pr) == sorted(jr) and "latent" in pr and len(pr) > 20
    for k, (lo, hi) in jr.items():
        np.testing.assert_allclose(pr[k], (lo, hi), rtol=1e-6, atol=1e-6 * max(abs(lo), abs(hi), 1.0))


# ------------------------------------------- the K-major upload of the W8A8 MatMuls
@pytest.mark.parametrize("out", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("shape", QMM_CASES)
def test_twin_gives_the_same_bits_on_both_weight_forms(shape, out):
    """qmatmul on the (K, N) weight and on its (N, K) upload form: the same
    bits, through the twin and through the CPU wrapper. The wrapper takes an
    (N, K) weight only where K % 16 == 0, on either device."""
    *lead, k, n = shape
    rng = np.random.RandomState(5)
    a, w = torch.from_numpy(_u8(rng, *lead, k)), torch.from_numpy(_u8(rng, k, n))
    bias = torch.from_numpy(np.trunc(rng.randn(n) * 3000).astype(np.float32))
    kw = dict(out_scale=0.7, out_zero=110) if out == "uint8" else dict(out_dtype=getattr(torch, out))
    want = qmatmul_reference(a, w, SA, ZA, SW, ZW, bias=bias, **kw)
    w_nk = WEIGHT_TRANSFORMS["tnk"](w)
    assert tuple(w_nk.shape) == (n, k) and w_nk.is_contiguous()
    assert torch.equal(qmatmul_reference(a, w_nk, SA, ZA, SW, ZW, bias=bias, weight_nk=True, **kw), want)
    if qgemm_takes_kmajor(k):
        assert torch.equal(qmatmul(a, w_nk, SA, ZA, SW, ZW, bias=bias, weight_nk=True, **kw), want)
    else:
        with pytest.raises(ValueError, match="K % 16"):
            qmatmul(a, w_nk, SA, ZA, SW, ZW, bias=bias, weight_nk=True, **kw)


@pytest.mark.parametrize("case,want", [
    (dict(m=4096, k=512, n=512), "wgmma"),             # the VAE decode's attention projections
    (dict(m=1, k=64, n=8), "wgmma"),                   # M under one warpgroup's 64 rows
    (dict(m=77, k=48, n=3), "wgmma"),                  # ragged M and N, K under one 128-byte k-tile
    (dict(m=4096, k=512, n=512, weight_nk=False), "mma"),   # a (K, N) weight: no K-major B
    (dict(m=77, k=36, n=3), "mma"),                    # K % 16 != 0
    (dict(m=64, k=512, n=512, a_ptr=8), "mma"),        # A rows off 16-byte boundaries
    (dict(m=64, k=512, n=512, w_ptr=4), "mma"),        # W rows off 16-byte boundaries
    (dict(m=4096, k=512, n=512, conv=True), "mma"),    # an NCHW conv keeps qgemm_kernel
    # a channels-last conv (nhwc): the VAE decoder's 512 / 256 / 128 channels
    (dict(m=4096, k=4608, n=512, weight_nk=False, conv=True, nhwc=True, c=512), "wgmma"),
    (dict(m=65536, k=256, n=128, weight_nk=False, conv=True, nhwc=True, c=256), "wgmma"),
    (dict(m=4096, k=36, n=512, weight_nk=False, conv=True, nhwc=True, c=4), "mma"),        # conv_in: C % 16
    (dict(m=262144, k=1152, n=3, weight_nk=False, conv=True, nhwc=True, c=128), "wgmma"),  # conv_out: O = 3
    (dict(m=4096, k=4608, n=512, weight_nk=False, conv=True, nhwc=True, c=512, a_ptr=8), "mma"),
])
def test_qgemm_variant(case, want):
    case = dict(case)
    assert qgemm_variant(case.pop("m"), case.pop("k"), case.pop("n"), case.pop("weight_nk", True), **case) == want


def _two_matmul_net(k1=48, k3=48):
    """x -> mm1 (w1) -> mm2 (w2) -> mm3 (w2 again: tied), the weights uint8
    from the file, every op with a range; K of mm1 given by k1."""
    rng = np.random.RandomState(11)
    w1, scale1, zero1 = quantize_weight_percentile(rng.randn(k1, 32).astype(np.float32))
    w2, scale2, zero2 = quantize_weight_percentile(rng.randn(32, 32).astype(np.float32))
    x = rng.randn(1, 5, k1).astype(np.float32)
    model = (f"mm1:MatMul*input:x(1,5,{k1});w1.bin(uint8[{scale1},{zero1}]:{k1},32)*output:h(1,5,32)\n"
             f"mm2:MatMul*input:h(1,5,32);w2.bin(uint8[{scale2},{zero2}]:32,32)*output:g(1,5,32)\n"
             f"mm3:MatMul*input:g(1,5,32);w2.bin(uint8[{scale2},{zero2}]:32,32)*output:y(1,5,32)\n")
    ranges = {"x": (float(x.min()), float(x.max())), "mm1": (-9.0, 9.0), "mm2": (-30.0, 30.0),
              "mm3": (-99.0, 99.0)}
    return model, {"w1.bin": w1, "w2.bin": w2}, x, ranges


@pytest.mark.parametrize("k1,tagged", [(48, True), (36, False)])
def test_planner_tags_the_w8a8_matmul_weights(k1, tagged):
    """The calibrated W8A8 MatMul weights upload as (N, K) ('tnk') where K %
    16 == 0; a tied weight (w2, read by two MatMuls) keeps the file layout;
    the session still equals the JAX package's."""
    model, weights, x, ranges = _two_matmul_net(k1)
    ps, got, _, want = _run_both(model, weights, {"x": x}, use_uint8_arithmetic=True, range_data=ranges)
    ex = ps._executor()
    assert ex.quant_routes == {"mm1": "qmatmul", "mm2": "qmatmul", "mm3": "qmatmul"}
    args = {w.name: w for w in ex.plan.arg_weights}
    assert (args["w1.bin"].transform, args["w1.bin"].shape) == (("tnk", (32, k1)) if tagged else (None, (k1, 32)))
    assert (args["w2.bin"].transform, args["w2.bin"].shape) == (None, (32, 32))
    assert _rel(got["y"], want["y"]) <= 1e-5


def test_planner_leaves_the_weights_alone_without_the_w8a8_route():
    """Without use_uint8_arithmetic (or without a range for the op) the
    MatMul weight keeps the file layout and runs through w8_matmul."""
    model, weights, x, ranges = _two_matmul_net()
    for cfg in (dict(range_data=ranges), dict(use_uint8_arithmetic=True, range_data={"x": ranges["x"]})):
        ps, got, _, want = _run_both(model, weights, {"x": x}, **cfg)
        ex = ps._executor()
        assert set(ex.quant_routes.values()) == {"w8_matmul"}
        assert all(w.transform is None for w in ex.plan.arg_weights)
        assert _rel(got["y"], want["y"]) <= 1e-5


def test_config_options():
    """The calibrated options are taken, and so are the GroupNorm and
    small-conv routes and the options ported last (no option of the JAX
    config that the port keeps raises); the layout pass stays off under the
    uint8 modes, whose calibration keys the NCHW op stream."""
    cfg = SessionConfig(device=CPU, use_uint8_arithmetic=True, use_uint8_qdq=True)
    cfg.set_option("use_uint8_arithmetic", False)
    cfg.set_option("use_uint8_qdq", False)
    assert not cfg.use_uint8_arithmetic and not cfg.use_uint8_qdq
    for opt in ("fuse_groupnorm", "fuse_gn_conv", "use_pallas_smallconv"):
        cfg.set_option(opt, True)
        assert getattr(cfg, opt) is True
    for opt in ("flash_packed_nopad", "force_fp16_storage", "use_nhwc_layout"):
        assert getattr(SessionConfig(device=CPU, **{opt: True}), opt) is True
        cfg.set_option(opt, True)
        assert getattr(cfg, opt) is True
    from onnxstream_tpu_torch.ir import parse_model_txt
    from onnxstream_tpu_torch.runtime.layout import rewrite_nhwc

    g = parse_model_txt("c:Conv*input:x(1,2,4,4);w.bin(float32:3,2,1,1)*output:y(1,3,4,4)")
    for mode in ("use_uint8_arithmetic", "use_uint8_qdq", "range_data_calibrate"):
        assert rewrite_nhwc(g, SessionConfig(device=CPU, use_nhwc_layout=True, **{mode: True})) is g
    assert rewrite_nhwc(g, SessionConfig(device=CPU, use_nhwc_layout=True)) is not g


# ------------------------------------- kernel 4's channels-last wgmma route
def test_quantize_activation_channels_last_is_bit_equal_to_jax():
    """With channels_last the uint8 activation keeps its (B, C, H, W) shape
    and JAX's values, laid out channels-last by the float32 conversion, from
    an NCHW input, a bf16 one and a strided view alike."""
    rng = np.random.RandomState(8)
    x = (rng.randn(2, 32, 5, 7) * 4).astype(np.float32)
    want = np.asarray(jax_quantize_activation(jnp.asarray(x), 0.037, 128))
    xt = torch.from_numpy(x)
    views = [xt, xt.contiguous(memory_format=torch.channels_last),
             torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 3, 2))).transpose(2, 3)]
    for v in views:
        q = quantize_activation(v, 0.037, 128, channels_last=True)
        assert q.dtype == torch.uint8 and tuple(q.shape) == x.shape
        assert q.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(q.numpy(), want)
    xb = xt.to(torch.bfloat16)
    np.testing.assert_array_equal(quantize_activation(xb, 0.05, 7, channels_last=True).numpy(),
                                  np.asarray(jax_quantize_activation(jnp.asarray(xb.float().numpy()), 0.05, 7)))


def test_ohwi_upload_transform_is_the_channels_last_permutation():
    """WEIGHT_TRANSFORMS["ohwi"]: the OIHW shape kept, the memory that of
    numpy's (O, kh, kw, C) transpose: the K-major rows kernel 4 reads."""
    w = _u8(np.random.RandomState(6), 64, 32, 3, 3)
    t = WEIGHT_TRANSFORMS["ohwi"](torch.from_numpy(w))
    assert tuple(t.shape) == w.shape and t.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(t.numpy(), w)
    flat = torch.as_strided(t, (t.numel(),), (1,)).numpy()
    np.testing.assert_array_equal(flat, np.ascontiguousarray(w.transpose(0, 2, 3, 1)).reshape(-1))


@pytest.mark.parametrize("case,want", [
    ("both_channels_last", "wgmma"),
    ("nchw_input", "mma"),
    ("oihw_weight", "mma"),
    ("conv_in_c4", "mma"),
    ("conv_out_o3", "wgmma"),
    ("input_view_off_16_bytes", "mma"),
])
def test_qconv_variant(case, want):
    """The conv's variant from the layouts and starts of CPU tensors, as the
    C dispatcher decides it on the card."""
    c, o, h = (4, 64, 8) if case == "conv_in_c4" else (32, 3 if case == "conv_out_o3" else 64, 8)
    x = torch.zeros(1, c, h, h, dtype=torch.uint8)
    w = torch.zeros(o, c, 3, 3, dtype=torch.uint8)
    if case != "nchw_input":
        x = x.contiguous(memory_format=torch.channels_last)
    if case != "oihw_weight":
        w = WEIGHT_TRANSFORMS["ohwi"](w)
    if case == "input_view_off_16_bytes":
        x = torch.zeros(1 * c * h * h + 8, dtype=torch.uint8)[8:].view(1, h, h, c).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 == 8
    assert qconv_variant(x, w) == want
    assert qconv_takes_nhwc(c) == (case != "conv_in_c4")


@pytest.mark.parametrize("case", QCONV_CASES)
def test_qconv_channels_last_operands_give_the_same_bits(case):
    """qconv on channels-last operands (the layout of the wgmma variant) is
    the same function: on CPU tensors the twin gives the same bits as on the
    NCHW / OIHW ones."""
    x, w, bias, kw = _qconv_case(case, seed=5)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias)
    for out in (dict(out_dtype=torch.float32), dict(out_scale=0.7, out_zero=110)):
        want = qconv(xt, wt, SA, ZA, SW, ZW, bias=bt, **out, **kw)
        got = qconv(xt.contiguous(memory_format=torch.channels_last), WEIGHT_TRANSFORMS["ohwi"](wt), SA, ZA, SW, ZW,
                    bias=bt, **out, **kw)
        assert torch.equal(got, want)


# the TINY decoder's layout with 64 / 128 channels
VAE_W64 = dict(base=64, mult=(1, 2), blocks=1, norm_groups=4, sample=8)


def test_w8a8_vae_session_on_the_channels_last_route_matches_jax():
    """A calibrated W8A8 VAE decoder whose convs upload channels-last
    ("ohwi") and quantize their input so: the same output as the JAX W8A8
    session to one image level, every conv with C % 16 == 0 tagged (conv_out
    too), conv_in (C = 4) in the file layout."""
    g = build_vae_decoder(VaeConfig(**VAE_W64), seed=3)
    jg = jax_build_vae_decoder(JaxVaeConfig(**VAE_W64), seed=3)
    assert g.to_text() == jg.to_text()
    z = np.random.RandomState(12).randn(1, 4, 8, 8).astype(np.float32)
    jcal = JaxSession(JaxConfig(fuse_ops_in_attention=True, range_data_calibrate=True),
                      weights_provider=JaxDict(dict(jg.weights)))
    jcal.read_string(jg.to_text())
    jcal.add_tensor("latent", z)
    jcal.run(eager=True)
    ranges = dict(jcal._executor().range_data.data)
    text, weights = jax_quantize_graph_weights(jg.to_text(), jg.weights)
    ps = Session(SessionConfig(device=CPU, fuse_ops_in_attention=True, use_uint8_arithmetic=True, range_data=ranges),
                 weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    js = JaxSession(JaxConfig(fuse_ops_in_attention=True, use_uint8_arithmetic=True, range_data=ranges),
                    weights_provider=JaxDict(dict(weights)))
    outs = []
    for sess in (ps, js):
        sess.read_string(text)
        sess.add_tensor("latent", z)
        outs.append(np.asarray(next(iter(sess.run().values())), np.float32))
    levels = lambda y: np.clip(np.round((y / 2 + 0.5) * 255), 0, 255).astype(int)
    assert np.abs(levels(outs[0]) - levels(outs[1])).max() <= 1
    ex = ps._executor()
    convs = {op.inputs[1].name: op for op in ps.graph.ops
             if op.op_type == "Conv" and ex.quant_routes.get(op.name) == "qconv"}
    args = {w.name: w for w in ex.plan.arg_weights}
    tagged = {n for n in convs if args[n].transform == "ohwi"}
    assert tagged == {n for n, op in convs.items() if qconv_takes_nhwc(op.inputs[1].shape[1])}
    assert len(tagged) >= 5 and len(tagged) < len(convs)
    assert all(args[n].shape == convs[n].inputs[1].shape for n in tagged)

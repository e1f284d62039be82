"""Calibrated W8A8 (uint8 x uint8) products of the port against the JAX package.

The plain twins of ``kernels/qmatmul.py qmatmul`` and ``kernels/qconv.py qconv``
(what the wrappers compute on CPU tensors) must equal the JAX package's exact
oracles ``qmatmul_reference`` / ``qconv_reference`` to float32 rounding and the
JAX kernels run in interpret mode within 1e-4 of max|out| (the JAX kernel
accumulates in float32); ``quantize_activation`` must be bit-equal to JAX's.
The executor's calibrated paths (W8A8 routes, QDQ of intermediates, range
calibration) must agree with the JAX sessions. The CUDA kernel itself is held
against the twins by the ``gpu``-marked tests (skipped without a card) and by
``chip_smoke.py``.
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
from onnxstream_tpu.models.sd.vae import VAE_TINY as JAX_VAE_TINY
from onnxstream_tpu.models.sd.vae import build_vae_decoder as jax_build_vae_decoder
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.kernels import qconv as qconv_mod
from onnxstream_tpu_torch.kernels import qmatmul as qmatmul_mod
from onnxstream_tpu_torch.kernels.qconv import qconv, qconv_reference
from onnxstream_tpu_torch.kernels.qmatmul import qmatmul, qmatmul_reference, quantize_activation
from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder
from onnxstream_tpu_torch.runtime.quantization import quantize_weight_percentile
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
SA, ZA, SW, ZW = 0.03, 120, 0.02, 128


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _u8(rng, *shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


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
# the VAE decoder's conv kinds (3x3 p1 s1, 1x1, conv_in's K = 36, conv_out's
# N = 3) and the JAX suite's strided / dilated / padded cases
QCONV_CASES = [
    dict(x=(1, 4, 9, 11), w=(8, 4, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),
    dict(x=(1, 16, 12, 12), w=(3, 16, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),
    dict(x=(2, 8, 10, 7), w=(16, 8, 1, 1), strides=(1, 1), pads=(0, 0, 0, 0), dil=(1, 1)),
    dict(x=(1, 3, 16, 16), w=(6, 3, 3, 3), strides=(2, 2), pads=(1, 1, 1, 1), dil=(1, 1)),
    dict(x=(1, 5, 14, 14), w=(7, 5, 3, 3), strides=(1, 1), pads=(2, 2, 2, 2), dil=(2, 2)),
    dict(x=(1, 6, 9, 9), w=(5, 6, 3, 2), strides=(2, 1), pads=(0, 1, 2, 0), dil=(1, 1)),
]


def _qconv_case(case, seed=0):
    rng = np.random.RandomState(seed)
    x, w = _u8(rng, *case["x"]), _u8(rng, *case["w"])
    bias = (rng.randn(case["w"][0]) * 30).astype(np.float32)
    kw = dict(strides=case["strides"], pads=case["pads"], dilations=case["dil"])
    return x, w, bias, kw


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
    assert ps._executor().quant_routes == {"mm": "qmatmul"}
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


def test_config_options():
    """The calibrated options are taken, and so are the GroupNorm and
    small-conv routes; the options still unported raise."""
    cfg = SessionConfig(device=CPU, use_uint8_arithmetic=True, use_uint8_qdq=True)
    cfg.set_option("use_uint8_arithmetic", False)
    cfg.set_option("use_uint8_qdq", False)
    assert not cfg.use_uint8_arithmetic and not cfg.use_uint8_qdq
    for opt in ("fuse_groupnorm", "fuse_gn_conv", "use_pallas_smallconv"):
        cfg.set_option(opt, True)
        assert getattr(cfg, opt) is True
    for opt in ("flash_packed_nopad", "force_fp16_storage", "use_nhwc_layout", "synthetic_device_weights"):
        with pytest.raises(NotImplementedError):
            SessionConfig(device=CPU, **{opt: True})


# ------------------------------------------------------- the kernel on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4096, 512, 512), (77, 36, 3), (130, 100, 257), (1000, 4608, 512)])
@pytest.mark.parametrize("out", ["float32", "bfloat16", "uint8"])
def test_qmatmul_kernel_matches_twin_on_card(m, k, n, out):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(0, 256, (m, k), device=dev, generator=gen, dtype=torch.uint8)
    w = torch.randint(0, 256, (k, n), device=dev, generator=gen, dtype=torch.uint8)
    kw = dict(out_scale=40.0, out_zero=100) if out == "uint8" else dict(
        out_dtype=torch.float32 if out == "float32" else torch.bfloat16)
    got = qmatmul(a, w, SA, ZA, SW, ZW, **kw)
    torch.cuda.synchronize()
    want = qmatmul_reference(a, w, SA, ZA, SW, ZW, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # the same arithmetic, bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("case", QCONV_CASES + [
    dict(x=(1, 4, 64, 64), w=(512, 4, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),
    dict(x=(1, 128, 96, 96), w=(3, 128, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),
    # 1 x 1: the (N, K) weight rows with K % 16 != 0 and == 0
    dict(x=(1, 100, 10, 13), w=(257, 100, 1, 1), strides=(1, 1), pads=(0, 0, 0, 0), dil=(1, 1)),
    dict(x=(1, 4608, 25, 40), w=(512, 4608, 1, 1), strides=(1, 1), pads=(0, 0, 0, 0), dil=(1, 1))])
def test_qconv_kernel_matches_twin_on_card(case):
    dev = _card()
    x, w, bias, kw = _qconv_case(case, seed=4)
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev), SA, ZA, SW, ZW)
    for dt in (torch.float32, torch.bfloat16):
        got = qconv(*args, bias=torch.from_numpy(bias).to(dev), out_dtype=dt, **kw)
        torch.cuda.synchronize()
        want = qconv_reference(*args, bias=torch.from_numpy(bias).to(dev), out_dtype=dt, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

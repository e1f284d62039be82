"""The weight-quantized matrix products of the port against the JAX package.

The plain twins of ``kernels/qmatmul.py`` (what the wrappers compute on CPU
tensors) are held against the JAX kernels run as the JAX tests run them on the
CPU (``interpret=True``) and against ``w8a8_dyn_matmul_xla``, the form the JAX
executor dispatches to; the quantization copies must give the JAX package's
arrays bit for bit; single-MatMul sessions with int8 and uint8 weights must
agree with the JAX sessions and take the quantized route; ``w8_plan`` and
``w8_variant`` at the uint8 UNet step's shapes; the K-major int8 weight of
kernel 6 (``weight_nk``: the twin's bits on (N, K) and (K, N), the planner's
``tnk`` tag, ``dyn_variant`` and ``dyn_plan`` at the TinyLlama shapes). The
CUDA kernels themselves are held against the twins by the ``gpu``-marked
tests of tests/test_torch_qmatmul_card.py (skipped without a card) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnxstream_tpu.convert import quantize as jax_convert_quantize
from onnxstream_tpu.kernels.qmatmul import w8_matmul as jax_w8_matmul
from onnxstream_tpu.kernels.qmatmul import w8a8_dyn_matmul as jax_dyn_matmul
from onnxstream_tpu.kernels.qmatmul import w8a8_dyn_matmul_xla
from onnxstream_tpu.runtime import quantization as jax_quantization
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.convert import quantize as convert_quantize
from onnxstream_tpu_torch.kernels import qmatmul
from onnxstream_tpu_torch.kernels.matmul import SMS, TILE_K
from onnxstream_tpu_torch.kernels.qmatmul import (
    dyn_plan,
    dyn_variant,
    w8_matmul,
    w8_matmul_reference,
    w8_plan,
    w8_variant,
    w8a8_dyn_matmul,
    w8a8_dyn_matmul_reference,
)
from onnxstream_tpu_torch.runtime import quantization
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider
from test_torch_qmatmul_card import LLAMA_KN, TORCH_DTYPE

CPU = torch.device("cpu")
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _port_out(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------------ kernel 6: the twin
# the shapes of the JAX tests (tests/test_qmatmul.py): (..., M, K, N), per channel
DYN_CASES = [
    ((1, 96, 256), False),  # M = 1: the decode shape
    ((1, 100, 300), True),  # K, N not powers of two
    ((40, 200, 96), True),
    ((2, 7, 100, 48), True),  # batched
    ((1, 96, 256), True),
    ((4, 100, 300), False),
]


def _dyn_inputs(shape, per_channel):
    *lead, k, n = shape
    a = np.random.RandomState(0).randn(*lead, k).astype(np.float32)
    rng = np.random.RandomState(1)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.rand(n).astype(np.float32) * 0.02 + 0.001) if per_channel else 0.013
    return a, w, ws


@pytest.mark.parametrize("form", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,per_channel", DYN_CASES)
def test_dyn_twin_matches_jax(shape, per_channel, dtype, form):
    """float32: within the JAX bar (2e-5 of max); bfloat16 activations and
    output: the same float32 math, rounded once to bf16 at the end."""
    a, w, ws = _dyn_inputs(shape, per_channel)
    ja = jnp.asarray(a, JAX_DTYPE[dtype])
    if form == "xla":
        want = w8a8_dyn_matmul_xla(ja, jnp.asarray(w), ws)
    else:
        want = jax_dyn_matmul(ja, jnp.asarray(w), ws, interpret=True)
    ta = torch.from_numpy(a).to(TORCH_DTYPE[dtype])
    got = w8a8_dyn_matmul(ta, torch.from_numpy(w), torch.from_numpy(np.atleast_1d(ws)) if per_channel else ws)
    assert got.dtype == ta.dtype and tuple(got.shape) == tuple(want.shape)
    assert _rel(_port_out(got), want) <= (2e-5 if dtype == "float32" else 1e-2)


def test_dyn_twin_quantizes_as_the_kernel_does():
    """Half-way values (ties round to even), an all-zero row (the 1e-12 floor)
    and the largest K of the route (an exact integer dot, rounded once to
    float32): bit for bit what w8a8_dyn_matmul_xla gives."""
    a = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                  [0.0] * 8, [1e-3, -2e-3, 0.0, 5e-4, 1e-3, 0.0, -1e-3, 2e-3]], np.float32)
    w = np.eye(8, dtype=np.int8) * np.int8(3)
    got = w8a8_dyn_matmul(torch.from_numpy(a), torch.from_numpy(w), 0.5)
    want = np.asarray(w8a8_dyn_matmul_xla(jnp.asarray(a), jnp.asarray(w), 0.5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[1].any()
    k = 5632
    big = w8a8_dyn_matmul_reference(torch.ones(1, k), torch.full((k, 1), 127, dtype=torch.int8), 1.0)
    assert big.item() == np.float32(127 * 127 * k) * np.float32(np.float32(1.0) * np.float32(1 / 127))


# ------------------------------------------------------ kernel 5: the twin
W8_CASES = [
    ((1, 96, 256), "float32", False),
    ((200, 128, 64), "float32", False),
    ((2, 7, 100, 48), "bfloat16", False),
    ((6, 160, 72), "float32", True),
    ((6, 160, 72), "bfloat16", True),
    ((77, 96, 40), "float32", True),
]


@pytest.mark.parametrize("shape,dtype,per_channel", W8_CASES)
def test_w8_twin_matches_jax(shape, dtype, per_channel):
    """1e-4 of max in float32 and 5e-2 in bfloat16, the JAX bars
    (tests/test_qmatmul.py:56-91)."""
    *lead, k, n = shape
    rng = np.random.RandomState(7)
    a = rng.randn(*lead, k).astype(np.float32)
    w = rng.randint(0, 256, (k, n)).astype(np.uint8)
    if per_channel:
        sw = rng.uniform(0.001, 0.05, n).astype(np.float32)
        zw = rng.randint(0, 256, n).astype(np.float32)
    else:
        sw, zw = 0.013, 117
    want = jax_w8_matmul(jnp.asarray(a, JAX_DTYPE[dtype]), jnp.asarray(w), sw, zw, interpret=True)
    ta = torch.from_numpy(a).to(TORCH_DTYPE[dtype])
    got = w8_matmul(ta, torch.from_numpy(w), sw, zw)
    assert got.dtype == ta.dtype and tuple(got.shape) == tuple(want.shape)
    assert _rel(_port_out(got), want) < (1e-4 if dtype == "float32" else 5e-2)
    oracle = a.astype(np.float64) @ ((w.astype(np.float64) - zw) * sw)
    assert _rel(_port_out(got), oracle) < (1e-4 if dtype == "float32" else 5e-2)


# ----------------------------------------------------- the wrappers' routing
@pytest.mark.parametrize("kernel", ["w8a8_dyn_matmul", "w8_matmul"])
def test_cuda_tensors_never_reach_the_twin(kernel, monkeypatch):
    """A tensor that says it is on CUDA launches the kernel or raises; it is
    never computed by the twin (faked here: is_cuda on a CPU tensor)."""
    calls = []
    for name in ("w8a8_dyn_matmul_reference", "w8_matmul_reference"):
        monkeypatch.setattr(qmatmul, name, lambda *a, **k: calls.append(a))
    a = torch.randn(3, 64)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises((ValueError, RuntimeError)):
        if kernel == "w8a8_dyn_matmul":
            w8a8_dyn_matmul(a, torch.zeros(64, 8, dtype=torch.int8), 0.5)
        else:
            w8_matmul(a, torch.zeros(64, 8, dtype=torch.uint8), 0.5, 3)
    assert not calls


@pytest.mark.parametrize("bad", ["weight_dtype", "weight_rank", "shapes", "activation_dtype",
                                 "vector_length", "zero_dim_scale"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    a, w, ws = torch.randn(2, 16), torch.zeros(16, 8, dtype=torch.int8), 0.5
    if bad == "weight_dtype":
        w = w.to(torch.uint8)
    elif bad == "weight_rank":
        w = w.reshape(2, 8, 8)
    elif bad == "shapes":
        a = torch.randn(2, 15)
    elif bad == "activation_dtype":
        a = a.double()
    elif bad == "vector_length":
        ws = torch.ones(7)
    else:
        ws = torch.tensor(0.5)
    with pytest.raises((TypeError, ValueError)):
        w8a8_dyn_matmul(a, w, ws)


# ------------------------------------------------------------ quantization
def _quant_case(name):
    rng = np.random.RandomState(4)
    w = rng.randn(512, 16).astype(np.float32) * np.logspace(-2, 1, 16, dtype=np.float32)
    w[:, 7] = 0.0
    w[3, 2] = np.inf  # get_percentiles ignores non-finite entries
    wf = np.where(np.isfinite(w), w, 0.0).astype(np.float32)
    return {
        "get_percentiles": lambda m: m.get_percentiles(w),
        "get_percentiles_tails": lambda m: m.get_percentiles(w[:, 3], 0.01, 0.05),
        "range_to_scale": lambda m: [m.range_to_scale(lo, hi) for lo, hi in
                                     [(-1.0, 2.0), (0.5, 3.0), (-3.0, -0.5), (0.0, 0.0), (-1e-3, 1e-3)]],
        "quantize_dequantize": lambda m: m.dequantize(m.quantize(wf, 0.02, 117), 0.02, 117),
        "quantize_weight_percentile": lambda m: m.quantize_weight_percentile(wf),
        "per_channel": lambda m: m.quantize_weight_percentile_per_channel(wf),
        "per_channel_axis0": lambda m: m.quantize_weight_percentile_per_channel(wf, axis=0),
        "symmetric": lambda m: m.quantize_weight_symmetric_per_channel(wf),
        "symmetric_axis0": lambda m: m.quantize_weight_symmetric_per_channel(wf, axis=0),
        "range_data": lambda m: _range_data(m, wf),
    }[name]


def _range_data(m, w):
    rd = m.RangeData()
    rd.observe("a", w[:100])
    rd.observe("a", w[100:] * 2)
    rd.observe("b", w[:, :3])
    return rd.data, rd.scale_zp("a")


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat(e)]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in [k] + _flat(x[k])]
    return [x]


@pytest.mark.parametrize("name", ["get_percentiles", "get_percentiles_tails", "range_to_scale",
                                  "quantize_dequantize", "quantize_weight_percentile", "per_channel",
                                  "per_channel_axis0", "symmetric", "symmetric_axis0", "range_data",
                                  "quantize_graph_weights", "mark_weights_uint8"])
def test_quantization_copies_are_bit_exact(name, tmp_path):
    if name in ("quantize_graph_weights", "mark_weights_uint8"):
        from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet

        g = build_unet(TINY, seed=1)
        if name == "quantize_graph_weights":
            excl = [next(k for k, v in g.weights.items() if np.ndim(v) == 2)]
            got = convert_quantize.quantize_graph_weights(g.to_text(), g.weights, exclude_names=excl)
            want = jax_convert_quantize.quantize_graph_weights(g.to_text(), g.weights, exclude_names=excl)
            assert got[0] == want[0] and "uint8[" in got[0]
            assert sorted(got[1]) == sorted(want[1])
            for k in want[1]:
                assert got[1][k].dtype == want[1][k].dtype
                np.testing.assert_array_equal(got[1][k], want[1][k])
        else:
            shapes = {k: np.shape(v) for k, v in g.weights.items()}
            assert convert_quantize.mark_weights_uint8(g.to_text(), shapes) == \
                jax_convert_quantize.mark_weights_uint8(g.to_text(), shapes)
        return
    got, want = _flat(_quant_case(name)(quantization)), _flat(_quant_case(name)(jax_quantization))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y
    if name == "range_data":
        rd = quantization.RangeData()
        rd.data = got_data = _range_data(quantization, np.random.RandomState(4).randn(64, 8).astype(np.float32))[0]
        rd.write(str(tmp_path / "r.txt"))
        assert jax_quantization.RangeData.read(str(tmp_path / "r.txt")).data == \
            quantization.RangeData.read(str(tmp_path / "r.txt")).data
        assert sorted(got_data) == ["a", "b"]


# --------------------------------------------------- single-MatMul sessions
def _sessions(model, weights, x, **cfg):
    """(port output, JAX output, the port's quant routes) of one model."""
    ps = Session(SessionConfig(device=CPU, **cfg),
                 weights_provider=DictWeightsProvider({k: torch.from_numpy(v.copy()) for k, v in weights.items()}))
    js = JaxSession(JaxConfig(**cfg), weights_provider=JaxDict({k: v.copy() for k, v in weights.items()}))
    for s in (ps, js):
        s.read_string(model)
        s.add_tensor("x", x)
    got, want = ps.run()["y"], np.asarray(js.run()["y"], np.float32)
    return got, want, ps._executor()


@pytest.mark.parametrize("flag", [True, False])
def test_session_s8_storage_matches_jax(flag):
    """int8_symmetric_storage: the weight is stored as per-channel s8 and the
    MatMul runs through w8a8_dyn_matmul (flag on) or dequantizes on read
    (flag off), as in the JAX executor (tests/test_qmatmul.py:279-317)."""
    rng = np.random.RandomState(5)
    wf = rng.randn(128, 64).astype(np.float32)
    x = rng.randn(1, 128).astype(np.float32)
    model = "mm:MatMul*input:x(1,128);w.bin(float32:128,64)*output:y(1,64)\n"
    got, want, ex = _sessions(model, {"w.bin": wf}, x, force_uint8_storage_set={"w.bin"},
                              int8_symmetric_storage=True, use_w8a8_dyn_matmul=flag)
    assert _rel(got, want) <= 1e-5
    assert ex.quant_routes == ({"mm": "w8a8_dyn_matmul"} if flag else {})
    w = ex.plan.arg_weights[0]
    assert w.symmetric and w.upload_dtype == torch.int8 and tuple(w.quant[0].shape) == (64,)
    assert _rel(got, x @ wf) < (0.03 if flag else 0.02)


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("source", ["file_uint8", "forced_per_channel"])
def test_session_uint8_weights_match_jax(source, flag):
    """A ``uint8[scale,zp]`` weight from the file, and a float weight forced to
    per-channel uint8: w8_matmul (flag on) or dequantize on read (flag off),
    against the JAX session (tests/test_qmatmul.py:117-142)."""
    rng = np.random.RandomState(11)
    wf = rng.randn(96, 40).astype(np.float32)
    x = rng.randn(3, 5, 96).astype(np.float32)
    if source == "file_uint8":
        wq, scale, zero = quantization.quantize_weight_percentile(wf)
        model = f"mm:MatMul*input:x(3,5,96);w.bin(uint8[{scale},{zero}]:96,40)*output:y(3,5,40)\n"
        weights, cfg = {"w.bin": wq}, {}
    else:
        model = "mm:MatMul*input:x(3,5,96);w.bin(float32:96,40)*output:y(3,5,40)\n"
        weights, cfg = {"w.bin": wf}, {"force_uint8_storage_set": {"w.bin"}, "uint8_per_channel": True}
    got, want, ex = _sessions(model, weights, x, use_w8_matmul=flag, **cfg)
    assert got.shape == (3, 5, 40)
    assert _rel(got, want) <= 1e-5
    assert ex.quant_routes == ({"mm": "w8_matmul"} if flag else {})
    w = ex.plan.arg_weights[0]
    assert w.upload_dtype == torch.uint8 and not w.symmetric
    if source == "forced_per_channel":
        assert tuple(w.quant[0].shape) == tuple(w.quant[1].shape) == (40,)
        wq, scale, zero = quantization.quantize_weight_percentile_per_channel(wf)
    deq = (wq.astype(np.float64) - zero) * scale
    assert _rel(got, x.astype(np.float64) @ deq) < 1e-5


def test_quantized_weights_outside_matmul_dequantize_on_read():
    """A uint8 weight that no quantized kernel takes (an Add operand) is
    dequantized on read, as the JAX executor does."""
    rng = np.random.RandomState(2)
    wf = rng.randn(4, 300).astype(np.float32)
    wq, scale, zero = quantization.quantize_weight_percentile(wf)
    x = rng.randn(4, 300).astype(np.float32)
    model = f"ad:Add*input:x(4,300);w.bin(uint8[{scale},{zero}]:4,300)*output:y(4,300)\n"
    got, want, ex = _sessions(model, {"w.bin": wq}, x)
    assert not ex.quant_routes
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, x + (wq.astype(np.float32) - zero) * scale, rtol=1e-6, atol=1e-6)


# ------------------------------------------- kernel 5: the plan and the predicate
# the six families of the 184 w8_matmul calls of one uint8 SD1.5 UNet step: (M, K, N)
W8_FAMILIES = [
    (4096, 320, 320), (4096, 320, 2560), (4096, 1280, 320),        # 64 x 64 level
    (1024, 640, 640), (1024, 640, 5120), (1024, 2560, 640),        # 32 x 32
    (256, 1280, 1280), (256, 1280, 10240), (256, 5120, 1280),      # 16 x 16
    (64, 1280, 1280), (64, 1280, 10240), (64, 5120, 1280),         # 8 x 8
    (77, 768, 320), (77, 768, 640), (77, 768, 1280),               # cross-attention k / v
    (1, 320, 1280), (1, 1280, 1280), (1, 1280, 320), (1, 1280, 640),  # time projections
]


@pytest.mark.parametrize("m,k,n", W8_FAMILIES)
def test_w8_plan_at_the_unet_step_s_shapes(m, k, n):
    bm, bn, splits = w8_plan(m, k, n)
    assert bm in (64, 128) and bn == 160 and n % bn == 0 and splits >= 1
    assert bm == 64 or m >= 128          # a 128-row tile only where there are rows for it
    nkt = -(-k // TILE_K)
    tiles = -(-m // bm) * (n // bn)
    per = -(-nkt // splits)
    assert (splits - 1) * per < nkt      # no empty split
    if splits > 1:
        assert tiles * splits <= SMS and per >= 4
    else:
        # no split: the tiles occupy more than half the SMs, or K is too short to split
        assert 2 * tiles > SMS or nkt // 4 <= 1


@pytest.mark.parametrize("m,k,n,want", [
    (4096, 320, 2560, (128, 160, 1)),    # 512 tiles: a converted weight tile serves 128 rows
    (4096, 320, 320, (64, 160, 1)),      # 128 tiles of 64 rows rather than 64 of 128
    (256, 1280, 1280, (64, 160, 4)),     # 32 tiles x 4 splits of 5 k-tiles
    (256, 1280, 10240, (128, 160, 1)),
    (1, 1280, 1280, (64, 160, 5)),
    (100, 130, 33, (64, 160, 1)),
])
def test_w8_plan_cases(m, k, n, want):
    assert w8_plan(m, k, n) == want
    if (m, k, n) == (256, 1280, 1280):
        assert want[2] * (m * n + m) * 4 == 5_246_976  # workspace bytes: partial sums and row sums


@pytest.mark.parametrize("dtype,m,k,n,a_ptr,w_ptr,want", [
    (torch.bfloat16, 4096, 320, 320, 0, 0, "wgmma"),
    (torch.float16, 77, 768, 320, 256, 1024, "wgmma"),
    (torch.bfloat16, 1, 16, 16, 0, 0, "wgmma"),
    (torch.bfloat16, 100, 130, 33, 0, 0, "mma"),      # ragged K and N
    (torch.bfloat16, 64, 320, 328, 0, 0, "mma"),      # N % 16 != 0: weight rows are not whole 16-byte pieces
    (torch.bfloat16, 64, 324, 320, 0, 0, "mma"),      # K % 8 != 0
    (torch.bfloat16, 64, 320, 320, 2, 0, "mma"),      # misaligned A
    (torch.float16, 64, 320, 320, 0, 4, "mma"),       # misaligned W
    (torch.float32, 64, 320, 320, 0, 0, "fma"),       # float32 stays full float32
])
def test_w8_variant_is_a_function_of_dtype_shape_and_alignment(dtype, m, k, n, a_ptr, w_ptr, want):
    assert w8_variant(dtype, m, k, n, a_ptr, w_ptr) == want


# ------------------------------------------- kernel 6: the K-major weight
@pytest.mark.parametrize("form", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 176, 33), (16, 96, 257), (17, 176, 33), (77, 2064, 31)])
def test_dyn_twin_kmajor_matches_jax_and_the_kn_twin(m, k, n, dtype, form):
    """The twin on the (N, K) weight gives the (K, N) twin's bits (M on both
    sides of the GEMV limit, odd N, K off the 128-byte k-tile) and the JAX
    kernel's output on the (K, N) weight within the JAX bar."""
    a = np.random.RandomState(m).randn(m, k).astype(np.float32)
    rng = np.random.RandomState(k)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ws = rng.rand(n).astype(np.float32) * 0.02 + 0.001
    ta = torch.from_numpy(a).to(TORCH_DTYPE[dtype])
    w_nk = torch.from_numpy(np.ascontiguousarray(w.T))
    got = w8a8_dyn_matmul(ta, w_nk, torch.from_numpy(ws), weight_nk=True)
    assert torch.equal(got, w8a8_dyn_matmul_reference(ta, torch.from_numpy(w), torch.from_numpy(ws)))
    assert torch.equal(got, w8a8_dyn_matmul_reference(ta, w_nk, torch.from_numpy(ws), weight_nk=True))
    ja = jnp.asarray(a, JAX_DTYPE[dtype])
    if form == "xla":
        want = w8a8_dyn_matmul_xla(ja, jnp.asarray(w), ws)
    else:
        want = jax_dyn_matmul(ja, jnp.asarray(w), ws, interpret=True)
    assert _rel(_port_out(got), want) <= (2e-5 if dtype == "float32" else 1e-2)


def test_dyn_kmajor_needs_k_a_multiple_of_16():
    a, w = torch.randn(2, 40), torch.zeros(8, 40, dtype=torch.int8)
    with pytest.raises(ValueError, match="K % 16"):
        w8a8_dyn_matmul(a, w, 0.1, weight_nk=True)


@pytest.mark.parametrize("m", [1, 16, 17, 128, 512, 1024])
@pytest.mark.parametrize("k,n", LLAMA_KN)
def test_dyn_variant_and_plan_at_the_tinyllama_shapes(m, k, n):
    """Every TinyLlama MatMul takes a K-major form: the GEMV up to M = 16, the
    s8 wgmma pipeline above, its K split never empty, never beyond the SMs,
    never finer than 4 k-tiles and only on 64-row tiles that leave half the
    SMs idle; a (K, N) weight keeps the earlier pair."""
    assert dyn_variant(m, k, n, True, 0) == ("gemv_nk" if m <= 16 else "wgmma")
    assert dyn_variant(m, k, n, False, 0) == ("gemv" if m <= 16 else "mma")
    bm, bn, splits = dyn_plan(m, k, n)
    nkt, tiles = -(-k // 128), -(-m // bm) * -(-n // bn)
    per = -(-nkt // splits)
    assert bm in (64, 128, 256) and bn == 128 and (splits - 1) * per < nkt
    assert splits == 1 or (bm == 64 and 2 * tiles < SMS and tiles * splits <= SMS and per >= 4)


@pytest.mark.parametrize("m,k,n,weight_nk,w_ptr,want", [
    (1, 2048, 256, True, 0, "gemv_nk"),
    (16, 2048, 32003, True, 4096, "gemv_nk"),
    (17, 2048, 32003, True, 0, "wgmma"),
    (1, 2056, 256, True, 0, "refused"),     # K % 16 != 0: rows are not whole 16-byte pieces
    (1024, 2048, 256, True, 8, "refused"),  # a misaligned (N, K) view
    (1024, 2056, 256, False, 8, "mma"),     # a (K, N) weight takes any K and pointer
    (3, 100, 300, False, 1, "gemv"),
])
def test_dyn_variant_cases(m, k, n, weight_nk, w_ptr, want):
    assert dyn_variant(m, k, n, weight_nk, w_ptr) == want


@pytest.mark.parametrize("m,k,n,want", [
    (1024, 2048, 256, (64, 128, 4)),      # k / v projections: 32 tiles x 4 splits of 4 k-tiles
    (1024, 2048, 2048, (128, 128, 1)),    # 128 tiles fill the card
    (1024, 2048, 32003, (256, 128, 1)),   # the LM head: 1004 tiles of 256 rows
    (512, 2048, 2048, (64, 128, 1)),      # 128 tiles of 64 rows: no split
    (128, 5632, 2048, (64, 128, 4)),      # a 100-token prompt's down projection: 32 tiles x 4 splits
])
def test_dyn_plan_cases(m, k, n, want):
    assert dyn_plan(m, k, n) == want


def _tied_s8_net():
    """x -> mm1 (w1) -> mm2 (w2) -> mm3 (w2 again: tied), float weights
    forced to symmetric s8; K of mm1 is 48 (a multiple of 16)."""
    rng = np.random.RandomState(7)
    weights = {"w1.bin": rng.randn(48, 32).astype(np.float32), "w2.bin": rng.randn(32, 32).astype(np.float32)}
    x = rng.randn(1, 5, 48).astype(np.float32)
    model = ("mm1:MatMul*input:x(1,5,48);w1.bin(float32:48,32)*output:h(1,5,32)\n"
             "mm2:MatMul*input:h(1,5,32);w2.bin(float32:32,32)*output:g(1,5,32)\n"
             "mm3:MatMul*input:g(1,5,32);w2.bin(float32:32,32)*output:y(1,5,32)\n")
    return model, weights, x


@pytest.mark.parametrize("cfg,tagged", [
    (dict(use_w8a8_dyn_matmul=True), True),
    (dict(use_w8a8_dyn_matmul=False), False),          # dequantized on read: the file layout
    (dict(use_w8a8_dyn_matmul=True, requires_upcast=lambda t, n: n == "mm1"), False),  # run in float32
])
def test_planner_tags_the_int8_matmul_weights(cfg, tagged):
    """The int8 weights kernel 6 reads upload K-major as (N, K) ('tnk'),
    quantized per output channel before the relayout (the scales stay (N,));
    a tied weight (w2, read by two MatMuls) keeps the file layout; the
    session still equals the JAX package's."""
    model, weights, x = _tied_s8_net()
    common = dict(force_uint8_storage_set={"w1.bin", "w2.bin"}, int8_symmetric_storage=True)
    ps = Session(SessionConfig(device=CPU, **common, **cfg),
                 weights_provider=DictWeightsProvider({k: torch.from_numpy(v.copy()) for k, v in weights.items()}))
    jcfg = {k: v for k, v in cfg.items() if k != "requires_upcast"}
    js = JaxSession(JaxConfig(**common, **jcfg), weights_provider=JaxDict({k: v.copy() for k, v in weights.items()}))
    for s in (ps, js):
        s.read_string(model)
        s.add_tensor("x", x)
    got, want = ps.run()["y"], np.asarray(js.run()["y"], np.float32)
    ex = ps._executor()
    args = {w.name: w for w in ex.plan.arg_weights}
    assert (args["w1.bin"].transform, args["w1.bin"].shape) == (("tnk", (32, 48)) if tagged else (None, (48, 32)))
    assert (args["w2.bin"].transform, args["w2.bin"].shape) == (None, (32, 32))
    assert tuple(args["w1.bin"].quant[0].shape) == (32,)
    if "requires_upcast" not in cfg:
        assert _rel(got, want) <= 1e-5
    dev = ex._resident["w1.bin"][0]
    q, _ = quantization.quantize_weight_symmetric_per_channel(weights["w1.bin"])
    assert np.array_equal(dev.numpy(), q.T if tagged else q)

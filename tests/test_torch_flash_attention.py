"""Port flash attention against the JAX package.

The CUDA kernel cannot run here, so its plain twins
(flash_attention_packed_reference, flash_attention_reference) are held
against the JAX Pallas kernels in interpret mode, and the port's reference
SDPA paths against the JAX ones, all in float32 at rtol = atol = 1e-4 (the bar
of tests/test_flash_attention.py). The kernel itself is compared with the
twins on the card in tests/test_torch_flash_attention_card.py, which imports
no JAX.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from onnxstream_tpu.kernels.flash_attention import flash_attention as jax_flash
from onnxstream_tpu.kernels.flash_attention import flash_attention_packed as jax_flash_packed
from onnxstream_tpu.ops.attention import sdpa_reference as jax_sdpa
from onnxstream_tpu.ops.attention import sdpa_reference_packed as jax_sdpa_packed
from onnxstream_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_packed_reference,
    flash_attention_reference,
    flash_splits,
    flash_variant,
    head_major_problem,
)
from onnxstream_tpu_torch.ops.attention import (
    _use_flash,
    _use_flash_packed,
    sdpa_reference,
    sdpa_reference_packed,
)
from onnxstream_tpu_torch.runtime.config import SessionConfig
from test_torch_flash_attention_card import HM_CASES, _mk_hm

TOL = dict(rtol=1e-4, atol=1e-4)

# name, b, h, hkv, m, n, d, mask, causal: the CASES of tests/test_flash_attention.py
# plus the SD1.5 mid-level head dim d = 80
CASES = [
    ("basic", 1, 2, 2, 128, 128, 64, None, False),
    ("multiblock", 1, 2, 2, 192, 384, 64, None, False),
    ("unaligned", 1, 3, 3, 77, 391, 40, None, False),
    ("gqa", 1, 8, 2, 64, 256, 32, None, False),
    ("mask2d", 1, 2, 2, 70, 260, 64, "2d", False),
    ("maskB", 2, 4, 4, 64, 130, 64, "b", False),
    ("causal", 1, 2, 2, 128, 128, 64, None, True),
    ("decode", 1, 4, 4, 8, 136, 64, None, True),
    ("d80", 1, 2, 2, 96, 200, 80, None, False),
]
NO_MASK = [c for c in CASES if c[7] is None]


def _mk(case):
    """Head-major (b, h, l, d) float32 inputs and an optional additive mask."""
    name, b, h, hkv, m, n, d, mask_kind, causal = case
    rng = np.random.default_rng(42)
    q = rng.standard_normal((b, h, m, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    mask = None
    if mask_kind == "2d":
        mask = np.where(rng.random((m, n)) > 0.3, 0.0, -1e30).astype(np.float32)
        mask[:, 0] = 0.0
    elif mask_kind == "b":
        mask = np.where(rng.random((b, 1, m, n)) > 0.3, 0.0, -1e30).astype(np.float32)
        mask[..., 0] = 0.0
    return q, k, v, mask, causal


def _pack(x):
    """(b, h, l, d) -> packed (b, l, h*d)."""
    b, h, l, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b, l, h * d))


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("case", NO_MASK, ids=[c[0] for c in NO_MASK])
def test_twin_matches_jax_interpret_kernel(case):
    q, k, v, _, causal = _mk(case)
    h = q.shape[1]
    q, k, v = _pack(q), _pack(k), _pack(v)
    want = np.asarray(jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                       causal=causal, block_m=64, block_n=128, interpret=True))
    got = flash_attention_packed_reference(_t(q), _t(k), _t(v), h, causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_zero_valid_key_rows_follow_the_kernel():
    """Causal with m > n: rows past the last key see no valid key. The JAX
    kernel and the port's twin write them as exactly 0; the reference SDPA
    paths of both packages fill with finfo.min and give the mean of V."""
    rng = np.random.default_rng(0)
    h, m, n, d = 2, 8, 4, 8
    q = rng.random((1, m, h * d), dtype=np.float32)
    k = rng.random((1, n, h * d), dtype=np.float32)
    v = rng.random((1, n, h * d), dtype=np.float32)
    want = np.asarray(jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                       causal=True, block_m=8, block_n=128, interpret=True))
    got = flash_attention_packed_reference(_t(q), _t(k), _t(v), h, causal=True).numpy()
    assert np.abs(want[:, : m - n]).max() == 0.0
    assert np.abs(got[:, : m - n]).max() == 0.0
    np.testing.assert_allclose(got, want, **TOL)
    ref = sdpa_reference_packed(_t(q), _t(k), _t(v), h, causal=True).numpy()
    jref = np.asarray(jax_sdpa_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, causal=True))
    np.testing.assert_allclose(ref, jref, **TOL)
    np.testing.assert_allclose(ref[0, 0], v[0].reshape(n, h, d).mean(0).reshape(-1), **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sdpa_reference_packed_matches_jax(case):
    q, k, v, mask, causal = _mk(case)
    h = q.shape[1]
    q, k, v = _pack(q), _pack(k), _pack(v)
    want = np.asarray(jax_sdpa_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                      mask=None if mask is None else jnp.asarray(mask), causal=causal))
    got = sdpa_reference_packed(_t(q), _t(k), _t(v), h, mask=_t(mask), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sdpa_reference_matches_jax(case):
    q, k, v, mask, causal = _mk(case)
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=None if mask is None else jnp.asarray(mask), causal=causal))
    got = sdpa_reference(_t(q), _t(k), _t(v), mask=_t(mask), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sdpa_reference_k_transposed_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 64, 32), dtype=np.float32)
    kt = rng.standard_normal((2, 32, 96), dtype=np.float32)
    v = rng.standard_normal((2, 96, 32), dtype=np.float32)
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(v), k_transposed=True))
    got = sdpa_reference(_t(q), _t(kt), _t(v), k_transposed=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_use_flash_packed_is_false_off_cuda():
    """The predicate admits only CUDA tensors: the CPU (tests) and the meta
    tensors of the planner take sdpa_reference_packed, at SD1.5 site shapes too."""
    cfg = SessionConfig(device=torch.device("cpu"))
    for device in ("cpu", "meta"):
        q = torch.empty(1, 4096, 320, device=device)
        assert not _use_flash_packed(cfg, 8, q, q, q)
        assert not _use_flash_packed(None, 8, q, q, q)


def test_wrapper_on_cpu_is_the_twin_and_counts_nothing():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 24, 2 * 16), dtype=np.float32))
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, q, q, 2, causal=True)
    torch.testing.assert_close(out, flash_attention_packed_reference(q, q, q, 2, causal=True))
    torch.testing.assert_close(flash_attention_packed(q[0], q[0], q[0], 2),
                               flash_attention_packed_reference(q[:1], q[:1], q[:1], 2)[0])
    assert flash_attention_packed.launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "meta"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    q = torch.zeros(1, 16, 2 * 16)
    if bad == "head_dim":
        with pytest.raises(ValueError):
            flash_attention_packed(torch.zeros(1, 16, 2 * 12), torch.zeros(1, 16, 2 * 12),
                                   torch.zeros(1, 16, 2 * 12), 2)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            flash_attention_packed(q, q.double(), q, 2)
    else:
        m = q.to("meta")
        with pytest.raises(ValueError):
            flash_attention_packed(m, m, m, 2)


# the SD VAE mid-block attention: 1 head of d = 512 (4096 tokens at 512 x 512)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m,n", [(256, 256), (77, 300)])
def test_d512_twin_matches_jax_reference(m, n, dtype, tol):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, L, 512), dtype=np.float32) for L in (m, n, n))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_sdpa_packed(*(jnp.asarray(x, jdt) for x in (q, k, v)), 1).astype(jnp.float32))
    got = flash_attention_packed_reference(*(_t(x).to(tdt) for x in (q, k, v)), 1)
    assert got.dtype == tdt and got.shape == (1, m, 512)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # the wrapper takes d = 512 (the CPU computes the twin)
    torch.testing.assert_close(flash_attention_packed(*(_t(x).to(tdt) for x in (q, k, v)), 1), got)


@pytest.mark.parametrize("site,want", [("vae_mid_4096", True), ("vae_tile_1024", False), ("d520", False)])
def test_use_flash_packed_at_the_vae_site(site, want, monkeypatch):
    """The VAE mid-block site passes the JAX size gates (KV 4096 >= 512,
    scores 32 MB >= 8 MB) and now the head-dim limit; the tiled decode's
    32 x 32 tiles (1024 tokens, 2 MB of scores) fall below the gate, as in
    JAX."""
    L, d = {"vae_mid_4096": (4096, 512), "vae_tile_1024": (1024, 512), "d520": (4096, 520)}[site]
    q = torch.empty(1, L, d, device="meta", dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert _use_flash_packed(None, 1, q, q, q) is want


# ---------------------------------------------------------------- head-major
@pytest.mark.parametrize("case", HM_CASES, ids=[c[0] for c in HM_CASES])
def test_head_major_twin_matches_jax_interpret_kernel(case):
    q, k, v, mask, causal, kt = _mk_hm(case)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=None if mask is None else jnp.asarray(mask),
                                k_transposed=kt, causal=causal, block_m=64, block_n=128,
                                interpret=True))
    got = flash_attention_reference(_t(q), _t(k), _t(v), mask=_t(mask), k_transposed=kt,
                                    causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if causal and q.shape[2] > v.shape[2]:
        # rows with no valid key: exactly 0 in both
        assert np.abs(want[:, :, : q.shape[2] - v.shape[2]]).max() == 0.0
        assert np.abs(got[:, :, : q.shape[2] - v.shape[2]]).max() == 0.0
    if mask is not None and not causal:
        # a row masked only by the finite -1e9 is the softmax of the masked
        # scores (not zeroed): here all equal, so the mean of V
        hk = np.repeat(np.arange(v.shape[1]), q.shape[1] // v.shape[1])
        np.testing.assert_allclose(got[:, :, 1], v[:, hk].mean(axis=2), **TOL)


def test_head_major_rank3_is_lifted_like_jax():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 16, 32), dtype=np.float32)
    k = rng.standard_normal((2, 40, 32), dtype=np.float32)
    mask = np.where(rng.random((16, 40)) > 0.2, 0.0, -1e9).astype(np.float32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), mask=jnp.asarray(mask),
                                block_m=64, block_n=128, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(k), mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_packed_twin_is_the_head_major_twin():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4 * 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 30, 2 * 16), dtype=np.float32))
    got = flash_attention_packed_reference(q, k, k, 4, causal=True)
    hm = flash_attention_reference(q.reshape(2, 24, 4, 16).transpose(1, 2),
                                   k.reshape(2, 30, 2, 16).transpose(1, 2),
                                   k.reshape(2, 30, 2, 16).transpose(1, 2), causal=True)
    torch.testing.assert_close(got, hm.transpose(1, 2).reshape(2, 24, 64))


def test_head_major_wrapper_on_cpu_is_the_twin_and_counts_nothing():
    q, k, v, mask, _, _ = _mk_hm(HM_CASES[4])
    before = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    torch.testing.assert_close(got, flash_attention_reference(_t(q), _t(k), _t(v), mask=_t(mask)))
    assert flash_attention.launches == before


def _llama_site(L=1024, T=1024, d=64, device="meta", mask_shape=None, dtype=torch.bfloat16):
    q = torch.empty(1, 32, L, d, device=device, dtype=dtype)
    k = torch.empty(1, 32, T, d, device=device, dtype=dtype)
    mask = torch.empty(*(mask_shape or (1, 1, L, T)), device=device, dtype=dtype)
    return q, k, mask


@pytest.mark.parametrize("bad", ["head_dim_12", "head_dim_512", "float64", "mask_shape", "mask_int",
                                 "q_strided", "gqa_ratio"])
def test_head_major_limits_raise_and_are_excluded_by_the_predicate(bad, monkeypatch):
    """What the kernel cannot take: the wrapper raises (on the CPU too), and
    _use_flash routes it to the reference even on a CUDA tensor (faked here:
    the predicate reads only shapes, dtypes, strides and is_cuda)."""
    q, k, mask = _llama_site()
    v = k
    if bad == "head_dim_12":
        q, k, mask = _llama_site(d=12)
        v = k
    elif bad == "head_dim_512":  # above HEAD_MAJOR_MAX_HEAD_DIM = 256: d = 512 only in the packed form
        q, k, mask = _llama_site(d=512)
        v = k
    elif bad == "float64":
        q, k, mask = _llama_site(dtype=torch.float64)
        v = k
    elif bad == "mask_shape":
        mask = torch.empty(1, 1, 1024, 512, device="meta", dtype=torch.bfloat16)
    elif bad == "mask_int":
        mask = torch.empty(1, 1, 1024, 1024, device="meta", dtype=torch.int32)
    elif bad == "q_strided":
        q = torch.empty(1, 32, 1024, 128, device="meta", dtype=torch.bfloat16)[..., ::2]
    else:
        k = torch.empty(1, 5, 1024, 64, device="meta", dtype=torch.bfloat16)
        v = k
    assert head_major_problem(q, k, v, mask) is not None
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask=mask)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert not _use_flash(None, q, k, v, mask)


@pytest.mark.parametrize("site,want", [
    ("prefill_1024", True), ("prefill_512", True), ("continuation_128x1024", True),
    ("decode_1x1024", False), ("prefill_256", False), ("flash_off", False)])
def test_use_flash_gates_follow_the_jax_predicate(site, want, monkeypatch):
    """KV >= 512 and scores >= 8 MB, as ops/attention.py of the JAX package,
    at the TinyLlama sites (32 heads, d = 64, a (1, 1, L, T) mask)."""
    L, T = {"prefill_1024": (1024, 1024), "prefill_512": (512, 512), "continuation_128x1024": (128, 1024),
            "decode_1x1024": (1, 1024), "prefill_256": (256, 256), "flash_off": (1024, 1024)}[site]
    q, k, mask = _llama_site(L, T)
    cfg = SessionConfig(device=torch.device("cpu"), use_flash_attention=site != "flash_off")
    assert not _use_flash(cfg, q, k, k, mask)  # meta tensors: never the kernel
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert _use_flash(cfg, q, k, k, mask) is want


# ------------------------------------------------------------- the wgmma variant
def _variant_site(case):
    """(q, k, v, mask, k_transposed, form) of a flash_variant case: CPU tensors
    (the choice reads dtypes, shapes, strides and pointers only), bf16, the
    TinyLlama prefill site unless the case says otherwise."""
    b, h, hkv, m, n, d = 1, 32, 32, 1024, 1024, 64
    dt, mdt, kt, form, mask_shape = torch.bfloat16, None, False, "head_major", (1, 1, m, n)
    if case.endswith("_float32"):
        dt = torch.float32
        case = case[: -len("_float32")]
    if case == "gqa_4_kv_heads":
        hkv = 4
    elif case == "tp2_prefill":  # a rank's heads of the TinyLlama prefill at tp = 2
        h = hkv = 16
    elif case == "float32":
        dt = torch.float32
    elif case == "float16_f32_mask":
        dt, mdt = torch.float16, torch.float32
    elif case == "d128_no_mask":
        d, mask_shape = 128, None
    elif case == "d256":
        d = 256
    elif case == "ragged_mask_rows":  # 700 bf16 keys: mask rows of 1400 bytes; 702 float32 keys: 2808
        n = 700 if dt != torch.float32 else 702
        mask_shape = (1, 1, m, n)
    elif case == "mask_broadcast_over_keys":
        mask_shape = (1, 1, m, 1)
    elif case == "k_transposed":
        kt = True
    elif case.startswith("packed"):
        # head-major views of packed (B, L, H * D) tensors, as the packed
        # entry reads them: head stride D, row stride H * D
        form = "packed"
        mask_shape = None
        d = {"packed_d512": 512, "packed_d80": 80, "packed_whisper": 64}.get(case, 40)
        h = hkv = 1 if d == 512 else 8
        m = n = {80: 1024, 64: 1500}.get(d, 4096)
        off = 4 if case == "packed_d40_rows_off_16_bytes" else 0
        packed = [torch.zeros(b, m, h * d + off, dtype=dt)[..., off:] for _ in range(3)]
        q, k, v = (t.view(b, m, h, d).transpose(1, 2) if off == 0 else t.unflatten(-1, (h, d)).transpose(1, 2)
                   for t in packed)
        return q, k, v, None, False, form
    q = torch.zeros(b, h, m, d, dtype=dt)
    if case == "q_rows_off_16_bytes":  # 8 bytes off
        off = 8 // dt.itemsize
        q = torch.zeros(b, h, m, d + 8, dtype=dt)[..., off:off + d]
    k = torch.zeros(b, hkv, d, n, dtype=dt) if kt else torch.zeros(b, hkv, n, d, dtype=dt)
    v = torch.zeros(b, hkv, n, d, dtype=dt)
    mask = None if mask_shape is None else torch.zeros(mask_shape, dtype=mdt or dt)
    return q, k, v, mask, kt, form


@pytest.mark.parametrize("case,want", [
    ("tinyllama_prefill", "wgmma"),          # (1, 32, 1024, 64) + a (1, 1, 1024, 1024) bf16 mask
    ("gqa_4_kv_heads", "wgmma"),             # Hkv < H through the head stride
    ("float16_f32_mask", "wgmma"),           # the mask is read in its own dtype
    ("d128_no_mask", "wgmma"),
    ("ragged_mask_rows", "mma"),             # mask rows not 16-byte granular: not staged
    ("mask_broadcast_over_keys", "mma"),
    ("k_transposed", "mma"),                 # K read by columns
    ("d256", "fma"),                         # head dims above 128
    ("float32", "tf32x3"),                   # the float32 TinyLlama prefill, its (1, 1, 1024, 1024) mask staged
    ("q_rows_off_16_bytes", "fma"),
    ("packed_d40", "wgmma"),                 # the SD1.5 UNet's 8 x 40 site, strided views of (1, 4096, 320)
    ("packed_d80", "wgmma"),                 # its 8 x 80 site, (1, 1024, 640)
    ("packed_d512", "wgmma_wide"),           # the SD VAE's 1 x 512 site, keys split over blocks
    ("packed_d40_float32", "tf32x3"),        # the float32 UNet's sites: three TF32 products a product
    ("packed_d40_rows_off_16_bytes", "fma"),
    ("packed_d80_float32", "tf32x3"),
    ("packed_whisper_float32", "tf32x3"),    # Whisper base's encoder site, (1, 1500, 8 x 64)
    ("tp2_prefill_float32", "tf32x3"),       # a rank's (1, 16, 1024, 64) at tp = 2 with the float32 mask
    ("ragged_mask_rows_float32", "fma"),     # float32 mask rows not 16-byte granular: not staged
    ("k_transposed_float32", "fma"),         # TF32 wgmma reads K-major operands only; K given transposed is not
    ("d256_float32", "fma"),
    ("q_rows_off_16_bytes_float32", "fma"),
])
def test_flash_variant(case, want):
    q, k, v, mask, kt, form = _variant_site(case)
    assert head_major_problem(q, k, v, mask, kt) is None or form == "packed"
    assert flash_variant(q, k, v, mask, k_transposed=kt, form=form) == want
    if mask is None and not kt:  # one dispatcher: the packed entry answers the same
        assert flash_variant(q, k, v, k_transposed=kt, form="packed") == want


@pytest.mark.parametrize("variant,b,m,h,n,kd,sms,want", [
    ("wgmma_wide", 1, 4096, 1, 4096, 512, 132, 2),   # the SD VAE site: 64 query tiles, two splits fill 128 of 132 SMs
    ("wgmma_wide", 2, 77, 1, 300, 512, 132, 10),     # 4 query tiles; at most one split a key tile of 32
    ("wgmma_wide", 1, 100, 2, 40, 512, 132, 2),
    ("wgmma_wide", 1, 16384, 1, 16384, 512, 132, 1),  # 256 query tiles fill the card alone
    ("wgmma_wide", 1, 4096, 1, 4096, 512, 64, 1),
    ("wgmma", 1, 1024, 8, 1024, 80, 132, 2),          # the SD1.5 UNet's d = 80 site: 64 blocks of 128 rows
    ("wgmma", 1, 4096, 8, 4096, 40, 132, 1),          # its d = 40 site: 256 blocks
    ("wgmma", 1, 80, 4, 24, 32, 132, 1),              # 4 blocks, one key tile of 128
    ("mma", 1, 1024, 8, 1024, 80, 132, 1),
    ("tf32x3", 1, 4096, 8, 4096, 40, 132, 1),         # the float32 SD1.5 UNet's d = 40 site: 256 blocks of 128 rows
    ("tf32x3", 1, 1024, 8, 1024, 80, 132, 2),         # its d = 80 site: 64 blocks, key tiles of 32
    ("tf32x3", 1, 1500, 8, 1500, 64, 132, 1),         # Whisper base's encoder site: 96 blocks
    ("tf32x3", 1, 256, 2, 512, 128, 132, 16),         # d = 128: blocks of 64 rows, 16 key tiles of 32
    ("fma", 1, 1024, 8, 1024, 80, 132, 1),
])
def test_flash_splits(variant, b, m, h, n, kd, sms, want):
    assert flash_splits(variant, b, m, h, n, kd, sms) == want


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest with ties
    away from zero, on an int32 view (half of the 13 dropped bits' weight
    added to the magnitude, then those bits cleared)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the tf32x3 kernel forms it: a k8 step
    at a time into a float32 sum, each step hi lo + lo hi + hi hi of the
    split operands (hi = tf32(x), lo = tf32(x - hi)); passes=1 keeps hi hi
    alone, one TF32 product."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            out += ah[..., ks] @ bl[..., ks, :]
            out += al[..., ks] @ bh[..., ks, :]
        out += ah[..., ks] @ bh[..., ks, :]
    return out


@pytest.mark.parametrize("d", [40, 64])
def test_three_pass_tf32_split_meets_the_float32_bar(d):
    """The tf32x3 variant's arithmetic emulated in torch on the CPU (the CUDA
    kernel cannot run here): both products as three TF32 products on split
    operands, the softmax in float32 between them, held to the float32 twin
    at the float32 bar of 1e-4. The error of a single TF32 product is printed,
    not asserted: it is why the variant takes three."""
    b, h, m, n = 1, 2, 300, 260
    rng = np.random.default_rng(18)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in ((b, h, m, d), (b, h, n, d),
                                                                                    (b, h, n, d)))
    twin = flash_attention_reference(q, k, v)
    errs = {}
    for passes in (3, 1):
        s = _tf32_product(q, k.transpose(-1, -2), passes) * (d ** -0.5 * 1.4426950408889634)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        out = _tf32_product(p, v, passes) / p.sum(dim=-1, keepdim=True)
        errs[passes] = (out - twin).abs().max().item()
        if passes == 3:
            torch.testing.assert_close(out, twin, **TOL)
    print(f"d = {d}: max|diff| from the float32 twin, three TF32 products {errs[3]:.3e}, one {errs[1]:.3e}")


def test_flash_variant_packed_form_takes_no_mask():
    q, k, v, mask, kt, _ = _variant_site("tinyllama_prefill")
    with pytest.raises(ValueError, match="packed entry"):
        flash_variant(q, k, v, mask, form="packed")
    with pytest.raises(ValueError, match="form"):
        flash_variant(q, k, v, mask, form="packed_heads")




# ------------------------------------------- flash_packed_nopad: kernel 2's route
NOPAD_CASES = [  # name, b, h, hkv, m, n, d, causal: the SD1.5 UNet's unaligned head dims
    ("d40", 1, 2, 2, 128, 256, 40, False),
    ("d80", 1, 2, 2, 96, 200, 80, False),
    ("d40_gqa_causal", 1, 4, 2, 64, 64, 40, True),
]


@pytest.mark.parametrize("case", NOPAD_CASES, ids=[c[0] for c in NOPAD_CASES])
def test_nopad_route_matches_jax_interpret_kernel(case):
    """flash_attention_packed(nopad=True) on CPU tensors: the head-major
    twin on head-major views, held to JAX's nopad route (the unpadded
    head-major Pallas kernel in interpret mode) at 1e-4; kernel 1's and
    kernel 2's launch counters do not move."""
    _, b, h, hkv, m, n, d, causal = case
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, m, h * d), dtype=np.float32)
    k = rng.standard_normal((b, n, hkv * d), dtype=np.float32)
    v = rng.standard_normal((b, n, hkv * d), dtype=np.float32)
    want = np.asarray(jax_flash_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, causal=causal,
                                       block_m=64, block_n=128, interpret=True, nopad=True))
    before = (flash_attention_packed.launches, flash_attention.launches)
    got = flash_attention_packed(_t(q), _t(k), _t(v), h, causal=causal, nopad=True)
    assert (flash_attention_packed.launches, flash_attention.launches) == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), flash_attention_packed_reference(_t(q), _t(k), _t(v), h,
                                                                             causal=causal).numpy(), **TOL)


def test_nopad_keeps_kernel_1_at_aligned_head_dims_and_raises_where_kernel_2_refuses():
    """d % 128 == 0 keeps the packed form; a head dim above kernel 2's 256
    that kernel 1 takes (264) raises with kernel 2's reason instead of
    quietly keeping kernel 1."""
    q = torch.zeros(1, 16, 2 * 128)
    torch.testing.assert_close(flash_attention_packed(q, q, q, 2, nopad=True),
                               flash_attention_packed_reference(q, q, q, 2))
    q = torch.zeros(1, 16, 264)
    flash_attention_packed(q, q, q, 1)  # kernel 1's twin takes it
    with pytest.raises(ValueError, match="head-major kernel cannot take"):
        flash_attention_packed(q, q, q, 1, nopad=True)


def test_nopad_views_are_what_kernel_2_takes():
    """The head-major views of packed operands at the SD1.5 UNet's sites
    (d = 40, 80, 160): unit last stride, kernel 2's predicate admits them,
    and its dispatcher sends d = 40 and 80 to the wgmma variant."""
    for m, h, d in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        q = torch.empty(1, m, h * d, dtype=torch.bfloat16)
        qh = q.unflatten(-1, (h, d)).transpose(1, 2)
        assert qh.stride() == (m * h * d, d, h * d, 1)
        assert head_major_problem(qh, qh, qh) is None
        want = "wgmma" if d <= 128 else "fma"
        assert flash_variant(qh, qh, qh) == want


def test_head_major_out_takes_a_packed_view_and_checks_it():
    """flash_attention(out=...) writes into a head-major view of a packed
    (B, M, H*Dv) tensor (what the nopad route passes) and returns it; an out
    of another shape or dtype, or without a unit last stride, raises."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 24, 40), dtype=np.float32)) for _ in range(3))
    packed = torch.empty(1, 24, 80)
    view = packed.unflatten(-1, (2, 40)).transpose(1, 2)
    got = flash_attention(q, k, v, out=view)
    assert got.data_ptr() == packed.data_ptr()
    torch.testing.assert_close(packed, flash_attention_reference(q, k, v).transpose(1, 2).reshape(1, 24, 80))
    for bad in (torch.empty(1, 2, 24, 48), torch.empty(1, 2, 24, 40, dtype=torch.float64),
                torch.empty(1, 2, 40, 24).transpose(2, 3)):
        with pytest.raises(ValueError, match="out must be"):
            flash_attention(q, k, v, out=bad)

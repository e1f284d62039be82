"""Port flash attention against the JAX package.

The CUDA kernel cannot run here, so its plain twin
(flash_attention_packed_reference) is held against the JAX Pallas kernel in
interpret mode, and the port's reference SDPA paths against the JAX ones, all
in float32 at rtol = atol = 1e-4 (the bar of tests/test_flash_attention.py).
The kernel itself is compared with the twin on the card (marker ``gpu``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from onnxstream_tpu.kernels.flash_attention import flash_attention_packed as jax_flash_packed
from onnxstream_tpu.ops.attention import sdpa_reference as jax_sdpa
from onnxstream_tpu.ops.attention import sdpa_reference_packed as jax_sdpa_packed
from onnxstream_tpu_torch.kernels.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_reference,
)
from onnxstream_tpu_torch.ops.attention import (
    _use_flash_packed,
    sdpa_reference,
    sdpa_reference_packed,
)
from onnxstream_tpu_torch.runtime.config import SessionConfig

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_matches_twin_on_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, m, n, h, hkv, d, causal in [(1, 77, 391, 3, 3, 40, False), (1, 256, 512, 8, 8, 80, False),
                                       (2, 64, 256, 8, 2, 32, True), (1, 16, 8, 2, 2, 16, True)]:
        q = torch.randn(b, m, h * d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, n, hkv * d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, n, hkv * d, device="cuda", generator=g).to(dtype)
        out = flash_attention_packed(q, k, v, h, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_packed_reference(q, k, v, h, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        if causal and m > n:
            assert out[:, : m - n].abs().max().item() == 0.0

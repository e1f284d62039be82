"""Port flash attention kernels against their plain twins on the card.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there). Every
test carries the ``gpu`` marker and skips without a card. The CPU parity of
the twins with the JAX kernels is in tests/test_torch_flash_attention.py,
which takes its head-major cases from here.
"""

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_packed_reference,
    flash_attention_reference,
    flash_splits,
    flash_variant,
)
from torch_vmap_cases import case as vmap_case, run as vmap_run

# name, b, h, hkv, m, n, d, mask shape (None: no mask), causal, k_transposed
HM_CASES = [
    ("mask_mn", 1, 2, 2, 40, 150, 64, "mn", False, False),
    ("mask_bmn", 2, 2, 2, 40, 150, 32, "bmn", False, False),
    ("mask_11mn", 1, 4, 4, 24, 140, 64, "11mn", False, False),
    ("mask_b1mn", 2, 2, 2, 24, 140, 64, "b1mn", False, False),
    ("mask_bhmn", 2, 2, 2, 24, 140, 64, "bhmn", False, False),
    ("mask_1hmn", 2, 4, 4, 24, 140, 16, "1hmn", False, False),
    ("k_transposed", 1, 2, 2, 40, 150, 64, "11mn", False, True),
    ("causal_m_gt_n", 1, 2, 2, 24, 10, 32, None, True, False),
    ("causal_masked_prefill", 1, 4, 4, 32, 32, 64, "11mn", True, False),
    ("gqa_b2", 2, 8, 2, 24, 140, 32, "b1mn", False, False),
    ("d128", 1, 2, 2, 16, 130, 128, "mn", False, False),
]


def _mask_shape(kind, b, h, m, n):
    return {"mn": (m, n), "bmn": (b, m, n), "11mn": (1, 1, m, n), "b1mn": (b, 1, m, n),
            "bhmn": (b, h, m, n), "1hmn": (1, h, m, n), "m1": (m, 1)}[kind]


def _mk_hm(case):
    """Head-major float32 inputs; the additive mask is 0 / -1e9 (the llama
    graph's values), with row 1 masked entirely by the finite -1e9."""
    name, b, h, hkv, m, n, d, kind, causal, kt = case
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, h, m, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, n, d), dtype=np.float32)
    mask = None
    if kind is not None:
        mask = np.where(rng.random(_mask_shape(kind, b, h, m, n)) > 0.3, 0.0, -1e9).astype(np.float32)
        mask[..., 0] = 0.0
        mask[..., 1, :] = -1e9
    if kt:
        k = np.ascontiguousarray(k.transpose(0, 1, 3, 2))
    return q, k, v, mask, causal, kt


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


# 16-bit outputs: ||out - twin||2 / ||twin||2 at most this, beside the
# elementwise limit. With randn operands an output's rms is about sqrt(e /
# keys), near 2e-2 itself, so the elementwise limit alone would pass a key
# tile dropped or counted twice.
REL_L2 = 1e-2


def _assert_matches_twin(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if out.dtype != torch.float32:
        r = ref.float()
        assert ((out.float() - r).norm() / r.norm()).item() <= REL_L2


# ------------------------------------------------------------ the packed entry
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_d512_kernel_matches_twin_on_card(dtype, tol):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, m, n, causal in [(1, 4096, 4096, False), (2, 77, 300, False), (1, 100, 40, True)]:
        q, k, v = (torch.randn(b, L, 512, device="cuda", generator=g).to(dtype) for L in (m, n, n))
        out = flash_attention_packed(q, k, v, 1, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_packed_reference(q, k, v, 1, causal=causal)
        _assert_matches_twin(out, ref, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_matches_twin_on_card(dtype, tol):
    _card()
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
        _assert_matches_twin(out, ref, tol)
        if causal and m > n:
            assert out[:, : m - n].abs().max().item() == 0.0


# -------------------------------------------------------- the head-major entry
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_head_major_kernel_matches_twin_on_card(dtype, tol):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    for case in HM_CASES:
        q, k, v, mask, causal, kt = (torch.from_numpy(x).cuda().to(dtype) if isinstance(x, np.ndarray) else x
                                     for x in _mk_hm(case))
        out = flash_attention(q, k, v, mask=mask, k_transposed=kt, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, mask=mask, k_transposed=kt, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# edges of the wgmma variant: M under and off the 128-row tile, GQA with Hkv <
# H, every mask broadcast kind, a mask in float32 / float16, causal with M > N
# (rows of exact zeros), head dims 32 / 96 / 128, several key tiles through
# the ring; and the masks the wgmma variant does not stage (rows that are not
# 16-byte granular, a mask broadcast over the keys), which the head-major
# entry sends to the mma variant
WGMMA_CASES = [
    # name, b, h, hkv, m, n, d, mask shape, causal, mask dtype (None: q's), variant
    ("gqa_32_4_11mn", 1, 32, 4, 300, 1024, 64, "11mn", False, None, "wgmma"),
    ("mask_mn_m5", 1, 4, 4, 5, 512, 64, "mn", False, None, "wgmma"),
    ("mask_bmn", 2, 4, 2, 130, 520, 64, "bmn", False, None, "wgmma"),
    ("mask_b1mn_f32", 2, 4, 4, 200, 600, 64, "b1mn", False, torch.float32, "wgmma"),
    ("mask_bhmn_f16", 2, 4, 4, 200, 600, 64, "bhmn", False, torch.float16, "wgmma"),
    ("mask_1hmn_ragged_rows", 2, 4, 4, 200, 700, 64, "1hmn", False, None, "mma"),
    ("mask_m1_over_keys", 1, 4, 2, 130, 520, 64, "m1", False, None, "mma"),
    ("causal_m_gt_n", 1, 4, 4, 80, 24, 32, None, True, None, "wgmma"),
    ("causal_gqa_mask", 2, 8, 2, 300, 520, 64, "11mn", True, None, "wgmma"),
    ("d96_no_mask", 1, 4, 2, 70, 130, 96, None, False, None, "wgmma"),
    ("d128_gqa", 1, 8, 2, 256, 512, 128, "b1mn", False, None, "wgmma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", WGMMA_CASES, ids=[c[0] for c in WGMMA_CASES])
def test_wgmma_variant_matches_twin_on_card(case, dtype):
    _card()
    name, b, h, hkv, m, n, d, kind, causal, mdt, want = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda().to(dtype)
               for s in ((b, h, m, d), (b, hkv, n, d), (b, hkv, n, d)))
    mask = None
    if kind is not None:
        mk = np.where(rng.random(_mask_shape(kind, b, h, m, n)) > 0.3, 0.0, -1e9).astype(np.float32)
        if mk.shape[-1] > 1:
            mk[..., 0] = 0.0
        mask = torch.from_numpy(mk).cuda().to(mdt or dtype)
    assert flash_variant(q, k, v, mask) == want
    out = flash_attention(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_reference(q, k, v, mask=mask, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    if causal and m > n:
        assert out[:, :, : m - n].abs().max().item() == 0.0


# the packed entry on the wgmma variants: the SD1.5 UNet's head dims 40 and 80
# (the 4096-token site cut to 1024 tokens), ragged M and N, GQA, causal with M
# > N (rows of exact zeros), d = 64 / 32 on the generic widths, the SDXL UNet's
# d = 64 sites (10 heads at 4096 tokens, 20 at 1024) at batch 1 and 2 (the
# CFG pair as one run), and the VAE's d = 512 on the wide variant with its keys
# split over blocks (the split's partials meet in a fixed order: a second call
# gives the same bits), at 4096 tokens (512 x 512 images) and 16384 (SDXL's
# 1024 x 1024)
PACKED_WGMMA_CASES = [
    # name, b, m, n, heads, kv heads, d, causal, variant
    ("d40_sd15", 1, 1024, 1024, 8, 8, 40, False, "wgmma"),
    ("d40_ragged_gqa", 2, 77, 300, 8, 4, 40, False, "wgmma"),
    ("d80_sd15", 1, 1024, 1024, 8, 8, 80, False, "wgmma"),
    ("d80_causal_m_gt_n", 1, 200, 150, 2, 2, 80, True, "wgmma"),
    ("d64_gqa_causal", 2, 300, 700, 8, 2, 64, True, "wgmma"),
    ("d32_causal_m_gt_n", 1, 80, 24, 4, 4, 32, True, "wgmma"),
    ("d64_sdxl_4096_b1", 1, 4096, 4096, 10, 10, 64, False, "wgmma"),
    ("d64_sdxl_4096_b2", 2, 4096, 4096, 10, 10, 64, False, "wgmma"),
    ("d64_sdxl_1024_b1", 1, 1024, 1024, 20, 20, 64, False, "wgmma"),
    ("d64_sdxl_1024_b2", 2, 1024, 1024, 20, 20, 64, False, "wgmma"),
    ("d512_vae", 1, 4096, 4096, 1, 1, 512, False, "wgmma_wide"),
    ("d512_vae_sdxl", 1, 16384, 16384, 1, 1, 512, False, "wgmma_wide"),
    ("d512_ragged", 2, 77, 300, 1, 1, 512, False, "wgmma_wide"),
    ("d512_causal_m_gt_n_gqa", 1, 100, 40, 2, 1, 512, True, "wgmma_wide"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", PACKED_WGMMA_CASES, ids=[c[0] for c in PACKED_WGMMA_CASES])
def test_packed_wgmma_variants_match_twin_on_card(case, dtype):
    _card()
    name, b, m, n, h, hkv, d, causal, want = case
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda().to(dtype)
               for s in ((b, m, h * d), (b, n, hkv * d), (b, n, hkv * d)))
    heads = lambda t, hh: t.view(b, t.shape[1], hh, d).transpose(1, 2)
    assert flash_variant(heads(q, h), heads(k, hkv), heads(v, hkv), form="packed") == want
    out = flash_attention_packed(q, k, v, h, causal=causal)
    again = flash_attention_packed(q, k, v, h, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_packed_reference(q, k, v, h, causal=causal)
    _assert_matches_twin(out, ref, 2e-2)
    assert torch.equal(out, again)
    if causal and m > n:
        assert out[:, : m - n].abs().max().item() == 0.0


# ------------------------------------- flash_packed_nopad: kernel 2 on packed operands
NOPAD_CASES = [
    # name, b, m, n, heads, d, variant kernel 2 takes: the SD1.5 UNet's self-attention sites
    # (d = 40 at 4096 tokens, 80 at 1024, 160 at 256), unmasked and non-causal
    ("d40_sd15", 1, 4096, 4096, 8, 40, "wgmma"),
    ("d80_sd15", 1, 1024, 1024, 8, 80, "wgmma"),
    ("d160_sd15", 1, 256, 256, 8, 160, "fma"),
    ("d40_ragged_b2", 2, 77, 300, 8, 40, "wgmma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", NOPAD_CASES, ids=[c[0] for c in NOPAD_CASES])
def test_nopad_route_matches_twin_on_card(case, dtype):
    """flash_attention_packed(nopad=True) at head dims off 128: one launch of
    kernel 2 on head-major views (the packed kernel's counter stays), held to
    the packed twin; a second call gives the same bits."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    name, b, m, n, h, d, want = case
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda().to(dtype)
               for s in ((b, m, h * d), (b, n, h * d), (b, n, h * d)))
    heads = lambda t: t.unflatten(-1, (h, d)).transpose(1, 2)
    assert flash_variant(heads(q), heads(k), heads(v)) == (want if dtype != torch.float32 else
                                                           "tf32x3" if d <= 128 else "fma")
    before = (flash_attention_packed.launches, flash_attention.launches)
    out = flash_attention_packed(q, k, v, h, nopad=True)
    again = flash_attention_packed(q, k, v, h, nopad=True)
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches, flash_attention.launches) == (before[0], before[1] + 2)
    ref = flash_attention_packed_reference(q, k, v, h)
    _assert_matches_twin(out, ref, 1e-4 if dtype == torch.float32 else 2e-2)
    assert torch.equal(out, again)


# ------------------------------------------- tf32x3: the float32 form of both entries
# float32 operands whose rows the wgmma variant would take run the same
# pipeline with every product as three TF32 products of split operands: the
# SD1.5 UNet's d = 40 and 80 (the d = 80 site's keys split over two blocks),
# Whisper base's d = 64 site at 1500 tokens, d = 128 (keys split over 16
# blocks), ragged M and N, GQA, causal with M > N (rows of exact zeros)
PACKED_TF32_CASES = [
    # name, b, m, n, heads, kv heads, d, causal
    ("d40_sd15_1024", 1, 1024, 1024, 8, 8, 40, False),
    ("d40_ragged_gqa", 2, 77, 300, 8, 4, 40, False),
    ("d64_whisper", 1, 1500, 1500, 8, 8, 64, False),
    ("d64_gqa_causal", 2, 300, 700, 8, 2, 64, True),
    ("d80_sd15_split", 1, 1024, 1024, 8, 8, 80, False),
    ("d80_causal_m_gt_n", 1, 200, 150, 2, 2, 80, True),
    ("d128_split", 1, 256, 512, 2, 2, 128, False),
    ("d128_causal_m_gt_n_gqa", 1, 100, 40, 4, 2, 128, True),
    ("d32_causal_m_gt_n", 1, 80, 24, 4, 4, 32, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PACKED_TF32_CASES, ids=[c[0] for c in PACKED_TF32_CASES])
def test_packed_tf32x3_matches_twin_on_card(case):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    name, b, m, n, h, hkv, d, causal = case
    rng = np.random.default_rng(18)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
               for s in ((b, m, h * d), (b, n, hkv * d), (b, n, hkv * d)))
    heads = lambda t, hh: t.view(b, t.shape[1], hh, d).transpose(1, 2)
    assert flash_variant(heads(q, h), heads(k, hkv), heads(v, hkv), form="packed") == "tf32x3"
    if name.endswith("_split"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert flash_splits("tf32x3", b, m, h, n, d, sms) > 1
    out = flash_attention_packed(q, k, v, h, causal=causal)
    again = flash_attention_packed(q, k, v, h, causal=causal)
    torch.cuda.synchronize()
    _assert_matches_twin(out, flash_attention_packed_reference(q, k, v, h, causal=causal), 1e-4)
    assert torch.equal(out, again)
    if causal and m > n:
        assert out[:, : m - n].abs().max().item() == 0.0


HM_TF32_CASES = [
    # name, b, h, hkv, m, n, d, mask shape (None: no mask), causal, mask dtype: the mask staged as the
    # wgmma variant stages it, in float32 (TinyLlama's float32 graph) or bf16
    ("d64_gqa_32_4_f32_mask", 1, 32, 4, 300, 1024, 64, "11mn", False, torch.float32),
    ("d64_bf16_mask_ragged", 2, 4, 2, 130, 520, 64, "bmn", False, torch.bfloat16),
    ("d40_f32_mask_causal_m_gt_n", 1, 4, 4, 80, 48, 40, "mn", True, torch.float32),
    ("d80_bf16_mask_gqa", 1, 4, 2, 200, 600, 80, "b1mn", False, torch.bfloat16),
    ("d128_f32_mask_gqa", 1, 8, 2, 256, 512, 128, "1hmn", False, torch.float32),
    ("d64_no_mask_causal", 1, 4, 4, 300, 700, 64, None, True, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", HM_TF32_CASES, ids=[c[0] for c in HM_TF32_CASES])
def test_head_major_tf32x3_matches_twin_on_card(case):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    name, b, h, hkv, m, n, d, kind, causal, mdt = case
    rng = np.random.default_rng(19)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
               for s in ((b, h, m, d), (b, hkv, n, d), (b, hkv, n, d)))
    mask = None
    if kind is not None:
        mk = np.where(rng.random(_mask_shape(kind, b, h, m, n)) > 0.3, 0.0, -1e9).astype(np.float32)
        mk[..., 0] = 0.0
        mk[..., 1, :] = -1e9
        mask = torch.from_numpy(mk).cuda().to(mdt)
    assert flash_variant(q, k, v, mask) == "tf32x3"
    out = flash_attention(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_reference(q, k, v, mask=mask, causal=causal)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    if causal and m > n:
        assert out[:, :, : m - n].abs().max().item() == 0.0


@pytest.mark.gpu
def test_wgmma_off_keeps_float32_on_fa_fma_kernel():
    """The C entry's wgmma = 0 keeps tf32x3 out, so fa_fma_kernel can be timed
    beside it on the same operands: the kernels each launch runs, read from
    the profiler, and both outputs against the twin."""
    from torch.profiler import ProfilerActivity, profile

    from onnxstream_tpu_torch.kernels import flash_attention as fa

    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 2 * 64), dtype=np.float32)).cuda() for _ in range(3))
    dims, strides = fa._packed_launch(q, k, v, 2, 64, 64)
    ref = flash_attention_packed_reference(q, k, v, 2)
    names = {}
    for wgmma in (True, False):
        out = torch.empty_like(q)

        def launch():
            if wgmma:
                return flash_attention_packed(q, k, v, 2)
            fa._launch(q, k, v, out, None, dims, strides, 0.125, False, wgmma=False)
            return out

        launch()  # the kernel's module loads here, outside the window
        torch.cuda.synchronize()
        for _ in range(3):  # a window the tracer left without any device event is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = launch()
                torch.cuda.synchronize()
            if any(str(e.device_type).endswith("CUDA") for e in prof.key_averages()):
                break
        names[wgmma] = " ".join(e.key for e in prof.key_averages())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert "fa_tf32_kernel" in names[True] and "fa_fma_kernel" not in names[True]
    assert "fa_fma_kernel" in names[False] and "fa_tf32_kernel" not in names[False]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention_packed", "flash_attention"])
def test_vmap_is_one_launch_at_the_folded_batch_on_card(name):
    """The entry point under torch.func.vmap at a site's shapes (mapped and
    unmapped operands, tests/torch_vmap_cases.py): one launch, bit for bit
    with the entry point on the folded operands, within the kernel's bar of
    its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    got = vmap_run(vmap_case(name))
    assert got["launches"] == 1 and got["bit_equal"] and got["within_bar"], got["max_abs_err"]

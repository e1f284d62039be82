"""Weight-quantized matrix products (kernels 5 and 6) against their plain twins on the card.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there). Every
test carries the ``gpu`` marker and skips without a card. The CPU parity of
the twins with the JAX package, the plans and the variant predicates are in
tests/test_torch_qmatmul.py, which takes its dtype table and the TinyLlama
shapes from here.
"""

import pytest
import torch

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
from torch_vmap_cases import case as vmap_case, run as vmap_run

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# (K, N) of the TinyLlama weight MatMuls: q / o, k / v, gate / up, down, the LM head
LLAMA_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32003)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dyn_operands(dev, seed, m, k, n, dtype, per_channel=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, device=dev, generator=gen).to(TORCH_DTYPE[dtype])
    w = torch.randint(-127, 128, (k, n), device=dev, generator=gen, dtype=torch.int8)
    ws = torch.rand(n, device=dev, generator=gen) * 0.02 + 0.001 if per_channel else 0.013
    return a, w, ws


# ---------------------------------------------------------------- kernel 6
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 2048, 256), (1, 2048, 32003), (5, 100, 300), (77, 320, 1280),
                                   (130, 5632, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dyn_kernel_matches_twin_on_card(m, k, n, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(m, k, device=dev, generator=gen).to(TORCH_DTYPE[dtype])
    w = torch.randint(-127, 128, (k, n), device=dev, generator=gen, dtype=torch.int8)
    ws = torch.rand(n, device=dev, generator=gen) * 0.02 + 0.001
    out = w8a8_dyn_matmul(a, w, ws)
    torch.cuda.synchronize()
    ref = w8a8_dyn_matmul_reference(a, w, ws)
    if dtype == "float32":
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


# every TinyLlama shape on both sides of the GEMV limit (M 16 / 17), and
# ragged ones: odd N, K off the 128-byte k-tile, M off the 64-row tile
DYN_KMAJOR_SHAPES = [(m, k, n) for m in (1, 16, 17, 128, 1024) for k, n in LLAMA_KN] + [
    (5, 176, 33), (77, 176, 33), (200, 96, 300), (1024, 2064, 257)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", DYN_KMAJOR_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dyn_kmajor_forms_match_twin_bit_for_bit_on_card(m, k, n, dtype):
    """The (N, K) weight on the GEMV (M <= 16) and on the s8 wgmma pipeline,
    split along K or not: bit for bit with the twin and with the (K, N)
    weight's variants, a second call the same bits."""
    dev = _card()
    a, w, ws = _dyn_operands(dev, 3, m, k, n, dtype)
    w_nk = w.t().contiguous()
    assert dyn_variant(m, k, n, True, w_nk.data_ptr()) == ("gemv_nk" if m <= 16 else "wgmma")
    got = w8a8_dyn_matmul(a, w_nk, ws, weight_nk=True)
    again = w8a8_dyn_matmul(a, w_nk, ws, weight_nk=True)
    kn = w8a8_dyn_matmul(a, w, ws)
    torch.cuda.synchronize()
    ref = w8a8_dyn_matmul_reference(a, w_nk, ws, weight_nk=True)
    assert torch.equal(got, ref) and torch.equal(got, again) and torch.equal(got, kn)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1024, 2048, 256), (128, 2048, 2048), (1024, 2048, 2048), (1024, 2048, 32003)])
def test_dyn_wgmma_split_and_unsplit_k_on_card(m, k, n):
    """The plan splits K at the k / v projections (16 tiles at M = 1024) and
    at M = 128, and not where the tiles fill the card; per-tensor scale, the
    int32 partials summed before the one epilogue: the twin's bits."""
    dev = _card()
    splits = dyn_plan(m, k, n)[2]
    assert (splits > 1) == (n == 256 or m == 128)
    a, w, ws = _dyn_operands(dev, 4, m, k, n, "bfloat16", per_channel=False)
    w_nk = w.t().contiguous()
    got = w8a8_dyn_matmul(a, w_nk, ws, weight_nk=True)
    torch.cuda.synchronize()
    assert torch.equal(got, w8a8_dyn_matmul_reference(a, w_nk, ws, weight_nk=True))


@pytest.mark.gpu
def test_dyn_wgmma_reuses_a_quantized_only_while_it_is_unchanged_on_card():
    """Two products of one activation (as q and k read one) quantize it once;
    after an in-place change of it, or for a new tensor of the same shape,
    the next call quantizes again: every result the twin's bits."""
    dev = _card()
    a, w, ws = _dyn_operands(dev, 6, 256, 2048, 2048, "bfloat16")
    w2 = torch.randint(-127, 128, (256, 2048), device=dev, dtype=torch.int8)
    for step in range(4):
        if step == 2:
            a.mul_(3.0)                  # in place: the version counter moves
        if step == 3:
            a = a.clone() * 0.5          # a new tensor
        for weight in (w.t().contiguous(), w2):
            got = w8a8_dyn_matmul(a, weight, ws if weight.shape[0] == 2048 else 0.01, weight_nk=True)
            torch.cuda.synchronize()
            want = w8a8_dyn_matmul_reference(a, weight, ws if weight.shape[0] == 2048 else 0.01, weight_nk=True)
            assert torch.equal(got, want), step


@pytest.mark.gpu
def test_dyn_kmajor_misaligned_weight_is_refused_on_card():
    """An (N, K) weight view off a 16-byte boundary cannot feed the 16-byte
    loads: refused by the predicate, never run on another variant."""
    dev = _card()
    flat = torch.zeros(256 * 2048 + 16, dtype=torch.int8, device=dev)
    w_nk = flat[4:4 + 256 * 2048].view(256, 2048)
    assert dyn_variant(1, 2048, 256, True, w_nk.data_ptr()) == "refused"
    with pytest.raises(ValueError, match="16-byte aligned"):
        w8a8_dyn_matmul(torch.randn(1, 2048, device=dev), w_nk, 0.01, weight_nk=True)


# ---------------------------------------------------------------- kernel 5
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (64, 320, 320), (77, 768, 320), (100, 130, 33), (1024, 1280, 10240),
    (4096, 320, 2560),     # 128-row tiles, 160-wide, no split
    (256, 1280, 1280),     # 4 splits of 5 k-tiles
    (256, 1344, 1280),     # 21 k-tiles in 4 splits of 6: a ragged last split
    (1, 1280, 1280),       # one row in a 64-row tile, split K
    (200, 1000, 336),      # M not a multiple of the tile, K % 64 != 0, N % 160 != 0
    (130, 16, 16),         # one short k-tile, one 16-column strip
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_w8_kernel_matches_twin_on_card(m, k, n, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(m, k, device=dev, generator=gen).to(TORCH_DTYPE[dtype])
    w = torch.randint(0, 256, (k, n), device=dev, generator=gen, dtype=torch.uint8)
    out = w8_matmul(a, w, 0.013, 117)
    torch.cuda.synchronize()
    ref = w8_matmul_reference(a, w, 0.013, 117)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


@pytest.mark.gpu
def test_w8_misaligned_view_takes_the_masked_kernel_on_card():
    """A weight view that starts 4 bytes off a 16-byte boundary cannot feed
    cp.async: the dispatcher picks the masked mma.sync kernel from the
    pointer, and the result still agrees with the twin."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    m, k, n = 64, 320, 320
    a = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    flat = torch.randint(0, 256, (k * n + 16,), device=dev, generator=gen, dtype=torch.uint8)
    w = flat[4:4 + k * n].view(k, n)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    assert w8_variant(torch.bfloat16, m, k, n, a.data_ptr(), w.data_ptr()) == "mma"
    out = w8_matmul(a, w, 0.013, 117)
    torch.cuda.synchronize()
    ref = w8_matmul_reference(a, w, 0.013, 117)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(256, 1280, 1280), (1, 1280, 1280)])
def test_w8_split_k_sum_gives_the_same_bits_twice_on_card(m, k, n):
    dev = _card()
    assert w8_plan(m, k, n)[2] > 1
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    w = torch.randint(0, 256, (k, n), device=dev, generator=gen, dtype=torch.uint8)
    first, second = w8_matmul(a, w, 0.013, 117), w8_matmul(a, w, 0.013, 117)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["w8a8_dyn_matmul", "w8_matmul"])
def test_vmap_is_one_launch_at_the_folded_batch_on_card(name):
    """The entry point under torch.func.vmap at a site's shapes (mapped and
    unmapped operands, tests/torch_vmap_cases.py): one launch, bit for bit
    with the entry point on the folded operands, within the kernel's bar of
    its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    got = vmap_run(vmap_case(name))
    assert got["launches"] == 1 and got["bit_equal"] and got["within_bar"], got["max_abs_err"]

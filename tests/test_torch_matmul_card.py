"""The small-conv route's product (kernel 9) against its plain twin on the card.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there). Every
test carries the ``gpu`` marker and skips without a card. The CPU parity of
the twin with the JAX package, the plan, the variant predicate and the Conv
rewrite are in tests/test_torch_matmul.py, which takes its product cases from
here.
"""

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch.kernels.matmul import matmul, matmul_plan, matmul_reference, matmul_variant
from torch_vmap_cases import case as vmap_case, run as vmap_run

T = torch.from_numpy

MATMUL_CASES = [
    (64, 1152, 128, False),     # one M block (the 8 x 8 level's shape class)
    (128, 2560, 256, True),     # several K steps, with bias
    (512, 1280, 640, True),     # the 16 x 16 level's 1 x 1 conv class
    (256, 11520, 1280, False),  # a full 9 C sweep (3 x 3 im2col, C = 1280)
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,out_dtype,tol", [(torch.float32, torch.float32, 1e-4), (torch.bfloat16, torch.float32, 1e-3),
                                                 (torch.bfloat16, torch.bfloat16, 2e-2), (torch.float16, torch.float16, 2e-2)])
@pytest.mark.parametrize("m,k,n,bias", MATMUL_CASES + [
    (35, 100, 33, True),          # ragged everything: the masked kernels
    (64, 23040, 1280, True),      # 13 splits of 28 k-tiles, the last of 24
    (64, 4160, 1280, True),       # 65 k-tiles in 13 splits of 5: a ragged last split
    (77, 768, 320, False),        # M not a multiple of the tile, N not of 128
    (200, 1000, 328, True),       # K % 64 != 0: a zero-filled last k-tile; N % 8 == 0 only
    (129, 16, 8, True),           # one short k-tile, one 8-column strip, three 64-row tiles for 129 rows
    (1024, 11520, 1280, True),    # 128-row tiles, no split
    (1024, 5760, 640, True),      # 128-row tiles, 3 splits
])
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_matmul_misaligned_view_takes_the_masked_kernel_on_card(dtype):
    """A that starts 2 bytes off a 16-byte boundary cannot feed cp.async: the
    dispatcher picks the masked mma.sync kernel from the pointer, and the
    result still agrees with the twin."""
    dev = _card()
    rng = np.random.RandomState(5)
    m, k, n = 64, 256, 128
    flat = T(rng.randn(m * k + 8).astype(np.float32)).to(dev, dtype)
    a = flat[1:1 + m * k].view(m, k)
    b = T((0.02 * rng.randn(k, n)).astype(np.float32)).to(dev, dtype)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    assert matmul_variant(dtype, m, k, n, a.data_ptr(), b.data_ptr()) == "mma"
    assert matmul_variant(dtype, m, k, n, flat.data_ptr(), b.data_ptr()) == "wgmma"
    got = matmul(a, b)
    torch.cuda.synchronize()
    want = matmul_reference(a, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2 * max(1.0, want.float().abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 11520, 1280), (256, 4160, 1280), (1024, 5760, 640)])
def test_split_k_sum_gives_the_same_bits_twice_on_card(m, k, n):
    """The split's partials are added in split order by one thread per
    output: no atomics, so two runs of one call agree bit for bit."""
    dev = _card()
    assert matmul_plan(m, k, n)[2] > 1
    rng = np.random.RandomState(6)
    a = T(rng.randn(m, k).astype(np.float32)).to(dev, torch.bfloat16)
    b = T((0.02 * rng.randn(k, n)).astype(np.float32)).to(dev, torch.bfloat16)
    bv = T(rng.randn(n).astype(np.float32)).to(dev)
    first = matmul(a, b, bv, out_dtype=torch.float32)
    second = matmul(a, b, bv, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["matmul"])
def test_vmap_is_one_launch_at_the_folded_batch_on_card(name):
    """The entry point under torch.func.vmap at a site's shapes (mapped and
    unmapped operands, tests/torch_vmap_cases.py): one launch, bit for bit
    with the entry point on the folded operands, within the kernel's bar of
    its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    got = vmap_run(vmap_case(name))
    assert got["launches"] == 1 and got["bit_equal"] and got["within_bar"], got["max_abs_err"]

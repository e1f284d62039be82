"""The GroupNorm kernels (7 and 8) against their plain twins on the card.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there). Every
test carries the ``gpu`` marker and skips without a card. The CPU parity of
the twins with the JAX package, the fusion passes and the predicates are in
tests/test_torch_gn.py, which takes its operands and cases from here.
"""

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch.kernels.gn_conv import (
    gn_conv_plan,
    gn_conv_variant,
    gn_silu_conv,
    gn_silu_conv_reference,
    oihw_to_w9,
)
from onnxstream_tpu_torch.kernels.gn_silu import GnSiluPlan, gn_silu, gn_silu_plan, gn_silu_reference, launch
from torch_vmap_cases import case as vmap_case, run as vmap_run

T = torch.from_numpy


def _gn_inputs(n, c, h, w, groups, seed=0):
    """The operands of tests/test_gn_silu.py ``_mk``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w).astype(np.float32)
    sg = (1.0 + 0.1 * rng.randn(groups)).astype(np.float32)
    sb = (0.05 * rng.randn(groups)).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    return x, sg, sb, gamma, beta


GN_CASES = [
    (1, 64, 8, 8, 32, True),     # C/G = 2, tiny spatial
    (1, 320, 16, 16, 32, True),  # the SD1.5 channel count, C/G = 10
    (2, 40, 4, 4, 8, False),     # batch 2, no SiLU, C/G = 5
    (1, 24, 5, 7, 4, True),      # H W = 35
]
# the cluster form's plans (gn_silu_plan, bf16 / float32; tests/test_torch_gn.py
# holds which K each case reaches): a UNet site, K = 16 / 16, and the VAE's
# 512 KB groups, K = 16 / 16, float32's streaming
GN_SITE_CASES = [(1, 320, 64, 64, 32, True), (1, 128, 256, 256, 32, False)]
GN_CLUSTER_CASES = [
    (1, 1920, 16, 16, 32, True),     # the UNet's 30 KB groups: K = 4 / 16, the whole piece resident
    (1, 640, 32, 32, 32, True),      # K = 8 / 16, the whole piece resident
    (1, 256, 256, 256, 32, True),    # K = 16, a 1 MB group: each CTA streams part of its piece
    (1, 128, 512, 512, 32, True),    # K = 16, a 2 MB group: each CTA streams most of its piece
    (1, 1892, 5, 7, 4, True),        # H W = 35, K = 8 / 16: groups start off 16-byte boundaries
    (2, 104, 37, 35, 8, False),      # batch 2, K = 8 / 16, groups off 16-byte boundaries
]


def _conv_inputs(n, c, g, h, w, o, bias):
    """The operands of tests/test_gn_conv.py ``test_kernel_matches_oracle``."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, c, h, w).astype(np.float32)
    sg = rng.rand(g).astype(np.float32) + 0.5
    sb = rng.randn(g).astype(np.float32)
    gamma = rng.rand(c).astype(np.float32) + 0.5
    beta = rng.randn(c).astype(np.float32)
    wt = 0.1 * rng.randn(o, c, 3, 3).astype(np.float32)
    bv = rng.randn(o).astype(np.float32) if bias else None
    return x, sg, sb, gamma, beta, wt, bv


GN_CONV_CASES = [
    (2, 16, 4, 5, 7, 16, True),   # odd spatial: border masks on every edge
    (1, 32, 8, 8, 8, 24, False),  # no bias, O != C
    (1, 20, 4, 4, 4, 8, True),    # C/G = 5
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _conv_on_card(dev, dtype, n, c, g, h, w, o, bias, w9_offset=0):
    """(kernel output, twin output, the w9 passed) on the card; w9_offset > 0
    passes the weight as a view that many elements into a larger tensor."""
    x, sg, sb, gamma, beta, wt, bv = _conv_inputs(n, c, g, h, w, o, bias)
    args = [T(a).to(dev, dtype) for a in (x, sg, sb, gamma, beta)]
    w9 = T(oihw_to_w9(wt)).to(dev, dtype)
    if w9_offset:
        flat = torch.zeros(w9.numel() + w9_offset, dtype=dtype, device=dev)
        flat[w9_offset:].copy_(w9.reshape(-1))
        w9 = flat[w9_offset:].view(9, o, c)
    b = None if bv is None else T(bv).to(dev, dtype)
    torch.backends.cudnn.allow_tf32 = False
    before = gn_silu_conv.launches
    got = gn_silu_conv(*args, w9, b, groups=g, eps=1e-5)
    torch.cuda.synchronize()
    assert gn_silu_conv.launches == before + 1
    return got, gn_silu_conv_reference(*args, w9, b, g, 1e-5), (args, w9, b)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * max(1.0, want.float().abs().max().item()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
@pytest.mark.parametrize("n,c,h,w,groups,silu", GN_CASES + GN_SITE_CASES + GN_CLUSTER_CASES)
def test_gn_silu_kernel_matches_twin_on_card(n, c, h, w, groups, silu, dtype, tol):
    dev = _card()
    x, *rest = _gn_inputs(n, c, h, w, groups)
    args = [T(x).to(dev, dtype)] + [T(a).to(dev, dtype) for a in rest]
    before = gn_silu.launches
    got = gn_silu(*args, groups, 1e-5, silu)
    torch.cuda.synchronize()
    assert gn_silu.launches == before + 1
    want = gn_silu_reference(*args, groups, 1e-5, silu)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("resident", ["whole", "half", "none"])
def test_gn_silu_kernel_takes_every_cluster_size_on_card(cluster, resident, dtype, tol):
    """Any K from 1 to 16 and any resident share of a piece, forced through
    ``launch`` (the wrapper's plan takes only some of them): the whole piece
    in shared memory, half of it (the rest streamed and read again), none of
    it. H W = 35, so the groups start off 16-byte boundaries."""
    dev = _card()
    n, c, h, w, groups, silu = 1, 1892, 5, 7, 4, True
    vectors = (c // groups) * h * w * torch.empty(0, dtype=dtype).element_size() // 16
    whole = -(-vectors // cluster)
    r = {"whole": whole, "half": whole // 2, "none": 0}[resident]
    x, *rest = _gn_inputs(n, c, h, w, groups, seed=5)
    args = [T(x).to(dev, dtype)] + [T(a).to(dev, dtype) for a in rest]
    got = launch(*args, groups, 1e-5, silu, GnSiluPlan(cluster, r, r * 16 + -(-(c // groups) * 8 // 16) * 16))
    torch.cuda.synchronize()
    want = gn_silu_reference(*args, groups, 1e-5, silu)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,h,w,groups,silu", GN_CLUSTER_CASES)
def test_gn_silu_cluster_gives_the_same_bits_twice_on_card(n, c, h, w, groups, silu):
    """Every CTA of a cluster adds the K partial sums in rank order: no
    atomics, so two calls agree bit for bit."""
    dev = _card()
    assert gn_silu_plan(n, c, h * w, groups, torch.bfloat16).cluster > 1
    x, *rest = _gn_inputs(n, c, h, w, groups, seed=4)
    args = [T(x).to(dev, torch.bfloat16)] + [T(a).to(dev, torch.bfloat16) for a in rest]
    first = gn_silu(*args, groups, 1e-5, silu)
    second = gn_silu(*args, groups, 1e-5, silu)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)])
@pytest.mark.parametrize("n,c,g,h,w,o,bias", GN_CONV_CASES + [(1, 320, 32, 64, 64, 320, True), (1, 320, 32, 64, 64, 4, True),
                                                             (2, 64, 8, 33, 17, 70, False)])
def test_gn_silu_conv_kernel_matches_twin_on_card(n, c, g, h, w, o, bias, dtype, tol):
    dev = _card()
    got, want, _ = _conv_on_card(dev, dtype, n, c, g, h, w, o, bias)
    _close(got, want, tol)


# the wgmma variant at the SD sites and its edges, with the K splits its plan
# takes: the 8 x 8 and 16 x 16 levels (split), the 64 x 64 level (not), the
# UNet's conv_out (O = 4, split), the VAE's conv_out (O = 3) and a 512 x 512
# site; C % 64 != 0 (72: a k-tile past C); batch 2 with H W off the 128-pixel
# tile (tiles straddle two images)
GN_CONV_WGMMA_CASES = [((1, 1280, 32, 8, 8, 1280, True), 13), ((1, 2560, 32, 16, 16, 1280, True), 6),
                       ((1, 320, 32, 64, 64, 320, False), 1), ((1, 320, 32, 64, 64, 4, True), 4),
                       ((1, 128, 32, 512, 512, 3, True), 1), ((1, 128, 32, 512, 512, 128, True), 1),
                       ((1, 72, 8, 9, 9, 40, True), 4), ((2, 64, 8, 33, 17, 70, True), 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case,splits", GN_CONV_WGMMA_CASES)
def test_gn_silu_conv_wgmma_variant_matches_twin_on_card(case, splits, dtype):
    """The channels-last slab and the implicit GEMM on the wgmma pipeline,
    split along K where the plan says so: within 2e-2 of the twin, a second
    call the same bits (the split's partials meet in a fixed order)."""
    dev = _card()
    n, c, g, h, w, o, bias = case
    assert gn_conv_plan(n, c, h, w, o)[1] == splits
    got, want, (args, w9, b) = _conv_on_card(dev, dtype, n, c, g, h, w, o, bias)
    assert gn_conv_variant(dtype, c, w9.data_ptr()) == "wgmma"
    _close(got, want, 2e-2)
    again = gn_silu_conv(*args, w9, b, groups=g, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("case,w9_offset", [((1, 20, 4, 4, 4, 8, True), 0),      # C % 8 != 0
                                            ((1, 320, 32, 16, 16, 320, True), 1)])  # w9 off a 16-byte boundary
def test_gn_silu_conv_mma_variant_takes_what_wgmma_refuses_on_card(case, w9_offset):
    dev = _card()
    n, c, g, h, w, o, bias = case
    got, want, (_, w9, _) = _conv_on_card(dev, torch.bfloat16, n, c, g, h, w, o, bias, w9_offset)
    assert gn_conv_variant(torch.bfloat16, c, w9.data_ptr()) == "mma"
    _close(got, want, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gn_silu", "gn_silu_conv"])
def test_vmap_is_one_launch_at_the_folded_batch_on_card(name):
    """The entry point under torch.func.vmap at a site's shapes (mapped and
    unmapped operands, tests/torch_vmap_cases.py): one launch, bit for bit
    with the entry point on the folded operands, within the kernel's bar of
    its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    got = vmap_run(vmap_case(name))
    assert got["launches"] == 1 and got["bit_equal"] and got["within_bar"], got["max_abs_err"]

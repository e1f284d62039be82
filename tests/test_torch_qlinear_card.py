"""Calibrated W8A8 kernels (kernels 3 and 4) against their plain twins on the card.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there). Every
test carries the ``gpu`` marker and skips without a card. The CPU parity of
the twins with the JAX package is in tests/test_torch_qlinear.py, which takes
its quantization parameters and conv cases from here.
"""

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch.kernels.qconv import qconv, qconv_reference, qconv_variant
from onnxstream_tpu_torch.kernels.qmatmul import qgemm_variant, qmatmul, qmatmul_reference
from torch_vmap_cases import case as vmap_case, run as vmap_run

SA, ZA, SW, ZW = 0.03, 120, 0.02, 128


def _u8(rng, *shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


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


# ------------------------------------------------------- the kernels on a card
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
@pytest.mark.parametrize("m,k,n", [(4096, 512, 512), (1, 64, 8), (63, 48, 3), (77, 112, 257), (129, 16, 1000),
                                   (300, 4608, 130), (200, 96, 136)])
@pytest.mark.parametrize("out", ["float32", "bfloat16", "uint8"])
def test_qmatmul_wgmma_variant_matches_twin_on_card(m, k, n, out):
    """The (N, K) weight on the wgmma pipeline at its edges (M under 64 rows
    and off the 128-row tile, ragged N, K off the 128-byte k-tile, several
    k-tiles through the ring): bit for bit with the twin, a second call the
    same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randint(0, 256, (m, k), device=dev, generator=gen, dtype=torch.uint8)
    w = torch.randint(0, 256, (k, n), device=dev, generator=gen, dtype=torch.uint8)
    w_nk = w.t().contiguous()
    bias = torch.randint(-5000, 5000, (n,), device=dev, generator=gen, dtype=torch.int32)
    kw = dict(out_scale=40.0, out_zero=100) if out == "uint8" else dict(out_dtype=getattr(torch, out))
    assert qgemm_variant(m, k, n, True, a.data_ptr(), w_nk.data_ptr()) == "wgmma"
    got = qmatmul(a, w_nk, SA, ZA, SW, ZW, bias=bias, weight_nk=True, **kw)
    again = qmatmul(a, w_nk, SA, ZA, SW, ZW, bias=bias, weight_nk=True, **kw)
    torch.cuda.synchronize()
    want = qmatmul_reference(a, w, SA, ZA, SW, ZW, bias=bias, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got, again)


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


# kernel 4's wgmma variant: channels-last input and weight (the executor's
# layout for convs with C % 16 == 0); padded borders (a
# window's taps in the padding read za), 1 x 1, stride 2, dilation, ragged
# output channels (off the 128-row tile), pixel counts off the 128-pixel tile
# (the element-wise NCHW store) and on it (16-byte pieces), several k-tiles
QCONV_WGMMA_CASES = [
    dict(x=(1, 512, 16, 16), w=(512, 512, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),
    dict(x=(2, 32, 9, 11), w=(64, 32, 3, 3), strides=(2, 2), pads=(0, 1, 2, 1), dil=(1, 1)),
    dict(x=(1, 48, 10, 13), w=(128, 48, 1, 1), strides=(1, 1), pads=(0, 0, 0, 0), dil=(1, 1)),
    dict(x=(1, 16, 14, 14), w=(64, 16, 3, 3), strides=(1, 1), pads=(2, 2, 2, 2), dil=(2, 2)),
    dict(x=(1, 128, 16, 16), w=(192, 128, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),
    dict(x=(1, 256, 32, 32), w=(128, 256, 1, 1), strides=(1, 1), pads=(0, 0, 0, 0), dil=(1, 1)),
    dict(x=(1, 128, 7, 9), w=(64, 128, 3, 3), strides=(2, 1), pads=(1, 0, 0, 1), dil=(1, 1)),
    dict(x=(1, 128, 20, 20), w=(3, 128, 3, 3), strides=(1, 1), pads=(1, 1, 1, 1), dil=(1, 1)),  # conv_out's O = 3
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", QCONV_WGMMA_CASES)
@pytest.mark.parametrize("out", ["float32", "bfloat16", "uint8"])
def test_qconv_wgmma_variant_matches_twin_on_card(case, out):
    """Bit for bit with the float64 twin and with qgemm_kernel on the NCHW
    copies of the same operands; a second call gives the same bits."""
    dev = _card()
    x, w, bias, kw = _qconv_case(case, seed=6)
    x = torch.from_numpy(x).to(dev).contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(w).to(dev).contiguous(memory_format=torch.channels_last)
    kw.update(bias=torch.from_numpy(bias).to(dev),
              **(dict(out_scale=40.0, out_zero=100) if out == "uint8" else dict(out_dtype=getattr(torch, out))))
    assert qconv_variant(x, w) == "wgmma" and qconv_variant(x.contiguous(), w.contiguous()) == "mma"
    got = qconv(x, w, SA, ZA, SW, ZW, **kw)
    again = qconv(x, w, SA, ZA, SW, ZW, **kw)
    mma = qconv(x.contiguous(), w.contiguous(), SA, ZA, SW, ZW, **kw)
    torch.cuda.synchronize()
    want = qconv_reference(x, w, SA, ZA, SW, ZW, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got, again) and torch.equal(got, mma)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qmatmul", "qconv"])
def test_vmap_is_one_launch_at_the_folded_batch_on_card(name):
    """The entry point under torch.func.vmap at a site's shapes (mapped and
    unmapped operands, tests/torch_vmap_cases.py): one launch, bit for bit
    with the entry point on the folded operands, within the kernel's bar of
    its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    got = vmap_run(vmap_case(name))
    assert got["launches"] == 1 and got["bit_equal"] and got["within_bar"], got["max_abs_err"]

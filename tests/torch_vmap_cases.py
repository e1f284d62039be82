"""The kernels' batching rules on the card: one case a kernel entry point,
shared by the ``gpu`` tests of tests/test_torch_*_card.py and by
``chip_smoke.py``'s ``phase_vmap``. Imports no JAX.

A case is an entry point under ``torch.func.vmap`` at a site's shapes, with
mapped operands beside unmapped ones (a stride-0 q, a broadcast mask, the
weights and scales closed over). ``run`` holds the vmapped call bit for bit
to the same entry point on the folded operands (``kernels.folded``: what the
batching rule hands its one launch) and to the twin within the kernel's bar.
"""

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from onnxstream_tpu_torch import kernels
from onnxstream_tpu_torch.kernels import flash_attention as fa
from onnxstream_tpu_torch.kernels import gn_conv, gn_silu, matmul, qconv, qmatmul

V = 2  # the map size: the CFG pair


@dataclasses.dataclass
class VmapCase:
    kernel: str  # its launch counter (kernels.counted())
    site: str
    fn: Callable  # the entry point on one example
    in_dims: Tuple
    operands: Tuple
    folded: Callable  # the entry point on the folded operands
    twin: Callable  # the twin on the folded operands
    tol: float  # rtol = atol against the twin; 0: bit for bit


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def _u8(gen, shape):
    return torch.randint(0, 256, shape, generator=gen, device=gen.device, dtype=torch.uint8)


def _folded(in_dims, *xs):
    return kernels.folded(V, in_dims, *xs)


def flash_attention_packed(gen) -> VmapCase:
    """The SD15 UNet's 4096-token self-attention site (8 heads of 40), q
    closed over as the first down block's is, k and v mapped."""
    q = _randn(gen, (1, 4096, 320), torch.bfloat16)
    k, v = (_randn(gen, (V, 1, 4096, 320), torch.bfloat16) for _ in range(2))
    dims = (None, 0, 0)
    return VmapCase("flash_attention_packed", "(1, 4096, 8 x 40), q unmapped",
                    lambda q_, k_, v_: fa.flash_attention_packed(q_, k_, v_, 8), dims, (q, k, v),
                    lambda: fa.flash_attention_packed(*_folded(dims, q, k, v), 8),
                    lambda: fa.flash_attention_packed_reference(*_folded(dims, q, k, v), 8), 2e-2)


def flash_attention(gen) -> VmapCase:
    """TinyLlama's prefill site (32 heads of 64 over 1024 tokens, GQA over 4
    kv heads), q / k / v mapped, its causal additive mask unmapped."""
    q = _randn(gen, (V, 1, 32, 1024, 64), torch.bfloat16)
    k, v = (_randn(gen, (V, 1, 4, 1024, 64), torch.bfloat16) for _ in range(2))
    keep = torch.ones(1024, 1024, device=gen.device, dtype=torch.bool).tril()
    mask = torch.zeros(1, 1, 1024, 1024, device=gen.device, dtype=torch.bfloat16).masked_fill(~keep, -1e4)
    dims = (0, 0, 0, None)
    return VmapCase("flash_attention", "(1, 32 / 4, 1024, 64), mask unmapped",
                    lambda q_, k_, v_, m_: fa.flash_attention(q_, k_, v_, mask=m_), dims, (q, k, v, mask),
                    lambda: fa.flash_attention(*_folded(dims[:3], q, k, v), mask=mask),
                    lambda: fa.flash_attention_reference(*_folded(dims[:3], q, k, v), mask=mask), 2e-2)


def w8a8_dyn_matmul(gen) -> VmapCase:
    """A TinyLlama q projection over 512 rows an example, the int8 weight
    K-major, per-channel scales."""
    a = _randn(gen, (V, 512, 2048), torch.bfloat16)
    w = torch.randint(-127, 128, (2048, 2048), generator=gen, device=gen.device, dtype=torch.int8)
    s = torch.rand(2048, generator=gen, device=gen.device) * 1e-3
    return VmapCase("w8a8_dyn_matmul", "(512, 2048) x (2048, 2048) K-major",
                    lambda a_: qmatmul.w8a8_dyn_matmul(a_, w, s, weight_nk=True), (0,), (a,),
                    lambda: qmatmul.w8a8_dyn_matmul(a, w, s, weight_nk=True),
                    lambda: qmatmul.w8a8_dyn_matmul_reference(a, w, s, weight_nk=True), 0.0)


def w8_matmul(gen) -> VmapCase:
    """A uint8 SD15 projection, per-channel scale and zero point."""
    a = _randn(gen, (V, 1, 1024, 1280), torch.bfloat16)
    w = _u8(gen, (1280, 1280))
    s = torch.rand(1280, generator=gen, device=gen.device) * 1e-3
    z = torch.full((1280,), 128.0, device=gen.device)
    return VmapCase("w8_matmul", "(1024, 1280) x (1280, 1280)",
                    lambda a_: qmatmul.w8_matmul(a_, w, s, z), (0,), (a,),
                    lambda: qmatmul.w8_matmul(a, w, s, z),
                    lambda: qmatmul.w8_matmul_reference(a, w, s, z), 2e-2)


def qmatmul_case(gen) -> VmapCase:
    """The W8A8 VAE decoder's attention projection: 4096 tokens of 512, the
    weight K-major, bf16 out."""
    a = _u8(gen, (V, 1, 4096, 512))
    w = _u8(gen, (512, 512))
    args = (0.02, 120, 0.004, 131)
    kw = dict(out_dtype=torch.bfloat16, weight_nk=True)
    return VmapCase("qmatmul", "(4096, 512) x (512, 512) K-major",
                    lambda a_: qmatmul.qmatmul(a_, w, *args, **kw), (0,), (a,),
                    lambda: qmatmul.qmatmul(a, w, *args, **kw),
                    lambda: qmatmul.qmatmul_reference(a, w, *args, **kw), 0.0)


def qconv_case(gen) -> VmapCase:
    """A W8A8 VAE decoder 3 x 3 conv at 64 x 64 and 256 channels, input and
    weight channels-last (the wgmma variant), bias, bf16 out."""
    x = _u8(gen, (V, 1, 64, 64, 256)).permute(0, 1, 4, 2, 3)  # each example channels-last
    w = _u8(gen, (256, 256, 3, 3)).contiguous(memory_format=torch.channels_last)
    bias = _randn(gen, (256,), torch.float32)
    args = (0.02, 120, 0.004, 131)
    kw = dict(bias=bias, pads=(1, 1, 1, 1), out_dtype=torch.bfloat16)
    return VmapCase("qconv", "(256, 64, 64) * (256, 256, 3, 3) channels-last",
                    lambda x_: qconv.qconv(x_, w, *args, **kw), (0,), (x,),
                    lambda: qconv.qconv(*_folded((0,), x), w, *args, **kw),
                    lambda: qconv.qconv_reference(*_folded((0,), x), w, *args, **kw), 0.0)


def gn_silu_case(gen) -> VmapCase:
    """The SD15 UNet's first GroupNorm + SiLU: 320 channels in 32 groups at
    64 x 64."""
    x = _randn(gen, (V, 1, 320, 64, 64), torch.bfloat16)
    sg, sb = _randn(gen, (32,), torch.float32), _randn(gen, (32,), torch.float32)
    gamma, beta = _randn(gen, (320,), torch.float32), _randn(gen, (320,), torch.float32)
    args = (sg, sb, gamma, beta, 32, 1e-5, True)
    return VmapCase("gn_silu", "(320, 64, 64) G32",
                    lambda x_: gn_silu.gn_silu(x_, *args), (0,), (x,),
                    lambda: gn_silu.gn_silu(*_folded((0,), x), *args),
                    lambda: gn_silu.gn_silu_reference(*_folded((0,), x), *args), 2e-2)


def gn_silu_conv_case(gen) -> VmapCase:
    """A config-A UNet site: GroupNorm + SiLU + 3 x 3 conv, 320 -> 320
    channels at 32 x 32."""
    x = _randn(gen, (V, 1, 320, 32, 32), torch.bfloat16)
    sg, sb = _randn(gen, (32,), torch.float32), _randn(gen, (32,), torch.float32)
    gamma, beta = _randn(gen, (320,), torch.float32), _randn(gen, (320,), torch.float32)
    w9, bias = _randn(gen, (9, 320, 320), torch.bfloat16, 0.02), _randn(gen, (320,), torch.bfloat16)
    return VmapCase("gn_silu_conv", "(320, 32, 32) G32 -> 320",
                    lambda x_: gn_conv.gn_silu_conv(x_, sg, sb, gamma, beta, w9, bias, groups=32, eps=1e-5), (0,),
                    (x,),
                    lambda: gn_conv.gn_silu_conv(*_folded((0,), x), sg, sb, gamma, beta, w9, bias, groups=32,
                                                 eps=1e-5),
                    lambda: gn_conv.gn_silu_conv_reference(*_folded((0,), x), sg, sb, gamma, beta, w9, bias, 32,
                                                           1e-5), 2e-2)


def matmul_case(gen) -> VmapCase:
    """The small-conv route's 8 x 8 level: (64, 11520) x (11520, 1280)."""
    a = _randn(gen, (V, 64, 11520), torch.bfloat16)
    b, bias = _randn(gen, (11520, 1280), torch.bfloat16, 0.01), _randn(gen, (1280,), torch.bfloat16)
    return VmapCase("matmul", "(64, 11520) x (11520, 1280)",
                    lambda a_: matmul.matmul(a_, b, bias), (0,), (a,),
                    lambda: matmul.matmul(*_folded((0,), a), b, bias),
                    lambda: matmul.matmul_reference(*_folded((0,), a), b, bias), 2e-2)


CASES: Dict[str, Callable] = {
    "flash_attention_packed": flash_attention_packed, "flash_attention": flash_attention,
    "w8a8_dyn_matmul": w8a8_dyn_matmul, "w8_matmul": w8_matmul, "qmatmul": qmatmul_case, "qconv": qconv_case,
    "gn_silu": gn_silu_case, "gn_silu_conv": gn_silu_conv_case, "matmul": matmul_case,
}


def case(name: str, device="cuda", seed: int = 0) -> VmapCase:
    return CASES[name](torch.Generator(device=device).manual_seed(seed))


def run(c: VmapCase) -> dict:
    """The case's vmapped call (functorch's per-example fallback off): its
    launches of the kernel, whether it equals the entry point on the folded
    operands bit for bit, and its max|diff| from the twin and whether that
    is within the bar (rtol = atol = tol x max(1, max|twin|))."""
    counter = kernels.counted()[c.kernel]
    before = counter.launches
    with kernels.no_vmap_fallback():
        got = torch.func.vmap(c.fn, in_dims=c.in_dims)(*c.operands)
    launches = counter.launches - before
    want, ref = c.folded(), c.twin()
    got = got.reshape(want.shape)
    err = (got.float() - ref.float()).abs().max().item()
    bar = c.tol * max(1.0, ref.float().abs().max().item())
    return {"launches": launches, "bit_equal": bool(torch.equal(got, want)), "max_abs_err": err,
            "within_bar": bool(torch.isfinite(got.float()).all()) and err <= bar, "out": got, "ref": ref}

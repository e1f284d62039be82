"""Kernels 7 and 8 of the PyTorch port beside an earlier revision of their source, on one card.

    python3 tools/torch_gn_conv_ab.py OTHER_CSRC [--kernel 7|8]

OTHER_CSRC is the ``onnxstream_tpu_torch/kernels/csrc`` directory of an
earlier revision, for instance unpacked with
``git archive <rev> onnxstream_tpu_torch/kernels/csrc | tar -x -C DIR``. Its
``gn_conv.cu`` is built with the port's nvcc flags and loaded with ctypes.

Kernel 8 (the default): the other tree's ``ostt_gn_silu_conv`` must have the
22-argument form that precedes the wgmma variant (no slab, plan or partials
workspace). At every ``ostpu.gn_silu_conv`` site of a config-A SD15 UNet run
(45 calls) and of a config-A VAE_SD decode (29 calls) both builds compute one
bf16 call on the same random operands.

Kernel 7: the other tree's ``ostt_gn_silu`` must have the 18-argument form of
the three passes (chunk sums and (A_c, B_c) workspaces, the chunk length).
At every ``ostpu.gn_silu`` site of a config-B SD15 UNet run (61 calls), of a
config-A run (16) and of a VAE_SD decode under ``fuse_groupnorm`` (30) both
builds compute one bf16 call, and the site's plan (K, shared memory a CTA,
clusters the card holds at once) is printed. tools/torch_gn_silu_plans.py
times the same sites under other plans.

For each site the largest difference between the builds is printed, and the
device time of one call of each, in turns (this tree, the other, the other,
this tree; the better of each pair). A run's total is the sum of count x
per-call time. The weights stay in L2 between the timed calls of a site.
The shapes come from the full-width graphs built with lazy weights.

Needs a CUDA card and nvcc. Prints the card's name and power limit first.
"""

import collections
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from onnxstream_tpu_torch.ir import parse_model_txt  # noqa: E402
from onnxstream_tpu_torch.kernels import build  # noqa: E402
from onnxstream_tpu_torch.kernels.gn_conv import MOMENT_CHUNK, gn_conv_variant, gn_silu_conv, workspaces  # noqa: E402
from onnxstream_tpu_torch.kernels.gn_silu import (DTYPE_CODE, active_clusters, gn_silu, gn_silu_plan,  # noqa: E402
                                                  norm_operands)
from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet  # noqa: E402
from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder  # noqa: E402
from onnxstream_tpu_torch.runtime import fusion  # noqa: E402
from onnxstream_tpu_torch.runtime.config import SessionConfig  # noqa: E402

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def other_entries(csrc: str):
    """(ostt_gn_silu, ostt_gn_silu_conv) of the other tree's gn_conv.cu, built into the build cache's directory."""
    out = build.CACHE_DIR / "ab_other" / "libgn_conv_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", str(out), os.path.join(csrc, "gn_conv.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    fns = lib.ostt_gn_silu, lib.ostt_gn_silu_conv
    fns[0].argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _L, _I, _F, _I, _I, _P]
    fns[1].argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]
    for fn in fns:
        fn.restype = _I
    return fns


def other_gn_silu(fn, x, sg, sb, gamma, beta, groups, eps, silu):
    n, c = x.shape[0], x.shape[1]
    (sg, sb, gamma, beta), pcode = norm_operands("other", x, (sg, sb, gamma, beta), (groups, groups, c, c))
    y = torch.empty_like(x)
    partial, ab = workspaces(x, groups)
    rc = fn(DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), sg.data_ptr(), sb.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), pcode, partial.data_ptr(), ab.data_ptr(), n, c, x.numel() // (n * c), groups, eps,
            int(silu), MOMENT_CHUNK, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other build's gn_silu failed with CUDA error {rc}")
    return y


def conv_sites(gb) -> dict:
    """(C, H, W, O) -> calls per run of every fused gn_silu_conv of a graph under config A."""
    cfg = SessionConfig(device="cpu", fuse_gn_conv=True, fuse_groupnorm=True)
    g = fusion.fuse_gn_conv(parse_model_txt(gb.to_text()), cfg, lambda name, dt, shape: np.asarray(gb.weights[name]))
    return collections.Counter((*op.inputs[0].shape[1:], op.outputs[0].shape[1])
                               for op in g.ops if op.op_type == "ostpu.gn_silu_conv")


def gn_sites(gb, **routes) -> dict:
    """(N, C, H, W, silu) -> calls per run of every ostpu.gn_silu of a graph under these routes."""
    cfg = SessionConfig(device="cpu", **routes)
    load = lambda name, dt, shape: np.asarray(gb.weights[name])
    g = fusion.fuse_groupnorm(fusion.rewrite_smallconv(fusion.fuse_gn_conv(parse_model_txt(gb.to_text()), cfg, load),
                                                       cfg, load), cfg, load)
    return collections.Counter((*op.inputs[0].shape, op.attrs.get("silu") == "1")
                               for op in g.ops if op.op_type == "ostpu.gn_silu")


def in_turns(this, other):
    """(this, other) device ms of one call: this, other, other, this; the better of each pair."""
    t = [cs.device_ms_per_call(f) for f in (this, other, other, this)]
    return min(t[0], t[3]), min(t[1], t[2])


def kernel8(fn) -> None:
    gen = torch.Generator(device="cuda").manual_seed(9)
    for label, gb in (("config-A UNet run", build_unet(SD15, lazy_weights=True)),
                      ("config-A VAE decode", build_vae_decoder(VAE_SD, lazy_weights=True))):
        total = {"this": 0.0, "other": 0.0}
        per_run = conv_sites(gb)
        for (c, h, w, o), count in sorted(per_run.items()):
            args = cs._gn_operands(gen, 1, c, h, w, 32, torch.bfloat16, plain_inorm=True)
            w9, bv = cs._w9_operands(gen, c, o, torch.bfloat16)
            this = lambda: gn_silu_conv(*args, w9, bv, groups=32, eps=1e-5)
            other = lambda: other_call(fn, *args, w9, bv, 32, 1e-5)
            diff = (this().float() - other().float()).abs().max().item()
            t_this, t_other = in_turns(this, other)
            total["this"] += count * t_this
            total["other"] += count * t_other
            print(f"{label}: C {c}, {h} x {w} -> {o} (x{count}, {gn_conv_variant(torch.bfloat16, c, w9.data_ptr())}): "
                  f"this tree {t_this:.4f} ms, the other {t_other:.4f} ms, max|this - other| {diff:.3e}")
        print(f"{label}: {sum(per_run.values())} calls, this tree {total['this']:.4f} ms, the other "
              f"{total['other']:.4f} ms (sum of count x per-call device time)")


def kernel7(fn) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    unet, vae = build_unet(SD15, lazy_weights=True), build_vae_decoder(VAE_SD, lazy_weights=True)
    for label, gb, routes in (("config-B UNet run", unet, dict(use_pallas_smallconv=True, fuse_groupnorm=True)),
                              ("config-A UNet run", unet, dict(fuse_gn_conv=True, fuse_groupnorm=True)),
                              ("fuse_groupnorm VAE decode", vae, dict(fuse_groupnorm=True))):
        total = {"this": 0.0, "other": 0.0}
        per_run = gn_sites(gb, **routes)
        for (n, c, h, w, silu), count in sorted(per_run.items()):
            args = (*cs._gn_operands(gen, n, c, h, w, 32, torch.bfloat16, plain_inorm=True), 32, 1e-5, silu)
            this = lambda: gn_silu(*args)
            other = lambda: other_gn_silu(fn, *args)
            diff = (this().float() - other().float()).abs().max().item()
            t_this, t_other = in_turns(this, other)
            total["this"] += count * t_this
            total["other"] += count * t_other
            plan = gn_silu_plan(n, c, h * w, 32, torch.bfloat16)
            print(f"{label}: ({n}, {c}, {h}, {w}) silu={silu} (x{count}; K {plan.cluster}, {plan.smem_bytes} B of "
                  f"shared memory a CTA, {active_clusters(plan, torch.bfloat16, silu)} clusters at once): this tree "
                  f"{t_this:.4f} ms, the other {t_other:.4f} ms, max|this - other| {diff:.3e}")
        print(f"{label}: {sum(per_run.values())} calls, this tree {total['this']:.4f} ms, the other "
              f"{total['other']:.4f} ms (sum of count x per-call device time)")


def main() -> int:
    args = sys.argv[1:]
    which = "8"
    if len(args) == 3 and args[1] == "--kernel" and args[2] in ("7", "8"):
        which = args[2]
        args = args[:1]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    print(cs.card())
    fn7, fn8 = other_entries(args[0])
    if which == "7":
        kernel7(fn7)
    else:
        kernel8(fn8)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernel 8 of the PyTorch port beside an earlier revision of its source, on one card.

    python3 tools/torch_gn_conv_ab.py OTHER_CSRC

OTHER_CSRC is the ``onnxstream_tpu_torch/kernels/csrc`` directory of an
earlier revision, for instance unpacked with
``git archive <rev> onnxstream_tpu_torch/kernels/csrc | tar -x -C DIR``. Its
``gn_conv.cu`` is built with the port's nvcc flags and loaded with ctypes; its
``ostt_gn_silu_conv`` must have the 22-argument form that precedes the wgmma
variant (no slab, plan or partials workspace). Then, at every
``ostpu.gn_silu_conv`` site of a config-A SD15 UNet run (45 calls) and of a
config-A VAE_SD decode (29 calls), the shapes taken from the full-width graphs
built with lazy weights, both builds compute one bf16 call on the same random
operands: their largest difference is printed, and the device time of one
call of each, in turns (this tree, the other, the other, this tree; the
better of each pair). A run's total is the sum of count x per-call time.
The weights stay in L2 between the timed calls of a site.

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
from onnxstream_tpu_torch.kernels.gn_conv import gn_conv_variant, gn_silu_conv  # noqa: E402
from onnxstream_tpu_torch.kernels.gn_silu import DTYPE_CODE, MOMENT_CHUNK, norm_operands, workspaces  # noqa: E402
from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet  # noqa: E402
from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder  # noqa: E402
from onnxstream_tpu_torch.runtime import fusion  # noqa: E402
from onnxstream_tpu_torch.runtime.config import SessionConfig  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def other_entry(csrc: str):
    """ostt_gn_silu_conv of the other tree's gn_conv.cu, built into the build cache's directory."""
    out = build.CACHE_DIR / "ab_other" / "libgn_conv_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", str(out), os.path.join(csrc, "gn_conv.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).ostt_gn_silu_conv
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]
    return fn


def other_call(fn, x, sg, sb, gamma, beta, w9, bias, groups, eps):
    n, c, h, w = x.shape
    o = w9.shape[1]
    (sg, sb, gamma, beta), pcode = norm_operands("other", x, (sg, sb, gamma, beta), (groups, groups, c, c))
    (bias,), bcode = norm_operands("other", x, (bias,), (o,))
    y = torch.empty((n, o, h, w), dtype=x.dtype, device=x.device)
    partial, ab = workspaces(x, groups)
    rc = fn(DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), sg.data_ptr(), sb.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), pcode, w9.data_ptr(), bias.data_ptr(), bcode, partial.data_ptr(), ab.data_ptr(),
            n, c, h, w, o, groups, eps, MOMENT_CHUNK, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other build's gn_silu_conv failed with CUDA error {rc}")
    return y


def sites(gb) -> dict:
    """(C, H, W, O) -> calls per run of every fused gn_silu_conv of a graph under config A."""
    cfg = SessionConfig(device="cpu", fuse_gn_conv=True, fuse_groupnorm=True)
    g = fusion.fuse_gn_conv(parse_model_txt(gb.to_text()), cfg, lambda name, dt, shape: np.asarray(gb.weights[name]))
    return collections.Counter((*op.inputs[0].shape[1:], op.outputs[0].shape[1])
                               for op in g.ops if op.op_type == "ostpu.gn_silu_conv")


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    print(cs.card())
    fn = other_entry(sys.argv[1])
    gen = torch.Generator(device="cuda").manual_seed(9)
    for label, gb in (("config-A UNet run", build_unet(SD15, lazy_weights=True)),
                      ("config-A VAE decode", build_vae_decoder(VAE_SD, lazy_weights=True))):
        total = {"this": 0.0, "other": 0.0}
        per_run = sites(gb)
        for (c, h, w, o), count in sorted(per_run.items()):
            args = cs._gn_operands(gen, 1, c, h, w, 32, torch.bfloat16, plain_inorm=True)
            w9, bv = cs._w9_operands(gen, c, o, torch.bfloat16)
            this = lambda: gn_silu_conv(*args, w9, bv, groups=32, eps=1e-5)
            other = lambda: other_call(fn, *args, w9, bv, 32, 1e-5)
            diff = (this().float() - other().float()).abs().max().item()
            t = [cs.device_ms_per_call(f) for f in (this, other, other, this)]
            t_this, t_other = min(t[0], t[3]), min(t[1], t[2])
            total["this"] += count * t_this
            total["other"] += count * t_other
            print(f"{label}: C {c}, {h} x {w} -> {o} (x{count}, {gn_conv_variant(torch.bfloat16, c, w9.data_ptr())}): "
                  f"this tree {t_this:.4f} ms, the other {t_other:.4f} ms, max|this - other| {diff:.3e}")
        print(f"{label}: {sum(per_run.values())} calls, this tree {total['this']:.4f} ms, the other "
              f"{total['other']:.4f} ms (sum of count x per-call device time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

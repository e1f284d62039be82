"""Kernel 7 of the PyTorch port under other launch plans than its own, on one card.

    python3 tools/torch_gn_silu_plans.py

At every ``ostpu.gn_silu`` site of a config-B SD15 UNet run (61 calls) and of
a VAE_SD decode under ``fuse_groupnorm`` (30 calls), the shapes taken from
the full-width graphs built with lazy weights, one bf16 call on random
operands is launched through ``gn_silu.launch`` under each of these plans:

  plan       ``gn_silu_plan``'s own;
  K<=8       the same rule with clusters of at most 8 CTAs (the portable size);
  resident   the plan's K, each CTA keeping as much of its piece as the 224 KB
             of shared memory hold (one CTA an SM where a piece fills them);
  K=1        one CTA a group, as much resident as fits, the rest streamed;
  K=2..16    every other cluster size with the plan's resident share.

Each output is held to the twin (2e-2 of max(1, max|twin|)). Prints, per
site, the device time of one call under each plan and how many clusters of
it the card holds at once, then each plan's sum of count x per-call time
over the run. The same operands stay in L2 between the timed calls of a
site where they fit.

Needs a CUDA card and nvcc. Prints the card's name and power limit first.
"""

import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from onnxstream_tpu_torch.kernels.gn_silu import (PIECE_RESIDENT_BYTES, RESIDENT_BYTES, GnSiluPlan,  # noqa: E402
                                                  active_clusters, gn_silu_plan, gn_silu_reference, launch)
from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet  # noqa: E402
from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder  # noqa: E402
from torch_gn_conv_ab import gn_sites  # noqa: E402


def plans(n, c, hw, groups):
    """name -> GnSiluPlan of every candidate for a bf16 x (n, c, hw)."""
    own = gn_silu_plan(n, c, hw, groups, torch.bfloat16)
    table = own.smem_bytes - 16 * own.resident
    vectors = (c // groups) * hw * 2 // 16

    def make(k, cap):
        resident = min(-(-vectors // k), cap // 16)
        return GnSiluPlan(k, resident, 16 * resident + table)

    out = {"plan": own, "K<=8": make(min(own.cluster, 8), PIECE_RESIDENT_BYTES),
           "resident": make(own.cluster, RESIDENT_BYTES - table), "K=1": make(1, RESIDENT_BYTES - table)}
    for k in (2, 4, 8, 16):
        if vectors - 1 >= k:
            out[f"K={k}"] = make(k, PIECE_RESIDENT_BYTES)
    return out


def main() -> int:
    if len(sys.argv) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    print(cs.card())
    gen = torch.Generator(device="cuda").manual_seed(11)
    for label, gb, routes in (("config-B UNet run", build_unet(SD15, lazy_weights=True),
                               dict(use_pallas_smallconv=True, fuse_groupnorm=True)),
                              ("fuse_groupnorm VAE decode", build_vae_decoder(VAE_SD, lazy_weights=True),
                               dict(fuse_groupnorm=True))):
        totals = collections.defaultdict(float)
        per_run = gn_sites(gb, **routes)
        for (n, c, h, w, silu), count in sorted(per_run.items()):
            args = (*cs._gn_operands(gen, n, c, h, w, 32, torch.bfloat16, plain_inorm=True), 32, 1e-5, silu)
            ref = gn_silu_reference(*args)
            top = max(1.0, ref.float().abs().max().item())
            times = {}
            for name, plan in plans(n, c, h * w, 32).items():
                err = (launch(*args, plan).float() - ref.float()).abs().max().item()
                if err > 2e-2 * top:
                    raise SystemExit(f"({n}, {c}, {h}, {w}) under {name} {plan}: max|diff| {err:.3e}")
                times[name] = cs.device_ms_per_call(lambda: launch(*args, plan))
                at_once = active_clusters(plan, torch.bfloat16, silu)
                print(f"{label}: ({n}, {c}, {h}, {w}) silu={silu} x{count} {name} (K {plan.cluster}, "
                      f"{plan.resident * 16} B resident, {at_once} clusters at once): {times[name]:.4f} ms", flush=True)
            for name in ("plan", "K<=8", "resident", "K=1"):
                totals[name] += count * times[name]
            totals["best of all"] += count * min(times.values())
        print(f"{label}: {sum(per_run.values())} calls, sum of count x per-call device time: "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Streamed SD15 UNet runs with the weight conversion on the host or on the
card, in turns, on one card.

    python3 tools/torch_stream_ab.py [--budget-mb 128] [--runs 3] [--turns 2]

Writes the SD15 UNet (seed 0) as ``unet_fp16/`` (float16 .bin files) to a
temporary folder, runs it in bf16 once resident, then streamed under the
native ``prefetch`` at ``--budget-mb`` in two ways, in turns:

  host   the provider is taken as one that keeps converted weights
         (``keeps_updates`` set on the instance): each float16 weight is
         converted to bf16 on the host, then copied to the card;
  card   as the executor does for the native prefetcher: the float16 bytes
         are copied to the card and converted there, on the copy stream.

Each variant's warm runs (after one run that plans and warms) print their
wall time, and every output is held bit for bit to the resident run's.
Prints the card's name and power limit first.
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from onnxstream_tpu_torch import Session, SessionConfig  # noqa: E402
from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--budget-mb", type=int, default=128)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args()
    print(f"card: {cs.card()}")
    root = tempfile.mkdtemp(prefix="ostt_stream_ab_")
    try:
        build_unet(SD15, seed=0).save(os.path.join(root, "unet_fp16"), float16=True)
        model = os.path.join(root, "unet_fp16", "model.txt")
        req = cs._requests(SD15, 0)[0]

        def session(budget: int, host: bool) -> Session:
            s = Session(SessionConfig(compute_dtype="bfloat16", hbm_budget_bytes=budget,
                                      device=torch.device("cuda:0")), weights_provider_name="prefetch")
            s.read_file(model)
            for k, v in req.items():
                s.add_tensor(k, v)
            if host:
                s.provider.keeps_updates = True
            return s

        ref_s = session(0, False)
        ref = ref_s.run()["out_sample"]
        ref_s.close()
        del ref_s
        for turn in range(args.turns):
            for label in ("host", "card"):
                s = session(args.budget_mb << 20, label == "host")
                s.run()
                walls = []
                for _ in range(args.runs):
                    out, ms = cs._timed(lambda: s.run()["out_sample"])
                    walls.append(ms)
                    if not np.array_equal(out, ref):
                        raise SystemExit(f"{label}: the streamed output differs from the resident run")
                ex = s._executor()
                print(f"turn {turn} conversion on the {label}: {len(ex.segments)} segments, warm runs "
                      f"{', '.join(f'{w:.1f}' for w in walls)} ms (median {np.median(walls):.1f}), host conversions "
                      f"{ex.host_conversions} over {args.runs + 1} runs, outputs bit for bit with the resident run")
                s.close()
                del s, ex
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

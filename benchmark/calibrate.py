#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from:
``python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --controls
3``.

For each seed, as a run of that seed would: the program is built with the
seed's weights, serves the two warm-up requests and then the traffic's first
``check_requests`` requests; its state is freed, and the plain reference
runs the same requests. The program's reading of a seed is the largest gap
over its requests (``harness/check.py``). On the first ``--controls`` seeds
the control, the reference computed in float8 (``reference/ops.py``), is
put in the program's place and read the same way. One JSON line a seed,
then the summary: the lower reading (the largest of the program's) and the
upper one (the smallest of the control's), number by number."""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.harness import check, spec  # noqa: E402
from benchmark.harness.main import WARMUP_INDEX, cache_dirs, require_cards  # noqa: E402
from benchmark.harness.trace import Spans  # noqa: E402
from benchmark.harness.traffic import Requests  # noqa: E402


def worst(readings):
    return {k: max(r[k] for r in readings) for k in readings[0]}


def main(argv, require=require_cards) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--controls", type=int, default=3, help="seeds on which the control runs too")
    ap.add_argument("--control", default="float8")
    args = ap.parse_args(argv)
    cache_dirs()
    cell = spec.load_cell(spec.ROOT, args.workload)
    device = require(int(cell.workload["chips"]))
    fam = spec.family(cell)
    lower, upper = {}, {}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        reqs = Requests(cell.traffic, seed)
        system = fam.System(cell, seed, device, Spans())
        system.serve(reqs[WARMUP_INDEX])
        system.serve(reqs[WARMUP_INDEX + 1])
        picks = [reqs[i] for i in range(int(cell.traffic["check_requests"]))]
        served = [system.serve(r) for r in picks]
        host, vocab = system.weights, system.vocab
        system.release()
        ctl = fam.reference(cell, host, picks, vocab, device, args.control)[0] if k < args.controls else []
        ref, decoded = fam.reference(cell, host, picks, vocab, device, served=served + ctl)
        got = [check.gaps(*a) for a in zip(served, ref, decoded)]
        row = {"seed": seed, "program": worst(got), "requests": got}
        for n, v in row["program"].items():
            lower[n] = max(lower.get(n, 0.0), v)
        if ctl:
            got = [check.gaps(*a) for a in zip(ctl, ref, decoded[len(served):])]
            row["control"], row["control_requests"] = worst(got), got
            for n, v in row["control"].items():
                upper[n] = min(upper.get(n, float("inf")), v)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del host, system
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"workload": args.workload, "device": kind, "control": args.control,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""One run of one cell: ``python benchmark/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``.

Set-up builds the program with the benchmark's weights and serves two
warm-up requests, the eager first one and the capturing second one. The
window then serves the cell's requests in a closed loop, one client at batch
1, for ``--seconds``; the request that is open when the time is up is
finished and counted. With ``--trace 1`` a profiler window over a few more
requests follows. Once the windows have closed and the peak memory is read,
the program's state is freed and a sample of the window's requests, drawn
from the seed, is run again through the plain reference and compared.

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key."""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import check, spec
from benchmark.harness.trace import Spans, Trace, profile
from benchmark.harness.traffic import Requests

FORBIDDEN = ("jax", "jaxlib", "flax", "onnxstream_tpu")
WARMUP_INDEX = 1 << 40  # warm-up and traced requests come from index ranges of their own
TRACED_INDEX = 1 << 41
SAMPLE_STREAM = 1 << 42


@dataclasses.dataclass
class Record:
    """What a metric reader reads."""

    cell: spec.Cell
    setup_s: float
    spans: Spans
    window: tuple  # (start, end) on the host clock
    latencies: List[float]  # seconds, math.inf for a failed request
    completed: int
    peak_bytes: int
    trace: Optional[Trace] = None
    family: object = None
    kernel1_launches: Optional[float] = None  # a request, over the window, from the port's counters
    specs: Optional[dict] = None  # the parameters' shapes, model by model (traced runs)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def window_spans(self, name: str):
        return self.spans.within(name, *self.window)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (each is read when first used, after this)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(spec.ROOT, ".cache", sub)
    os.environ["USE_FLAX"] = "0"


def require_cards(chips: int) -> torch.device:
    """The first card, or exit 2 where there is no card or too few."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA card(s); torch sees {n}: no result", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda:0")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel1_count() -> int:
    from onnxstream_tpu_torch import kernels

    c = kernels.launch_counts()
    return c.get("flash_attention", 0) + c.get("flash_attention_packed", 0)


def main(argv: List[str], t0: float, require=require_cards) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()

    cell = spec.load_cell(spec.ROOT, args.workload)
    device = require(int(cell.workload["chips"]))
    fam = spec.family(cell)
    spans = Spans(sync=("decode",) if args.trace else ())
    reqs = Requests(cell.traffic, args.seed)

    system = fam.System(cell, args.seed, device, spans)
    with spans.span("first_request"):
        system.serve(reqs[WARMUP_INDEX])
    with spans.span("capture"):
        system.serve(reqs[WARMUP_INDEX + 1])
    _sync(device)
    captures = system.captures()
    k1_before = kernel1_count()
    if device.type == "cuda":
        # the allocator's cached free blocks go; what stays reserved is the weights and the graphs' pools
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    outputs: Dict[int, dict] = {}
    latencies: List[float] = []
    errors: List[str] = []
    w0 = time.perf_counter()
    setup_s = w0 - t0
    i = 0
    while time.perf_counter() - w0 < args.seconds:
        start = time.perf_counter()
        try:
            with spans.span("request"):
                outputs[i] = system.serve(reqs[i])
            latencies.append(time.perf_counter() - start)
        except Exception:  # noqa: BLE001 - a failed request counts as failed and beyond every percentile
            latencies.append(math.inf)
            errors.append(traceback.format_exc(limit=3))
        i += 1
    _sync(device)
    w1 = time.perf_counter()
    # reserved, not allocated: a CUDA graph's activations live in its pool, which the allocator counts as
    # reserved only (allocated reads the weights and the graphs' outputs alone)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    done = len(outputs)
    k1 = (kernel1_count() - k1_before) / done if done else None
    if system.captures() != captures:
        print(f"note: {system.captures() - captures} device program(s) captured inside the window", file=sys.stderr)

    rec = Record(cell=cell, setup_s=setup_s, spans=spans, window=(w0, w1),
                 latencies=latencies, completed=done, peak_bytes=peak, family=fam, kernel1_launches=k1)
    if args.trace:
        def traced(k: int) -> None:
            with spans.span("request"):
                system.serve(reqs[TRACED_INDEX + k])
        rec.trace = profile(traced, int(cell.traffic.get("traced_requests", 3)), spans)
        rec.specs = system.specs

    # judge a sample of the window's requests once the program's state is freed
    rng = np.random.default_rng([int(args.seed) & ((1 << 64) - 1), SAMPLE_STREAM])
    pool = sorted(outputs)
    picks = sorted(rng.choice(pool, size=min(int(cell.traffic["check_requests"]), len(pool)), replace=False)) \
        if pool else []
    host, vocab = system.weights, system.vocab
    system.release()
    served = [outputs[int(k)] for k in picks]
    refs, decoded = fam.reference(cell, host, [reqs[int(k)] for k in picks], vocab, device, served=served)
    readings = [check.gaps(s, r, d) for s, r, d in zip(served, refs, decoded)]
    numbers = check.judge(readings, cell.limits["limits"])
    correct = bool(done) and not errors and check.passed(numbers)

    metrics_spec = cell.per_layer if args.trace else cell.end_to_end
    readers = spec.readers(metrics_spec)
    metrics = {}
    for m in metrics_spec:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"modules of the reference package or of JAX are loaded: {bad}: no result", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(latencies), "failed": len(latencies) - done,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"], dev["window_s"] = rec.trace.busy_s, rec.trace.window_s
        top = sorted(rec.trace.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(rec.trace.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, (_, s) in top],
                               "idle_gaps": [[f"idle in {n}", s] for n, s in gaps]}
        if not rec.trace.complete:
            print(f"note: the profiler window lacks replayed kernel nodes {dict(list(rec.trace.missing.items())[:3])};"
                  " the metrics that need the whole window are left out", file=sys.stderr)
    result["check"] = numbers
    for e in errors[:3]:
        print(e, file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, v in numbers.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0

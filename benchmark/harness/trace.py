"""Spans that the benchmark records around its calls into the program, and
the reading of one profiler window over a few requests.

A span is (start, end) on the host's clock under a name. While a profiler
window runs, each span is also a ``record_function`` annotation named
``bench:<name>``, so the device's idle gaps can be named by what the host
was doing. The window's device time is the union of the intervals of its
kernels, copies and sets; its length runs from the first request's start to
the last one's end on the profiler's clock."""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

ATTEMPTS = 3


class Spans:
    """``sync``: the spans whose start waits for the card first, so that a
    span after asynchronous work (the step replays before the decode) does
    not take that work's device time as its own. A traced run sets it; the
    timed runs leave it empty."""

    def __init__(self, sync=()):
        self.records: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        self.profiling = False
        self.sync = set(sync)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if name in self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        start = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function("bench:" + name):
                yield
        else:
            yield
        self.records[name].append((start, time.perf_counter()))

    def wrap(self, name: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return spanned

    def within(self, name: str, start: float, end: float) -> List[Tuple[float, float]]:
        return [(a, b) for a, b in self.records.get(name, ()) if a >= start and b <= end]


@dataclasses.dataclass
class Trace:
    requests: int
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]  # device op name -> (count, seconds)
    idle_by_span: Dict[str, float]
    complete: bool  # every kernel node of the graphs replayed in the window was traced
    missing: Dict[str, Tuple[int, int]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_events(events, replayed: Dict[str, int], kernel_name: Callable[[str], str], requests: int) -> Trace:
    """A ``Trace`` from a profiler's events (``prof.events()``): device
    events by ``device_type``, the benchmark's annotations by name."""
    dev, spans = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("bench:"):
            if "CUDA" not in str(e.device_type):
                spans.append((start, end, e.name[6:]))
        elif "CUDA" in str(e.device_type) and end > start:
            dev.append((start, end, e.name))
    reqs = [(a, b) for a, b, n in spans if n == "request"]
    if not reqs:
        return Trace(requests, 0.0, 0.0, {}, {}, False, {})
    w0, w1 = min(a for a, _ in reqs), max(b for _, b in reqs)
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in dev])
    ops: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    got: Dict[str, int] = collections.Counter()
    for a, b, n in dev:
        ops[n][0] += 1
        ops[n][1] += (b - a) / 1e6
        got[kernel_name(n)] += 1
    # idle gaps, each named by the innermost benchmark span open at its start
    spans.sort()
    starts = [a for a, _, _ in spans]
    idle: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        open_ = [(a, b, n) for a, b, n in spans[:bisect.bisect_right(starts, gs)] if b > gs]
        name = max(open_, key=lambda sp: (sp[0], -sp[1]))[2] if open_ else "outside the requests"
        idle[name] += (ge - gs) / 1e6
    missing = {k: (got.get(k, 0), n) for k, n in replayed.items() if got.get(k, 0) < n}
    return Trace(requests, (w1 - w0) / 1e6, sum(b - a for a, b in busy) / 1e6,
                 {n: (c, s) for n, (c, s) in ops.items()}, dict(idle), not missing, missing)


def profile(run_one: Callable[[int], None], requests: int, spans: Spans) -> Trace:
    """Profile ``requests`` calls of ``run_one(k)`` after one that warms the
    tracer up; taken again, up to ``ATTEMPTS`` windows, while the window
    lacks kernel nodes of the graphs replayed in it."""
    from torch.profiler import ProfilerActivity, schedule

    from onnxstream_tpu_torch import kernels

    trace: Optional[Trace] = None
    k = 0
    for _ in range(ATTEMPTS):
        sched = schedule(wait=0, warmup=1, active=requests, repeat=1)
        spans.profiling = True
        try:
            with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                        schedule=sched) as prof:
                for i in range(requests + 1):
                    if i == 1:
                        before = dict(kernels.replayed_nodes)
                    run_one(k)
                    k += 1
                    prof.step()
        finally:
            spans.profiling = False
        replayed = {n: c - before.get(n, 0) for n, c in kernels.replayed_nodes.items() if c > before.get(n, 0)}
        trace = read_events(prof.events(), replayed, kernels.kernel_name, requests)
        if trace.complete:
            break
    return trace

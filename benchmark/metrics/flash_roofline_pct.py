"""Kernel 1's (the flash attention kernel's) share of its roofline over the
profiler's window: the least time the card could take for the calls (the
larger of their operations at the bf16 peak and their bytes at the memory
rate, from the benchmark's own count at the configuration's attention sites)
over the kernel's device time, found by the entry-kernel names the port
registers. Silent where the launches the window and the port's counters
show differ from the sites counted, or where the window lacks replayed
kernels."""

from benchmark.harness.roofline import bound_s


def read(rec):
    t = rec.trace
    if t is None or not t.complete or not t.requests:
        return None
    from onnxstream_tpu_torch import kernels

    kernels.counted()
    entry = set(kernels._ENTRY["flash_attention"])
    sites = rec.family.kernel1_sites(rec.cell)
    calls = sum(s.calls for s in sites)
    count = sum(c for name, (c, _) in t.ops.items() if kernels.kernel_name(name) in entry)
    secs = sum(s for name, (_, s) in t.ops.items() if kernels.kernel_name(name) in entry)
    if not calls or count != calls * t.requests or rec.kernel1_launches != calls or secs <= 0:
        return None
    least = t.requests * sum(s.calls * bound_s(s.ops, s.bytes) for s in sites)
    return 100.0 * least / secs

"""Device time a request of PyTorch's own elementwise, copy and reduction
kernels (the ``at::native`` kernels), from the profiler's window: what a
fusion would take away. Silent where the window lacks replayed kernels."""


def read(rec):
    t = rec.trace
    if t is None or not t.complete or not t.requests or not t.ops:
        return None
    return 1e3 * sum(s for name, (_, s) in t.ops.items() if "at::native" in name) / t.requests

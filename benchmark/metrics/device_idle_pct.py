"""Share of the profiler's window in which no kernel, copy or set runs on
the card: one minus the union of their intervals over the window."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0 or not t.complete:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""90th percentile (nearest rank) of all the window's request latencies; a
failed request counts as beyond it."""

import math


def read(rec):
    lat = sorted(rec.latencies)
    if not lat:
        return None
    v = lat[math.ceil(0.9 * len(lat)) - 1]
    return 1e3 * v if math.isfinite(v) else None

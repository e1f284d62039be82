"""The span around set-up's first request, which runs op by op: planning
and per-op dispatch, kernels built or loaded."""


def read(rec):
    s = rec.spans.records.get("first_request")
    return s[0][1] - s[0][0] if s else None

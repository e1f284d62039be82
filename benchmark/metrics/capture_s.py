"""The span around set-up's second request, which captures the CUDA
graphs."""


def read(rec):
    s = rec.spans.records.get("capture")
    return s[0][1] - s[0][0] if s else None

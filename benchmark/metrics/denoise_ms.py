"""Per request of the window: from the request's start to its decode's
start, which in a traced run waits for the card (the encodings, the
per-step stack, the step replays), averaged."""


def read(rec):
    decodes = rec.window_spans("decode")
    vals = []
    for a, b in rec.window_spans("request"):
        inner = [d for d in decodes if a <= d[0] <= b]
        if inner:
            vals.append(inner[0][0] - a)
    return 1e3 * sum(vals) / len(vals) if vals else None

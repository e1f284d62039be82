"""The benchmark's span around ``pipe.decode`` (latents to the uint8 image
on the host), averaged over the window's requests."""


def read(rec):
    spans = rec.window_spans("decode")
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None

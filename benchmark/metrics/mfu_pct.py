"""The model's floating-point operations a request (counted over the plain
reference at the cell's shapes) over the window's mean request time at the
bf16 peak (989 TFLOP/s)."""

from benchmark.harness.roofline import BF16_FLOPS_PER_S


def read(rec):
    if not rec.completed or rec.specs is None:
        return None
    flops = rec.family.flops_per_request(rec.cell, rec.specs)["flops"]
    return 100.0 * flops / (rec.window_s / rec.completed * BF16_FLOPS_PER_S)

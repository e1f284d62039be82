"""`compare` — max elementwise distance between two tensor files.

Counterpart of ``onnxstream_tpu/cli/compare_main.py`` (numpy only).

The reference's print_max_dist probe (reference src/sd.cpp:860-876) used for
cross-machine equivalence checks: generate latents on one machine
(--save-latents), compare or decode them on another. Works on raw .bin
float32 files (the latents / weights wire format).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def max_dist(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare", description=__doc__)
    p.add_argument("file_a")
    p.add_argument("file_b")
    p.add_argument("--dtype", default="float32")
    args = p.parse_args(argv)
    a = np.fromfile(args.file_a, dtype=np.dtype(args.dtype))
    b = np.fromfile(args.file_b, dtype=np.dtype(args.dtype))
    if a.size != b.size:
        print(f"size mismatch: {a.size} vs {b.size}", file=sys.stderr)
        return 1
    d = max_dist(a, b)
    rel = d / (float(np.abs(a).max()) + 1e-30)
    print(f"max dist: {d:.6g}  (relative {rel:.3g}, {a.size} elements)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

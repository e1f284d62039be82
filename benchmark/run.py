#!/usr/bin/env python3
"""The benchmark of onnxstream_tpu_torch: ``python3 benchmark/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``, from the root of
a checkout, on a machine with the cards the cell asks for. See
``harness/main.py``."""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main as bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T0))

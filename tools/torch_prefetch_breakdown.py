"""Where the host time of a streamed SD15 UNet run goes under the disk
providers, on the machine that holds the card.

    python3 tools/torch_prefetch_breakdown.py [--runs 3] [--source OTHER_prefetch.cpp]

Writes the SD15 UNet's weights (the shapes of the full-width graph, built
with lazy weights; zeros) as float16 .bin files to a temporary folder, then
makes ``runs`` passes over them in stream order, each after ``on_restart``,
as the streamed executor does: every weight read by ``get_into`` into one
reused host buffer (the executor's scratch), then converted to bfloat16 into
a pinned staging buffer. Per provider it prints the pass's wall time, the
time spent inside ``get_into`` (waiting for the reader and copying) and in
the conversion. Providers: the native prefetcher
(``runtime/csrc/prefetch.cpp``), ``--source``'s variant of it where given,
the Python ``DiskPrefetchWeightsProvider``, and plain ``np.fromfile`` reads
(the page cache's rate). Prints the card's name and power limit first: the
times are the host's of that machine.
"""

import argparse
import ctypes
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from onnxstream_tpu_torch.dtypes import DType  # noqa: E402
from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet  # noqa: E402
from onnxstream_tpu_torch.runtime import native, weights  # noqa: E402


def _pass(provider, entries, scratch, staging) -> tuple:
    t_get = t_conv = 0.0
    t0 = time.perf_counter()
    for name, dt, shape in entries:
        n = int(np.prod(shape))
        src = scratch[: 2 * n].view(torch.float16).view(shape)
        t1 = time.perf_counter()
        provider.get_into(name, dt, shape, src)
        t2 = time.perf_counter()
        staging[: 2 * n].view(torch.bfloat16).view(shape).copy_(src)
        t_conv += time.perf_counter() - t2
        t_get += t2 - t1
    return (time.perf_counter() - t0) * 1e3, t_get * 1e3, t_conv * 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--source", default=None, help="another prefetch.cpp to time beside the port's")
    args = p.parse_args()
    print(f"card: {cs.card()}; host threads {torch.get_num_threads()}")
    g = build_unet(SD15, seed=0, lazy_weights=True)
    entries = [(n, DType.float16, tuple(a.shape)) for n, a in g.weights.items()
               if np.dtype(a.dtype) == np.float32]
    total = sum(int(np.prod(s)) * 2 for _, _, s in entries)
    root = tempfile.mkdtemp(prefix="ostt_prefetch_")
    try:
        for name, _, shape in entries:
            path = os.path.join(root, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.zeros(shape, np.float16).tofile(path)
        big = max(int(np.prod(s)) * 2 for _, _, s in entries)
        scratch = torch.empty(big, dtype=torch.uint8)
        staging = torch.empty(big, dtype=torch.uint8, pin_memory=torch.cuda.is_available())
        print(f"{len(entries)} float16 weights, {total / 1e9:.3f} GB, largest {big / 1e6:.1f} MB -> {root}")
        prefix = root + os.sep
        providers = [("native", lambda: weights.NativeDiskPrefetchWeightsProvider(prefix))]
        if args.source:
            lib = ctypes.CDLL(str(native.build_library(Path(args.source), "ostt_prefetch_other", ["-lpthread"])))
            for fn, (res, argt) in {"ostpu_prefetch_new": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_uint64]),
                                    "ostpu_prefetch_init": (None, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                                                   ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]),
                                    "ostpu_prefetch_get": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                                                                          ctypes.c_void_p, ctypes.c_uint64]),
                                    "ostpu_prefetch_restart": (None, [ctypes.c_void_p]),
                                    "ostpu_prefetch_delete": (None, [ctypes.c_void_p])}.items():
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, argt

            def other():
                prov = weights.NativeDiskPrefetchWeightsProvider.__new__(weights.NativeDiskPrefetchWeightsProvider)
                prov._lib, prov.prefix = lib, prefix
                prov._h = lib.ostpu_prefetch_new(prefix.encode(), 1 << 28)
                return prov

            providers.append((f"native {os.path.basename(args.source)}", other))
        providers.append(("python prefetch", lambda: weights.DiskPrefetchWeightsProvider(prefix)))
        for turn in range(2):  # in turns, twice
            for label, make in providers:
                prov = make()
                prov.on_init(entries)
                for r in range(args.runs):
                    if r:
                        prov.on_restart()
                    wall, t_get, t_conv = _pass(prov, entries, scratch, staging)
                    print(f"turn {turn} {label:28s} pass {r}: wall {wall:8.1f} ms, in get_into {t_get:8.1f} ms, "
                          f"fp16 -> bf16 into staging {t_conv:7.1f} ms ({total / wall / 1e6:.2f} GB/s)")
                prov.close()
            t0 = time.perf_counter()
            for name, _, shape in entries:
                np.fromfile(os.path.join(root, name), dtype=np.float16)
            ms = (time.perf_counter() - t0) * 1e3
            print(f"turn {turn} np.fromfile of every file: {ms:.1f} ms ({total / ms / 1e6:.2f} GB/s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and load the port's host-side C++ libraries.

Two sources, each compiled at first use with one ``g++ -shared`` call into
``.cache/onnxstream_tpu_torch/<name>-<hash>/lib<name>.so`` at the root of the
checkout (where ``kernels/build.py`` puts the CUDA kernels), keyed by a hash
of the source and the flags:

  * ``runtime/csrc/prefetch.cpp`` -> ``libostt_prefetch.so``, the threaded
    disk prefetcher behind ``NativeDiskPrefetchWeightsProvider``;
  * ``api/csrc/exports.cpp`` -> ``libonnxstream_tpu_torch.so``, the
    15-function C ABI, which embeds CPython and forwards to
    ``onnxstream_tpu_torch.api.capi``. Its include and link flags come from
    ``sysconfig``;
  * ``models/sd/csrc/randn.cpp`` -> ``libostt_randn.so``, the reference's
    seeded normal latents (``rng.randn_4_w_h``) from libstdc++'s own
    ``std::mt19937`` and ``std::normal_distribution<float>``.

A failed build raises with the compiler's output: nothing falls back to a
Python implementation. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import hashlib
import shutil
import sysconfig
from pathlib import Path
from typing import List

from onnxstream_tpu_torch.kernels.build import CACHE_DIR, compile_once

PACKAGE = Path(__file__).resolve().parents[1]
PREFETCH_SOURCE = PACKAGE / "runtime" / "csrc" / "prefetch.cpp"
EXPORTS_SOURCE = PACKAGE / "api" / "csrc" / "exports.cpp"
RANDN_SOURCE = PACKAGE / "models" / "sd" / "csrc" / "randn.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-shared", "-fPIC"]


def gxx() -> str:
    """Path of the C++ compiler; raises when there is none."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's native libraries cannot be built")
    return path


def build_library(src: Path, name: str, flags: List[str]) -> Path:
    """Compile ``src`` into ``lib<name>.so`` unless that build is present;
    return its path. ``flags`` go after the source (include and link
    flags)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS + flags).encode()).hexdigest()[:16]
    return compile_once(CACHE_DIR / f"{name}-{digest}" / f"lib{name}.so",
                        lambda tmp: [gxx(), *CXX_FLAGS, "-o", str(tmp), str(src), *flags],
                        f"g++ failed for {src.name}")


def prefetch_library() -> Path:
    return build_library(PREFETCH_SOURCE, "ostt_prefetch", ["-lpthread"])


def randn_library() -> Path:
    # no contraction into FMAs: the polar method's float arithmetic stays as written
    return build_library(RANDN_SOURCE, "ostt_randn", ["-ffp-contract=off"])


def python_flags() -> List[str]:
    """Include and link flags of the running interpreter's libpython."""
    cv = sysconfig.get_config_var
    libdir = cv("LIBDIR")
    return [f"-I{sysconfig.get_paths()['include']}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{cv('VERSION')}{cv('ABIFLAGS') or ''}", *(cv("LIBS") or "").split(),
            *(cv("SYSLIBS") or "").split()]


def exports_library() -> Path:
    """``libonnxstream_tpu_torch.so``, the C ABI. Load it into a running
    interpreter only in a fresh process (the tests use a subprocess)."""
    return build_library(EXPORTS_SOURCE, "onnxstream_tpu_torch", python_flags())

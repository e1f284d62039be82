"""Build and load the hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exports a plain C interface. It is
compiled at first use with one ``nvcc -shared`` call for Hopper (``sm_90a``)
into ``.cache/onnxstream_tpu_torch/<name>-<hash>/lib<name>.so`` at the root of
the checkout (a directory ``.gitignore`` lists), keyed by a hash of the source,
the headers of ``csrc/`` (``*.cuh``, found through ``-I``) and the flags, and
loaded with ``ctypes``. No PyTorch headers are involved, so
a build takes seconds. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache" / "onnxstream_tpu_torch"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lands (whether built or not)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):  # shared by several sources: an edit rebuilds them all
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return CACHE_DIR / f"{name}-{digest}" / f"lib{name}.so"


def compile_once(out: Path, command: Callable[[Path], List[str]], what: str) -> Path:
    """Run ``command(tmp)`` (a compiler writing ``tmp``) unless ``out`` is
    present, then move its output to ``out``; return ``out``. The
    compiler's report is kept beside it as ``build.log``; a failure raises
    with it, naming ``what``."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(command(tmp), capture_output=True, text=True)
    (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build is present; return the
    library path. The compiler's report (registers, shared memory, spills)
    is kept beside it as ``build.log``."""
    return compile_once(library_path(name),
                        lambda tmp: [nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(CSRC / f"{name}.cu")],
                        f"nvcc failed for {name}.cu")


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load (once per process) the kernel library."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib

"""Mutation check of the K splits of kernels 6 and 8 of the PyTorch port, on one card.

    python3 tools/torch_split_mutation.py

Copies the port's package and tests into a temporary directory and mutates
the two split kernels there: ``gn_conv_wgmma_kernel`` (csrc/gn_conv.cu) and
``dyn_wgmma_kernel`` (csrc/qmatmul.cu) start every split after the first one
k-tile late, so each of them skips its own first k-tile and takes the next
split's first one twice. Then it runs the card tests of both kernels' wgmma
forms in the copy (``-m gpu``, without tests/conftest.py). A test whose
plan splits K must fail; one whose plan does not must pass. Prints pytest's
summary of the failures; exits 0 when the copy's tests failed somewhere (the
mutation was caught), 1 when they all passed. The tree itself is not
touched; the copy builds its kernels into its own cache.

Needs a CUDA card and nvcc.
"""

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATE = "const int kt0 = blockIdx.z * kt_per_split + (blockIdx.z > 0);"
KT0 = "const int kt0 = blockIdx.z * kt_per_split;"


def mutate(path: str, after: str) -> None:
    """Replace the first kt0 line after the text `after` in the source at path."""
    with open(path) as f:
        s = f.read()
    b = s.index(KT0, s.index(after))
    with open(path, "w") as f:
        f.write(s[:b] + LATE + s[b + len(KT0):])


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("onnxstream_tpu_torch", "tests"):
            shutil.copytree(os.path.join(REPO, name), os.path.join(tmp, name),
                            ignore=shutil.ignore_patterns("__pycache__", "data"))
        shutil.copy(os.path.join(REPO, "pyproject.toml"), tmp)
        csrc = os.path.join(tmp, "onnxstream_tpu_torch", "kernels", "csrc")
        mutate(os.path.join(csrc, "gn_conv.cu"), "gn_conv_wgmma_kernel(const WgConvParams p, int kt_per_split)")
        mutate(os.path.join(csrc, "qmatmul.cu"), "dyn_wgmma_kernel(const DynParams p, int kt_per_split)")
        print("mutated: gn_conv_wgmma_kernel and dyn_wgmma_kernel start every later split one k-tile late", flush=True)
        rc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "gpu",
                             "-q", "-rf", "--tb=line", "tests/test_torch_gn_card.py", "tests/test_torch_qmatmul_card.py",
                             "-k", "wgmma or kmajor or split"], cwd=tmp).returncode
    print("the mutation was " + ("caught" if rc != 0 else "NOT caught: every test passed"))
    return 0 if rc != 0 else 1


if __name__ == "__main__":
    sys.exit(main())

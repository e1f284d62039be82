"""Mutation checks of the PyTorch port's reductions across blocks, on one card.

    python3 tools/torch_split_mutation.py [split|cluster]

Copies the port's package and tests into a temporary directory, mutates one
kernel source there and runs the card tests that should catch it in the copy
(``-m gpu``, without tests/conftest.py). The tree itself is not touched; the
copy builds its kernels into its own cache.

``split`` (the default): ``gn_conv_wgmma_kernel`` (csrc/gn_conv.cu) and
``dyn_wgmma_kernel`` (csrc/qmatmul.cu) start every split after the first one
k-tile late, so each of them skips its own first k-tile and takes the next
split's first one twice. A card test of either kernel's wgmma form whose plan
splits K must fail; one whose plan does not must pass. Prints pytest's
summary of the failures; exits 0 when the copy's tests failed somewhere (the
mutation was caught), 1 when they all passed.

``cluster``: ``gn_silu_cluster_kernel`` (csrc/gn_conv.cu) leaves the last
rank's (sum, sum of squares) pair out of its cluster sum. Every case of
``test_gn_silu_kernel_matches_twin_on_card`` whose plan (``gn_silu_plan``)
takes K > 1 must fail and every case with K = 1 must pass. Prints both
counts and any case that went the other way; exits 0 when the outcome is
exactly that, 1 otherwise.

Needs a CUDA card and nvcc.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
LATE = "const int kt0 = blockIdx.z * kt_per_split + (blockIdx.z > 0);"
KT0 = "const int kt0 = blockIdx.z * kt_per_split;"
ALL_RANKS = "v = lane < K ? ld_cluster_f2(&s_part, lane)"
NO_LAST = "v = lane < K - 1 ? ld_cluster_f2(&s_part, lane)"
PYTEST = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "gpu", "-q", "-rf",
          "--tb=line"]


def mutate(path: str, after: str, old: str, new: str) -> None:
    """Replace the first `old` after the text `after` in the source at path by `new`."""
    with open(path) as f:
        s = f.read()
    b = s.index(old, s.index(after))
    with open(path, "w") as f:
        f.write(s[:b] + new + s[b + len(old):])


def copy_tree(tmp: str) -> str:
    for name in ("onnxstream_tpu_torch", "tests"):
        shutil.copytree(os.path.join(REPO, name), os.path.join(tmp, name),
                        ignore=shutil.ignore_patterns("__pycache__", "data"))
    shutil.copy(os.path.join(REPO, "pyproject.toml"), tmp)
    return os.path.join(tmp, "onnxstream_tpu_torch", "kernels", "csrc")


def split(tmp: str) -> int:
    csrc = copy_tree(tmp)
    mutate(os.path.join(csrc, "gn_conv.cu"), "gn_conv_wgmma_kernel(const WgConvParams p, int kt_per_split)", KT0, LATE)
    mutate(os.path.join(csrc, "qmatmul.cu"), "dyn_wgmma_kernel(const DynParams p, int kt_per_split)", KT0, LATE)
    print("mutated: gn_conv_wgmma_kernel and dyn_wgmma_kernel start every later split one k-tile late", flush=True)
    rc = subprocess.run([*PYTEST, "tests/test_torch_gn_card.py", "tests/test_torch_qmatmul_card.py",
                         "-k", "wgmma or kmajor or split"], cwd=tmp).returncode
    print("the mutation was " + ("caught" if rc != 0 else "NOT caught: every test passed"))
    return 0 if rc != 0 else 1


def cluster(tmp: str) -> int:
    import torch

    from onnxstream_tpu_torch.kernels.gn_silu import gn_silu_plan
    from test_torch_gn_card import GN_CASES, GN_CLUSTER_CASES, GN_SITE_CASES

    csrc = copy_tree(tmp)
    mutate(os.path.join(csrc, "gn_conv.cu"), "gn_silu_cluster_kernel(const GnClusterParams p)", ALL_RANKS, NO_LAST)
    print("mutated: gn_silu_cluster_kernel leaves the last rank's pair out of its cluster sum", flush=True)
    report = os.path.join(tmp, "report.xml")
    subprocess.run([*PYTEST, f"--junitxml={report}", "tests/test_torch_gn_card.py", "-k",
                    "gn_silu_kernel_matches_twin"], cwd=tmp)
    failed = {case.get("name"): case.find("failure") is not None or case.find("error") is not None
              for case in ET.parse(report).getroot().iter("testcase")}
    # the test's ids: the case, then dtype0..2 (float32, bfloat16, float16) and the tolerance
    dtypes = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)]
    want, wrong = {}, []
    for n, c, h, w, g, silu in GN_CASES + GN_SITE_CASES + GN_CLUSTER_CASES:
        for i, (dt, tol) in enumerate(dtypes):
            name = f"test_gn_silu_kernel_matches_twin_on_card[{n}-{c}-{h}-{w}-{g}-{silu}-dtype{i}-{tol}]"
            want[name] = gn_silu_plan(n, c, h * w, g, dt).cluster > 1
            if failed.get(name) is not want[name]:
                wrong.append(f"{name}: K {gn_silu_plan(n, c, h * w, g, dt).cluster}, "
                             + ("missing" if name not in failed else "failed" if failed[name] else "passed"))
    multi = [k for k, v in want.items() if v]
    print(f"K > 1: {sum(failed.get(k, False) for k in multi)} of {len(multi)} cases failed; K = 1: "
          f"{sum(failed.get(k) is False for k in want if not want[k])} of {len(want) - len(multi)} passed")
    for line in wrong:
        print("  not as predicted:", line)
    print("the mutation was " + ("caught exactly as predicted" if not wrong else "NOT caught as predicted"))
    return 0 if not wrong else 1


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "split"
    if which not in ("split", "cluster") or len(sys.argv) > 2:
        print(__doc__)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        return split(tmp) if which == "split" else cluster(tmp)


if __name__ == "__main__":
    sys.exit(main())

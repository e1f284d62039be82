"""Whole runs of the harness on the CPU at the TINY widths, in a copy of the
benchmark: a configuration, a cell and a per-layer metric added as new files
only; the result line's shape; and faults planted in the program
underneath, each of which has to make ``correct`` false."""

import json
import os

import pytest

from benchmark.tests import tiny

NEW_METRIC = '''"""Requests served in the window (a metric added as a new file)."""


def read(rec):
    return float(rec.completed)
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.bench_copy(str(tmp_path_factory.mktemp("bench")), metric_files={"served_count": NEW_METRIC})


def _run(root, workload, seed, trace=0, patch=""):
    return tiny.result(tiny.run_on_cpu(root, ["--workload", workload, "--seed", str(seed), "--seconds", "1.5",
                                              "--trace", str(trace)], patch=patch))


def test_new_files_only(copy):
    """The tiny configurations, traffic, limits and a metric reader exist only
    as new files of the copy; the repository's own files are unchanged."""
    for f in ("configs/tiny-sd.json", "configs/tiny-xl.json", "traffic/tiny-euler_a.json", "limits/tiny-sd-euler_a.json",
              "metrics/served_count.py"):
        assert os.path.exists(os.path.join(copy, "benchmark", f))
        assert not os.path.exists(os.path.join(tiny.REPO, "benchmark", f))
    for f in ("harness/main.py", "harness/spec.py", "families/sd.py", "run.py"):
        with open(os.path.join(copy, "benchmark", f)) as a, open(os.path.join(tiny.REPO, "benchmark", f)) as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_added_cell_runs_and_is_correct(copy, workload):
    res = _run(copy, workload, 2 ** 32 + 11)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"image_ms", "image_ms_p90", "setup_s"}  # no card: no peak memory
    assert list(res)[-1] == "check" and set(res["check"]) == {"latent_rel", "image_mae"}
    assert res["device"]["count"] == 1


def test_added_metric_in_traced_line(copy):
    res = _run(copy, "tiny-sd-euler_a", 7, trace=1)
    assert res["metrics"]["served_count"]["value"] >= 1
    assert {"denoise_ms", "decode_ms", "first_request_s", "capture_s", "mfu_pct"} <= set(res["metrics"])
    assert "flash_roofline_pct" not in res["metrics"]  # no kernel 1 on the CPU: silent, never 0
    assert "busy_s" in res["device"] and "window_s" in res["device"] and "breakdown" in res


FAULTS = {
    # the step program returns its state unchanged: the latents stay the starting noise
    "state unchanged": """
from onnxstream_tpu_torch.models.sd import pipeline as _p
_run = _p.DeviceProgram.run
def _stale(self, eager=False):
    if self.what.startswith("the SD step"):
        return self.static["x"]
    return _run(self, eager)
_p.DeviceProgram.run = _stale
""",
    # half of the CFG pair left out: the uncond half replaced by the cond half
    "half the batch": """
from onnxstream_tpu_torch.models.sd import pipeline as _p
_branches = _p.StableDiffusionPipeline._branches
def _half(self, prompt, neg_prompt):
    cond, uncond, both = _branches(self, prompt, neg_prompt)
    return cond, (None if uncond is None else cond), both
_p.StableDiffusionPipeline._branches = _half
""",
    # an answer altered where it is produced: a quarter of the image inverted
    "answer altered": """
from onnxstream_tpu_torch.models.sd import pipeline as _p
_to8 = _p.image_to_uint8
def _altered(img):
    out = _to8(img)
    out[: out.shape[0] // 4] = 255 - out[: out.shape[0] // 4]
    return out
_p.image_to_uint8 = _altered
""",
}


# a turbo request runs the cond branch alone: it has no pair to halve
CASES = [(w, f) for w in sorted(tiny.CELLS) for f in sorted(FAULTS)
         if not (f == "half the batch" and tiny.CELLS[w][3].get("turbo"))]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_makes_correct_false(copy, workload, fault):
    res = _run(copy, workload, 19, patch=FAULTS[fault])
    assert res["correct"] is False, json.dumps(res["check"])
    assert any(v["value"] > v["limit"] for v in res["check"].values())

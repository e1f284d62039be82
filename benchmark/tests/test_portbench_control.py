"""The control: the plain reference computed in float8 and put in the
program's place has to come out as not correct.

On the CPU at the TINY widths (tiny-sd's limits); on the card at each cell's
own size over three seeds (``calibrate.py``), where the program's readings
have to pass the cell's limits and the control's fail them. The card test
carries the ``gpu`` marker and skips where torch sees no card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.families import sd
from benchmark.harness import check, spec
from benchmark.harness import weights as bench_weights
from benchmark.harness.traffic import Requests
from benchmark.tests import tiny


def test_control_fails_tiny():
    cname, config, tname, traffic = tiny.CELLS["tiny-sd-euler_a"]
    cell = spec.Cell(workload={"name": "tiny-sd-euler_a", "chips": 1}, config=config,
                     traffic=traffic, limits=tiny.LIMITS, end_to_end=[], per_layer=[])
    cpu = torch.device("cpu")
    specs = sd.parameter_specs(sd.builders(config))
    for seed in (1, 2, 3):
        host = bench_weights.generate(specs, seed, cpu)
        reqs = Requests(traffic, seed)
        picks = [reqs[i] for i in range(traffic["check_requests"])]
        from benchmark.harness.traffic import vocabulary

        vocab = vocabulary(traffic)
        ctl, _ = sd.reference(cell, host, picks, vocab, cpu, "float8")
        ref, decoded = sd.reference(cell, host, picks, vocab, cpu, served=ctl)
        numbers = check.judge([check.gaps(*a) for a in zip(ctl, ref, decoded)], tiny.LIMITS["limits"])
        assert not check.passed(numbers), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["sd15-euler_a-10"])
def test_control_fails_on_card(card, workload):
    out = subprocess.run([sys.executable, os.path.join(tiny.REPO, "benchmark", "calibrate.py"), "--workload",
                          workload, "--seeds", "101,102,103", "--controls", "3"], capture_output=True, text=True,
                         cwd=tiny.REPO, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    limits = spec.load_cell(spec.ROOT, workload).limits["limits"]
    for row in rows[:-1]:
        assert all(row["program"][k] <= v for k, v in limits.items()), row
        assert any(row["control"][k] > v for k, v in limits.items()), row

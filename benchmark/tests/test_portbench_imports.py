"""What the harness and the reference import, checked in fresh processes:
the harness loads no module whose top-level name is ``jax`` or
``onnxstream_tpu`` (the JAX package; its port ``onnxstream_tpu_torch`` is
another name), and the reference loads nothing of ``onnxstream_tpu_torch``
either."""

import json
import subprocess
import sys

from benchmark.tests import tiny

PROBE = """
import sys, json
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=tiny.REPO, body=body)], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    body = """
from benchmark.harness import main, spec, trace, check, traffic, weights, roofline
from benchmark.families import sd
import benchmark.calibrate
cell = spec.load_cell(spec.ROOT, "sd15-euler_a-10")
spec.readers(cell.end_to_end + cell.per_layer)
sd.builders(cell.config)
import onnxstream_tpu_torch.models.sd.pipeline, onnxstream_tpu_torch.kernels
onnxstream_tpu_torch.kernels.counted()
"""
    mods = _top_level(body)
    assert "onnxstream_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "onnxstream_tpu"}, mods & {"jax", "jaxlib", "flax", "onnxstream_tpu"}


def test_reference_loads_nothing_of_the_program():
    body = "from benchmark.reference import clip, unet, vae, sampler, pipeline, ops"
    mods = _top_level(body)
    assert not mods & {"jax", "jaxlib", "flax", "onnxstream_tpu", "onnxstream_tpu_torch"}

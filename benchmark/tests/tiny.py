"""Tiny configurations and cells for the CPU tests: the port's TINY widths
at 77 text positions, and a temporary copy of the benchmark that holds them
as new files."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLIP = {"hidden_act": "quick_gelu", "hidden_size": 32, "intermediate_size": 128, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 77, "num_attention_heads": 2, "num_hidden_layers": 2, "projection_dim": 32,
        "vocab_size": 49408}
VAE = {"block_out_channels": [16, 32], "latent_channels": 4, "layers_per_block": 0, "norm_num_groups": 4,
       "scaling_factor": 0.18215}
TINY_SD = {
    "family": "sd", "name": "tiny-sd", "source": "the port's TINY test widths", "dtype": "bfloat16",
    "latent_size": 16, "text_encoders": [CLIP],
    "unet": {"attention_head_dim": [2, 2], "block_out_channels": [32, 64], "cross_attention_dim": 32,
             "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D"], "in_channels": 4,
             "layers_per_block": 1, "norm_num_groups": 8, "out_channels": 4},
    "vae": VAE, "reduced": [], "assumed": {}}
TINY_XL = {
    "family": "sd", "name": "tiny-xl", "source": "the port's TINY_XL test widths", "dtype": "bfloat16",
    "latent_size": 16, "time_ids_size": 1024,
    "text_encoders": [CLIP, {**CLIP, "hidden_act": "gelu", "hidden_size": 48, "intermediate_size": 192,
                             "projection_dim": 48}],
    "unet": {"addition_embed_type": "text_time", "addition_time_embed_dim": 8, "attention_head_dim": [2, 2],
             "block_out_channels": [32, 64], "cross_attention_dim": 80,
             "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"], "in_channels": 4, "layers_per_block": 1,
             "norm_num_groups": 8, "out_channels": 4, "projection_class_embeddings_input_dim": 96,
             "transformer_layers_per_block": [1, 2]},
    "vae": {**VAE, "scaling_factor": 0.13025}, "reduced": [], "assumed": {}}
TRAFFIC = {"steps": 3, "sampler": "euler_a", "cfg_scale": 7.5,
           "turbo": False, "prompt_words": [3, 12], "negative_prompt_words": [1, 4],
           "vocabulary": {"size": 512, "first_id": 300, "last_id": 49400}, "check_requests": 2,
           "traced_requests": 1}
TRAFFIC_TURBO = {**TRAFFIC, "steps": 1, "cfg_scale": 1.0, "turbo": True, "negative_prompt_words": [0, 0]}
# sound bf16 runs of the tiny cells read latent_rel 0.05-0.16 and image_mae 3-9
# on the CPU; the float8 control of tiny-sd reads 0.40-0.72 and 23-31
LIMITS = {"limits": {"latent_rel": 0.3, "image_mae": 15.0}, "readings": "tiny CPU cells"}
CELLS = {"tiny-sd-euler_a": ("tiny-sd", TINY_SD, "tiny-euler_a", TRAFFIC),
         "tiny-xl-turbo": ("tiny-xl", TINY_XL, "tiny-turbo", TRAFFIC_TURBO)}


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def bench_copy(dest: str, cells=CELLS, metric_files: Dict[str, str] = None, limits: dict = LIMITS) -> str:
    """A copy of BENCHMARK.json and benchmark/ under dest, with the tiny
    configurations, traffic, limits and cells added as new files and
    entries (and any ``metric_files``: name -> reader source, added as
    per-layer metrics of the pipeline layer)."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell, (cname, config, tname, traffic) in cells.items():
        _dump(os.path.join(dest, "benchmark", "configs", cname + ".json"), config)
        _dump(os.path.join(dest, "benchmark", "traffic", tname + ".json"), traffic)
        _dump(os.path.join(dest, "benchmark", "limits", cell + ".json"), limits)
        if not any(c["name"] == cname for c in bench["configs"]):
            bench["configs"].append({"name": cname, "source": config["source"],
                                     "file": f"benchmark/configs/{cname}.json", "reduced": [], "why": "CPU test"})
        bench["workloads"].append({"name": cell, "config": cname, "traffic": tname, "chips": 1, "why": "CPU test"})
    for name, source in (metric_files or {}).items():
        with open(os.path.join(dest, "benchmark", "metrics", name + ".py"), "w") as f:
            f.write(source)
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                                   "layer": "pipeline", "moves": "image_ms"})
    _dump(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


DRIVER = """
import sys, time, torch
t0 = time.perf_counter()
sys.path[:0] = [{root!r}, {repo!r}]
from benchmark.harness import main
{patch}
sys.exit(main.main(sys.argv[1:], t0, require=lambda chips: torch.device("cpu")))
"""


def run_on_cpu(root: str, argv: List[str], patch: str = "", timeout: int = 600) -> subprocess.CompletedProcess:
    """The harness of the copy at ``root`` run in a subprocess on the CPU: it
    skips the look for a card and runs the rest of a run. ``patch`` is
    Python run before it (a fault planted in the program)."""
    code = DRIVER.format(root=root, repo=REPO, patch=patch)
    env = {**os.environ, "PYTHONPATH": ""}
    return subprocess.run([sys.executable, "-c", code, *argv], cwd=root, capture_output=True, text=True,
                          timeout=timeout, env=env)


def result(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])

"""The benchmark's operation and byte counts against hand counts."""

import json
import os

import torch

from benchmark.families import sd
from benchmark.harness import spec
from benchmark.harness.roofline import AttentionSite, bound_s
from benchmark.reference import clip
from benchmark.reference.ops import Weights
from benchmark.tests import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell(config, traffic):
    return spec.Cell(workload={"name": "t", "chips": 1}, config=config, traffic=traffic,
                     limits=tiny.LIMITS, end_to_end=[], per_layer=[])


def _real(name, traffic):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", traffic + ".json")) as f:
        return _cell(config, json.load(f))


def test_attention_site_by_hand():
    s = AttentionSite(b=2, h=8, m=4096, n=4096, d=40, calls=3)
    assert s.ops == 2 * (2 * 2 * 8 * 4096 * 4096 * 40)  # q k^T and p v, a multiply-add two operations
    assert s.bytes == 2 * (2 * 8 * 4096 * 40) * 4  # q, k, v and the output, bf16, each once
    assert bound_s(s.ops, s.bytes) == s.ops / 989e12  # bound by operations
    small = AttentionSite(b=1, h=1, m=8, n=8, d=64)
    assert bound_s(small.ops, small.bytes) == small.bytes / 3.35e12  # bound by bytes


def _by_shape(sites):
    out = {}
    for s in sites:
        out[(s.b, s.h, s.m, s.d)] = out.get((s.b, s.h, s.m, s.d), 0) + s.calls
    return sorted(k + (c,) for k, c in out.items())


def test_kernel1_sites_sd15():
    sites = sd.kernel1_sites(_real("sd15", "euler_a-10"))
    # the CFG pair as one batch-2 call: 5 transformers at 64x64 and 5 at 32x32 a step, 10 steps; the VAE's one
    assert _by_shape(sites) == [(1, 1, 4096, 512, 1), (2, 8, 1024, 80, 50), (2, 8, 4096, 40, 50)]
    assert sum(s.calls for s in sites) == 101


def test_kernel1_sites_sdxl_turbo():
    sites = sd.kernel1_sites(_real("sdxl", "turbo-1step"))
    # level 1 (64x64): 2 layers x 5 blocks; level 2 (32x32): 10 x 5 and the mid block's 10; the VAE at 128x128
    assert _by_shape(sites) == [(1, 1, 16384, 512, 1), (1, 10, 4096, 64, 10), (1, 20, 1024, 64, 60)]


def test_flops_of_text_encoder_by_hand():
    c = tiny.CLIP
    d, L, f = c["hidden_size"], 77, c["intermediate_size"]
    shapes = {"embeddings.token_embedding.weight.bin": (c["vocab_size"], d),
              "embeddings.position_embedding.weight.bin": (L, d), "text_projection.weight.bin": (d, d),
              "final_layer_norm.weight.bin": (d,), "final_layer_norm.bias.bin": (d,)}
    for i in range(c["num_hidden_layers"]):
        nm = f"encoder.layers.{i}"
        for p in ("to_q", "to_k", "to_v", "to_out"):
            shapes[f"{nm}/attn/{p}.weight.bin"], shapes[f"{nm}/attn/{p}.bias.bin"] = (d, d), (d,)
        for ln in ("ln1", "ln2"):
            shapes[f"{nm}/{ln}.weight.bin"], shapes[f"{nm}/{ln}.bias.bin"] = (d,), (d,)
        shapes[f"{nm}/fc1.weight.bin"], shapes[f"{nm}/fc1.bias.bin"] = (d, f), (f,)
        shapes[f"{nm}/fc2.weight.bin"], shapes[f"{nm}/fc2.bias.bin"] = (f, d), (d,)
    meta = torch.device("meta")
    W = Weights({n: torch.empty(s, device=meta) for n, s in shapes.items()})
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        clip.encode(W, c, torch.zeros((1, L), dtype=torch.int64, device=meta), pool_at=76)
    per_layer = 4 * 2 * L * d * d + 2 * 2 * L * L * d + 2 * 2 * L * d * f
    assert fc.get_total_flops() == c["num_hidden_layers"] * per_layer + 2 * d * d
    assert W.read == set(shapes)


def test_flops_per_request_scales_with_steps_and_branches():
    cfg = tiny.TINY_SD
    specs = sd.parameter_specs(sd.builders(cfg))

    def flops(steps, turbo=False):
        return sd.flops_per_request(_cell(cfg, {**tiny.TRAFFIC, "steps": steps, "turbo": turbo}), specs)["flops"]

    unet = flops(3, True) - flops(2, True)  # one UNet run
    assert unet > 0
    assert flops(2) - flops(1) == 2 * unet  # a CFG step: the UNet over the pair
    assert flops(1) - flops(1, True) == unet + (flops(1) - flops(1, True) - unet)  # the second prompt
    assert flops(1) - flops(1, True) - unet > 0


def test_sd15_flops_near_published_count():
    cell = _real("sd15", "euler_a-10")
    from benchmark.families.sd import builders, parameter_specs

    specs = parameter_specs(builders(cell.config))
    total = sd.flops_per_request(cell, specs)["flops"]
    # BK-SDM's count of the SD1.5 UNet at 512x512, 339 G multiply-adds a batch-1 run, leaves out attention's two
    # products (about 60 G multiply-adds at the 64x64 and 32x32 levels): about 0.80 TFLOP a run, 20 runs a
    # request, plus the VAE decoder (about 1.26 T multiply-adds) and two CLIP-L passes
    assert 17.5e12 < total < 19.5e12
    params = sum(int(torch.tensor(s).prod()) for s in specs["unet"].values())
    assert abs(params - 859.5e6) < 1e6

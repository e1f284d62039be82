"""Captured segments on the card: ``Executor.run`` captures a resident
segment into a CUDA graph at its second run and replays it from then on.

Each replay is held to the per-op oracle (``Session.run(eager=True)``) on
the same inputs, bit for bit, and the kernel launch counts advance on every
replay as they do on an eager run: the graph's own kernel nodes hold as
many launches of each kernel as the eager run counted, and a capture whose
wrappers counted a launch the graph does not hold raises (chip_smoke.py
phase_capture also counts them on the card, in a profiler window). The graph keeps the workspaces it reads
(kernel 8's slab grown by a larger later call), kernel 6's reuse of a
quantized A holds across replays with new inputs, and an op that waits for
the card makes the capture raise, naming the op.

The SD pipelines' device programs (``generate_on_device``'s step and the
tiled decode, one CUDA graph each) are held the same way: every captured
loop's latents and tiled image equal the same program run op by op
(``pipeline.eager()``) bit for bit, for the TINY SD1.5 (batch-1 and batch-2
UNet), SDXL and Turbo families with euler and euler_a at a 64 x 64 latent
(where kernel 1 runs), three calls under one key make one capture, a step's
kernel-1 launches are read from the graph's nodes, the tile graph with its
decoder called once a tile equals the per-tile loop of Session.run, a
streamed UNet names its reason and gives the resident loop's latents in the
same form (two runs a step), and an op that waits for the card makes the
step's capture raise, naming it. In float32 the vmapped tile decoder equals
per-tile calls within 1e-5, and the loop vmapped over the CFG pair lies
within PAIR_BAR of two runs a step, where swapped branches do not.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu``). Every test
carries the ``gpu`` marker and skips without a card. What the CPU can check
(``capture_problem``, CPU runs against the JAX package) is in
tests/test_torch_capture.py.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch import Session, SessionConfig, kernels
from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
from onnxstream_tpu_torch.models.sd import pipeline as sd_pipeline
from onnxstream_tpu_torch.models.sd import unet as unet_module
from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
from onnxstream_tpu_torch.models.sd.unet import TINY, TINY_XL, build_unet
from onnxstream_tpu_torch.ops import _REGISTRY
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

# the TINY UNet at a 64 x 64 latent: 4096 tokens at its first level, so its
# attention takes kernel 1 (the size predicate wants 512 keys and 8 MB of scores)
UNET_64 = dataclasses.replace(TINY, sample_size=64)
# LLAMA_TINY with room for a 1024-token prefill, where kernel 2 runs
LLAMA_1K = dataclasses.replace(LLAMA_TINY, max_pos=1024)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs are CUDA's)")
    return torch.device("cuda", 0)


def _unet(dev, dtype: str, **options) -> Session:
    b = build_unet(UNET_64, seed=1)
    s = Session(SessionConfig(device=dev, compute_dtype=dtype, **options),
                weights_provider=DictWeightsProvider(params_from_numpy(b.weights)))
    s.read_string(b.to_text())
    return s


def _unet_request(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"sample": rng.standard_normal((1, 4, 64, 64), dtype=np.float32),
            "timestep": np.array([999.0 - 100 * seed], np.float32),
            "encoder_hidden_states": rng.standard_normal((1, 7, 32), dtype=np.float32)}


def _push(s: Session, req: dict) -> None:
    for k, v in req.items():
        s.add_tensor(k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_replays_equal_the_eager_run_and_count_launches(dtype):
    dev = _card()
    s = _unet(dev, dtype)
    per_run = []
    for i in range(4):
        _push(s, _unet_request(i))
        before = kernels.launch_counts()
        got = s.run()["out_sample"]
        per_run.append(kernels.launch_counts()["flash_attention_packed"] - before["flash_attention_packed"])
        ex = s._executor()
        assert ex.captured == (i > 0)
        want = s.run(eager=True)["out_sample"]
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert per_run[0] > 0 and per_run == [per_run[0]] * 4, per_run
    # what a replay launches, read from the graph's kernel nodes
    graph = ex.graph_launches()
    assert graph["flash_attention_packed+flash_attention"] == per_run[0] and graph["kernel_nodes"] > per_run[0]
    mem = ex.memory_analysis()
    assert mem["pool_bytes"] > 0 and mem["output_bytes"] == 4 * 64 * 64 * torch.empty(
        0, dtype=getattr(torch, dtype)).element_size()
    assert s.hbm_stats()["graph_bytes"] >= mem["pool_bytes"]
    assert ex.hbm_accounting()["graph_bytes"] == mem["pool_bytes"] + mem["input_bytes"]


@pytest.mark.gpu
def test_a_launch_the_graph_does_not_hold_makes_the_capture_raise(monkeypatch):
    """A wrapper that counts a launch it does not make: the capture's record
    disagrees with the graph's nodes, and the capture raises."""
    import onnxstream_tpu_torch.ops.attention as attention_op

    dev = _card()
    s = _unet(dev, "bfloat16")
    _push(s, _unet_request(0))
    s.run()
    kernel = attention_op.flash_attention_packed

    def counts_twice(*args, **kw):
        kernels.counted()["flash_attention_packed"].launches += 1
        return kernel(*args, **kw)

    monkeypatch.setattr(attention_op, "flash_attention_packed", counts_twice)
    with pytest.raises(RuntimeError, match=r"flash_attention_packed\+flash_attention: \d+ recorded, \d+ nodes"):
        s.run()
    assert not s._executor().captured


@pytest.mark.gpu
def test_eager_runs_leave_the_graph_and_reset_drops_it():
    dev = _card()
    s = _unet(dev, "bfloat16")
    _push(s, _unet_request(0))
    s.run()
    first = s.run()["out_sample"]
    ex = s._executor()
    graph, replayed = ex._replays, kernels.replayed["flash_attention_packed"]
    before = kernels.launch_counts()["flash_attention_packed"]
    with ex.eager():
        eager = s.run()["out_sample"]
    assert ex._replays is graph and kernels.replayed["flash_attention_packed"] == replayed
    assert kernels.launch_counts()["flash_attention_packed"] > before  # the wrappers ran
    np.testing.assert_array_equal(eager, first)
    np.testing.assert_array_equal(s.run()["out_sample"], first)
    assert kernels.replayed["flash_attention_packed"] > replayed
    ex.reset_graph()
    s.run()
    assert not ex.captured
    s.run()
    assert ex.captured and ex._replays is not graph


@pytest.mark.gpu
def test_held_device_outputs_survive_later_replays():
    dev = _card()
    s = _unet(dev, "bfloat16")
    held = []
    for i in range(4):
        _push(s, _unet_request(i))
        out = s.run(device_outputs=True)["out_sample"]
        held.append((out, out.clone()))
    torch.cuda.synchronize()
    for out, copy in held:
        assert torch.equal(out, copy)
    assert not torch.equal(held[2][0], held[3][0])


@pytest.mark.gpu
def test_a_changed_option_drops_the_graph():
    dev = _card()
    s = _unet(dev, "bfloat16")
    _push(s, _unet_request(0))
    s.run()
    on = s.run()
    assert s._executor().captured
    s.config.use_flash_attention = False
    before = kernels.launch_counts()["flash_attention_packed"]
    off = s.run()["out_sample"]
    assert not s._executor().captured and kernels.launch_counts()["flash_attention_packed"] == before
    np.testing.assert_array_equal(off, s.run(eager=True)["out_sample"])
    s.config.use_flash_attention = True
    s.run()
    np.testing.assert_array_equal(s.run()["out_sample"], on["out_sample"])
    assert s._executor().captured


@pytest.mark.gpu
def test_graph_survives_a_slab_grown_by_a_larger_call():
    """Kernel 8 writes its channels-last slab into a per-device workspace
    that a larger call replaces: the graph holds the one it captured."""
    from onnxstream_tpu_torch.kernels import gn_conv

    dev = _card()
    gn_conv._SLAB.pop(dev, None)  # the UNet's own slab, not one a larger call of another test grew
    s = _unet(dev, "bfloat16", fuse_gn_conv=True)
    reqs = [_unet_request(i) for i in range(3)]
    for req in reqs[:2]:
        _push(s, req)
        s.run()
    assert s._executor().captured
    slab = gn_conv._SLAB[dev]
    c, h = 64, 256  # a slab larger than any of the UNet's
    assert c * h * h * 2 > slab.numel()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, c, h, h), generator=g, device=dev).bfloat16()
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    w9 = torch.randn((9, 8, c), generator=g, device=dev).bfloat16() * 0.05
    y = gn_conv.gn_silu_conv(x, ones[:8], zeros[:8], ones, zeros, w9, groups=8, eps=1e-5)
    assert gn_conv._SLAB[dev] is not slab and torch.isfinite(y.float()).all()
    del slab
    torch.cuda.empty_cache()
    junk = torch.full((64 << 20,), 7, dtype=torch.uint8, device=dev)  # takes freed memory if any
    _push(s, reqs[2])
    got = s.run()["out_sample"]
    np.testing.assert_array_equal(got, s.run(eager=True)["out_sample"])
    del junk


def _checked_runs(monkeypatch, counts: list):
    """Session.run that also runs each replayed call's inputs through the
    per-op oracle and holds every output to it, bit for bit; ``counts``
    gets each replay's kernel-6 and kernel-2 launches."""
    run = Session.run

    def checked(self, eager=False, device_outputs=False):
        before = kernels.launch_counts()
        out = run(self, eager=eager, device_outputs=device_outputs)
        ex = self._executor()
        if not eager and ex.captured:
            after = kernels.launch_counts()
            counts.append((ex.plan.input_avals["input_5F_ids"].shape[1],
                           after["w8a8_dyn_matmul"] - before["w8a8_dyn_matmul"],
                           after["flash_attention"] - before["flash_attention"]))
            want = run(self, eager=True)
            for name, v in out.items():
                got = v.float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                np.testing.assert_array_equal(got, want[name], err_msg=name)
        return out

    monkeypatch.setattr(Session, "run", checked)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_llama_prefill_and_decode_replays_equal_eager(monkeypatch, int8):
    """Three requests through one pipeline: the 1024-token prefill replays
    from the second (kernel 2 inside), each decode step after the first
    replays (kernel 6 on every MatMul on the int8 route, its prefill form
    reusing one quantized A for the q / k / v and gate / up projections);
    every replay equals the oracle on its own inputs."""
    dev = _card()
    counts = []
    _checked_runs(monkeypatch, counts)
    pipe = LlamaPipeline(LLAMA_1K, compute_dtype="bfloat16", buckets=[16, 1024], seed=3, int8_weights=int8,
                         device=dev)
    rng = np.random.default_rng(5)
    toks = []
    for n in (700, 600, 900):
        pipe.reset()
        toks.append(pipe.generate_on_device([int(t) for t in rng.integers(3, 500, n)], max_new_tokens=6))
    assert all(len(t) == 6 for t in toks)
    prefill = [c for c in counts if c[0] == 1024]
    decode = [c for c in counts if c[0] == 1]
    assert len(prefill) == 2 and len(decode) >= 10
    layers = LLAMA_1K.layers
    assert all(c[2] == layers for c in prefill), prefill
    graphs = {key: s._executor().graph_launches() for key, s in pipe._sessions.items() if s._executor().captured}
    assert graphs[(1024, 0)]["flash_attention_packed+flash_attention"] == layers, graphs
    if int8:
        per_prefill, per_token = prefill[0][1], decode[0][1]
        assert per_prefill > 0 and per_token == per_prefill
        assert all(c[1] == per_prefill for c in prefill + decode)
        assert all(g["w8a8_dyn_matmul"] == per_token for g in graphs.values()), graphs
    else:
        assert all(c[1] == 0 for c in counts)


@pytest.mark.gpu
def test_an_op_that_waits_for_the_card_makes_the_capture_raise(monkeypatch):
    dev = _card()
    s = _unet(dev, "float32")
    _push(s, _unet_request(0))
    s.run()  # the warm-up is eager
    ex = s._executor()
    victim = next(op for i, op in enumerate(s.graph.ops)
                  if op.op_type == "Sigmoid" and ex.plan.op_modes[i] == "device")
    impl = _REGISTRY["Sigmoid"]
    fn = impl.fn

    def syncing(ctx, op, ins):
        outs = fn(ctx, op, ins)
        if op.name == victim.name:
            outs[0].sum().item()  # the host waits for the value
        return outs

    monkeypatch.setattr(impl, "fn", syncing)
    before = kernels.launch_counts()
    want = rf"capture of segment 0 failed at op #\d+ Sigmoid \({re.escape(victim.name)}\)"
    with pytest.raises(RuntimeError, match=want):
        s.run()
    assert kernels.launch_counts() == before and not s._executor().captured
    monkeypatch.setattr(impl, "fn", fn)
    out = s.run()["out_sample"]  # the card is usable, and the capture goes through now
    assert s._executor().captured and np.isfinite(out).all()


# ------------------------------------------------- the SD pipelines' device programs
SD_FAMILIES = {"sd15": {}, "sd15_batch2": {"batch": 2}, "sdxl": {"xl": True},
               "sdxl_batch2": {"xl": True, "batch": 2}, "turbo": {"xl": True, "turbo": True}}
FLASH_FAMILY = "flash_attention_packed+flash_attention"  # kernels 1 and 2 launch the same functions


def _sd_pipe(monkeypatch, dev, dtype: str = "bfloat16", **kw) -> StableDiffusionPipeline:
    """A TINY pipeline (bf16 unless ``dtype``) with its UNet at a 64 x 64
    latent (kernel 1 at the 4096-token sites), the VAE at 64 and its
    32 x 32 tile decoder."""
    monkeypatch.setattr(unet_module, "TINY", UNET_64)
    monkeypatch.setattr(unet_module, "TINY_XL", dataclasses.replace(TINY_XL, sample_size=64))
    return StableDiffusionPipeline.from_synthetic(tiny=True, device=dev, compute_dtype=dtype, **kw)


def _program(pipe, kind: str):
    (prog,) = [p for k, p in pipe.device_programs.items() if k[0] == kind]
    return prog


def _flash_launches(fn):
    before = kernels.launch_counts()["flash_attention_packed"]
    out = fn()
    return out, kernels.launch_counts()["flash_attention_packed"] - before


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["euler", "euler_a"])
@pytest.mark.parametrize("family", sorted(SD_FAMILIES))
def test_sd_loop_replays_equal_the_eager_loop(monkeypatch, family, sampler):
    """Three calls under one key: step 0 of the first runs op by op, step 1
    captures the step, every later step replays it; each call's latents
    equal the loop run op by op, bit for bit, with as many kernel-1 launches
    as a step's graph holds nodes of it. A batch-1 UNet with an uncond
    branch runs vmapped over the CFG pair: one UNet call a step, as a
    batch-2 UNet's and Turbo's."""
    dev = _card()
    pipe = _sd_pipe(monkeypatch, dev, **SD_FAMILIES[family])
    assert pipe.loop_capture_problem() is None
    kw = dict(steps=3, sampler=sampler, decode=False)
    calls = [(prompt, seed) for prompt, seed in (("a cat", 7), ("a photo of a dog", 8), ("a horse", 9))]
    got = [_flash_launches(lambda: pipe.generate_on_device(p, "ugly", seed=s, **kw).latents) for p, s in calls]
    prog = _program(pipe, "gen")
    assert prog.captures == 1 and prog.graph is not None and int(prog.static["counter"][0]) == 3
    (key,) = [k for k in pipe.device_programs if k[0] == "gen"]
    assert key[5] == {"turbo": "cond", "sd15_batch2": "pair", "sdxl_batch2": "pair"}.get(family, "vmap")
    # the kernel-1 launches a replay makes, read from the step graph's nodes: one UNet call's sites
    per_step = prog.graph.launches[FLASH_FAMILY]
    assert per_step > 0 and sum(prog.graph.nodes.values()) > per_step
    with pipe.eager():
        want = [_flash_launches(lambda: pipe.generate_on_device(p, "ugly", seed=s, **kw).latents) for p, s in calls]
    assert prog.captures == 1
    for (lat, n), (ref, n_eager) in zip(got, want):
        assert np.isfinite(lat).all() and n == n_eager == 3 * per_step
        np.testing.assert_array_equal(lat, ref)
    assert not np.array_equal(got[0][0], got[1][0])


def _decoder_once_a_tile(pipe, monkeypatch) -> None:
    """From here on the tile grid calls its decoder's segment function once
    a tile and stacks the outputs, where it calls it once vmapped over the
    tiles: the grid's slices, blend and uint8 mapping then run on the
    per-tile loop's decoder outputs. The grid's program is made anew."""
    real = sd_pipeline._segment_caller

    def caller(ex, in_dims=None):
        call, holds = real(ex)
        if in_dims is None:
            return call, holds
        ((n, d),) = in_dims.items()
        return (lambda acts: torch.stack([call({**acts, n: x}) for x in acts[n].unbind(d)])), holds

    monkeypatch.setattr(sd_pipeline, "_segment_caller", caller)
    for k in [k for k in pipe.device_programs if k[0] == "tile"]:
        del pipe.device_programs[k]


@pytest.mark.gpu
def test_tiled_decode_graph_equals_the_per_tile_loop(monkeypatch):
    """The tile grid (9 tiles of 32 over a 64 x 64 latent, one decoder call
    vmapped over them, the blend and the uint8 mapping) as one graph: eager
    at the first call, captured at the second, replayed after; every image
    equal, bit for bit, to the grid run op by op. With its decoder called
    once a tile (``_decoder_once_a_tile``) the grid's graph gives, bit for
    bit, the images and floats of the per-tile loop of Session.run (taken
    where the decoder has a segment_fn_problem): its slices, blend and uint8
    mapping are the loop's. The vmapped decoder itself is held to per-tile
    calls in float32 (the next test): in bf16 its convolutions at batch 9
    round apart from batch 1's."""
    dev = _card()
    pipe = _sd_pipe(monkeypatch, dev)
    lats = [np.random.default_rng(i).standard_normal((4, 64, 64), dtype=np.float32) for i in range(3)]
    imgs = [pipe.decode(lat, tiled=True) for lat in lats]
    prog = _program(pipe, "tile")
    assert prog.captures == 1 and prog.graph is not None and len(prog.static["factors"]) == 9
    with pipe.eager():
        eager = [pipe.decode(lat, tiled=True) for lat in lats]
    for img, ref in zip(imgs, eager):
        assert img.shape == (128, 128, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, ref)
    assert not np.array_equal(imgs[0], imgs[1])
    _decoder_once_a_tile(pipe, monkeypatch)
    once = [pipe.decode(lat, tiled=True) for lat in lats]
    once_f = [pipe.decode_to_float(lat, tiled=True).cpu() for lat in lats]
    assert _program(pipe, "tile").captures == 1
    monkeypatch.setattr(sd_pipeline, "segment_fn_problem", lambda ex: "the per-tile loop, for reference")
    per_tile = [pipe.decode(lat, tiled=True) for lat in lats]
    per_tile_f = [pipe.decode_to_float(lat, tiled=True).cpu() for lat in lats]
    for i in range(3):
        np.testing.assert_array_equal(once[i], per_tile[i])
        assert torch.equal(once_f[i], per_tile_f[i])


@pytest.mark.gpu
def test_the_vmapped_tile_decoder_equals_per_tile_calls_in_float32(monkeypatch):
    """The float32 tile decoder's segment function vmapped over the grid's 9
    tiles, as the tiled decode calls it, against one call a tile: within
    1e-5, as on the CPU (tests/test_torch_vmap.py)."""
    dev = _card()
    pipe = _sd_pipe(monkeypatch, dev, dtype="float32")
    lat = np.random.default_rng(5).standard_normal((4, 64, 64), dtype=np.float32)
    pipe.decode(lat, tiled=True)
    prog = _program(pipe, "tile")
    name = next(iter(prog.sess.graph.inputs))
    z, tile = pipe._scaled(lat), pipe._tile_size
    ys, xs = pipe._tile_grid(64, 64, tile, tile * 3 // 4)
    tiles = torch.stack([z[None, :, y:y + tile, x:x + tile] for y in ys for x in xs])
    vmapped, _ = sd_pipeline._segment_caller(prog.ex, {name: 0})
    once, _ = sd_pipeline._segment_caller(prog.ex)
    got = vmapped({name: tiles})
    want = torch.stack([once({name: t}) for t in tiles])
    print(f"vmapped tile decoder, float32, 9 tiles: max|diff| {(got - want).abs().max().item():.3e}, "
          f"max|out| {want.abs().max().item():.4f}")
    assert got.shape == want.shape and got.shape[:3] == (9, 1, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_a_streamed_unet_loop_names_its_problem_and_matches(monkeypatch):
    """A UNet streamed under a budget runs the same step op by op around
    Session.run, two runs a step, whose segments replay graphs of their own
    from the UNet's second run: its loop_capture_problem names the
    streaming, and its latents are, bit for bit, the resident UNet's in the
    same form (its segment_fn_problem patched: two runs a step, op by op),
    whose own form, one call vmapped over the CFG pair, is captured."""
    dev = _card()
    resident, streamed = _sd_pipe(monkeypatch, dev), _sd_pipe(monkeypatch, dev)
    streamed.unet.config.hbm_budget_bytes = 256 << 10
    assert resident.loop_capture_problem() is None and "streamed" in streamed.loop_capture_problem()
    kw, seeds = dict(steps=2, decode=False), (3, 4, 5)
    for seed in seeds:
        resident.generate_on_device("a cat", "dog", seed=seed, **kw)
    with resident.eager(), monkeypatch.context() as m:
        m.setattr(sd_pipeline, "segment_fn_problem", lambda ex: "two runs, for reference")
        want = [resident.generate_on_device("a cat", "dog", seed=seed, **kw).latents for seed in seeds]
    for seed, ref in zip(seeds, want):
        np.testing.assert_array_equal(streamed.generate_on_device("a cat", "dog", seed=seed, **kw).latents, ref)
    forms = lambda pipe: {k[5]: p for k, p in pipe.device_programs.items() if k[0] == "gen"}
    assert set(forms(resident)) == {"vmap", "two runs"} and forms(resident)["vmap"].captures == 1
    assert set(forms(streamed)) == {"two runs"} and forms(streamed)["two runs"].graph is None
    ex = streamed._loop_executor(1)
    assert ex.streamed and ex.captured and len(ex._replays) == len(ex.segments) > 1


# the float32 loop of a batch-1 UNet vmapped over the CFG pair against the same loop two runs a step:
# max|diff| / max|latents| after 2 steps at cfg 7.5; read 7.16e-6 and 7.42e-6 on an H100 (the swapped
# branches, the control, 1.60 and 1.74)
PAIR_BAR = 3e-5


@pytest.mark.gpu
def test_the_vmapped_pair_matches_two_runs_a_step_in_float32(monkeypatch):
    """In float32, the loop of a batch-1 UNet vmapped over the CFG pair
    (captured at the first call's step 1) against the same loop two runs a
    step (segment_fn_problem patched, op by op): within PAIR_BAR of
    max|latents|; the control, the two runs with the prompts swapped (the
    cond and uncond branches swapped), outside it."""
    dev = _card()
    pipe = _sd_pipe(monkeypatch, dev, dtype="float32")
    kw, seeds = dict(steps=2, decode=False), (3, 4)
    got = [pipe.generate_on_device("a cat", "dog", seed=seed, **kw).latents for seed in seeds]
    with pipe.eager(), monkeypatch.context() as m:
        m.setattr(sd_pipeline, "segment_fn_problem", lambda ex: "two runs, for reference")
        want = [pipe.generate_on_device("a cat", "dog", seed=seed, **kw).latents for seed in seeds]
        swapped = [pipe.generate_on_device("dog", "a cat", seed=seed, **kw).latents for seed in seeds]
    for lat, ref, control in zip(got, want, swapped):
        top = float(np.abs(ref).max())
        gap, off = float(np.abs(lat - ref).max()) / top, float(np.abs(control - ref).max()) / top
        print(f"float32 vmapped pair vs two runs: max|diff| / max|lat| {gap:.3e}; swapped branches {off:.3e}")
        assert np.isfinite(lat).all() and gap <= PAIR_BAR < off
    (key,) = [k for k, p in pipe.device_programs.items() if k[0] == "gen" and p.captures]
    assert key[5] == "vmap"


@pytest.mark.gpu
def test_an_op_that_waits_for_the_card_makes_the_step_capture_raise(monkeypatch):
    dev = _card()
    pipe = _sd_pipe(monkeypatch, dev)
    kw = dict(steps=1, seed=3, decode=False)
    want = pipe.generate_on_device("a cat", "dog", **kw).latents  # step 0: the warm-up, op by op
    ex = pipe._loop_executor(1)
    victim = next(op for i, op in enumerate(ex.graph.ops)
                  if op.op_type == "Sigmoid" and ex.plan.op_modes[i] == "device")
    impl = _REGISTRY["Sigmoid"]
    fn = impl.fn

    def syncing(ctx, op, ins):
        outs = fn(ctx, op, ins)
        if op.name == victim.name:
            outs[0].sum().item()  # the host waits for the value
        return outs

    monkeypatch.setattr(impl, "fn", syncing)
    before = kernels.launch_counts()
    match = rf"capture of the SD step .* failed in the UNet at op #\d+ Sigmoid \({re.escape(victim.name)}\)"
    with pytest.raises(RuntimeError, match=match):
        pipe.generate_on_device("a cat", "dog", **kw)
    assert kernels.launch_counts() == before and _program(pipe, "gen").graph is None
    monkeypatch.setattr(impl, "fn", fn)
    got = pipe.generate_on_device("a cat", "dog", **kw).latents  # the card is usable; the capture goes through
    assert _program(pipe, "gen").captures == 1
    np.testing.assert_array_equal(got, want)

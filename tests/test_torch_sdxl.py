"""SDXL, SDXL Turbo, the CFG pair as one batch-2 UNet run and generate_batch:
the port's pipeline against the JAX one.

Both packages build the TINY SDXL pipeline (CLIP_TINY + CLIP_TINY_G, the
TINY_XL UNet, VAE_TINY) from the same seed, the port through
``params_from_numpy`` on the builders' arrays, in float32 on the CPU, and must
agree: prompt encodings to 1e-5, latents to rtol = atol = 3e-4 (the bars of
tests/test_torch_sd_pipeline.py), decoded images to one level of 255. The
batch-2 and batch-N runs are held to the JAX package's batched runs at the
same bar, and to the port's own batch-1 runs at the JAX suite's batch-vs-
sequential bars (tests/test_cfg_batch.py, tests/test_sd_pipeline.py).
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from onnxstream_tpu.models.sd.pipeline import StableDiffusionPipeline as JaxPipeline
from onnxstream_tpu_torch.models.sd.pipeline import (
    SDXL_LATENT_RGB_PROJ,
    VAE_SCALE,
    VAE_SCALE_XL,
    StableDiffusionPipeline,
)
from onnxstream_tpu_torch.runtime.executor import Executor

CPU = torch.device("cpu")
PROMPT = "a photo of a fluffy cat riding a horse"


def _port(**kw):
    return StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU, **kw)


@pytest.fixture(scope="module")
def xl():
    return _port(xl=True), JaxPipeline.from_synthetic(tiny=True, xl=True)


@pytest.fixture(scope="module")
def xl2():
    return _port(xl=True, batch=2), JaxPipeline.from_synthetic(tiny=True, xl=True, batch=2)


@pytest.fixture(scope="module")
def turbo():
    return _port(xl=True, turbo=True), JaxPipeline.from_synthetic(tiny=True, xl=True, turbo=True)


def _close(got, want, tol=3e-4):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@contextlib.contextmanager
def _count_unet_runs(pipe):
    """Count the UNet's runs inside, and the batch of each: every run, through
    Session.run or through the device loop's segment function, prepares its
    inputs once (``Executor._prepare_inputs``)."""
    batches, prepare = [], Executor._prepare_inputs
    sample = pipe._unet_input_names()["sample"]

    def counting(ex, inputs):
        if any(e is ex for e in pipe.unet._executors.values()):
            batches.append(inputs[sample].shape[0])
        return prepare(ex, inputs)

    Executor._prepare_inputs = counting
    try:
        yield batches
    finally:
        Executor._prepare_inputs = prepare


# ------------------------------------------------------------ prompt encoding
@pytest.mark.parametrize("prompt", [PROMPT, "", "astronaut on mars, dog, " * 12])
def test_encode_prompt_xl_matches_jax(xl, prompt):
    port, jax = xl
    got, want = port.encode_prompt_xl(prompt), jax.encode_prompt_xl(prompt)
    # the context is te1 (32) and te2 (48) penultimate states side by side
    assert got["context"].shape == (7, 80) and got["pooled"].shape == (1, 48)
    for key in ("context", "pooled"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the sampler loop
@pytest.mark.parametrize("sampler", ["euler_a", "heun", "dpm++2m"])
def test_xl_generate_latents_match_jax(xl, sampler):
    port, jax = xl
    kw = dict(steps=3, seed=7, sampler=sampler, decode=False)
    _close(port.generate(PROMPT, "dog", **kw).latents, jax.generate(PROMPT, "dog", **kw).latents)


def test_xl_cfg_uses_per_branch_pooled(xl):
    """cond and uncond carry their own pooled embeds (sd.cpp:1500-1516): a
    negative prompt moves the latents."""
    port, _ = xl
    a = port.generate(PROMPT, steps=2, seed=11, decode=False).latents
    b = port.generate(PROMPT, neg_prompt="a dog", steps=2, seed=11, decode=False).latents
    assert np.abs(a - b).max() > 1e-6


def test_xl_previews_use_the_sdxl_projection(xl):
    port, _ = xl
    r = port.generate(PROMPT, steps=2, seed=11, preview_steps=True, decode=False)
    assert len(r.previews) == 2 and r.previews[-1].shape == (16, 16, 3)
    from onnxstream_tpu_torch.models.sd.pipeline import latent_to_rgb

    np.testing.assert_array_equal(r.previews[-1], latent_to_rgb(r.latents, SDXL_LATENT_RGB_PROJ))


@pytest.mark.parametrize("loop", ["generate", "generate_on_device"])
def test_turbo_never_runs_the_uncond_branch(turbo, loop):
    """Turbo: one batch-1 UNet run a step, the negative prompt ignored, and
    the JAX package's latents."""
    port, jax = turbo
    with _count_unet_runs(port) as batches:
        a = getattr(port, loop)("a cat", steps=2, seed=3, decode=False).latents
        assert batches == [1, 1]
        b = getattr(port, loop)("a cat", neg_prompt="ugly", steps=2, seed=3, decode=False).latents
    np.testing.assert_array_equal(a, b)
    _close(a, jax.generate("a cat", steps=2, seed=3, decode=False).latents)


# ------------------------------------------------- the CFG pair as one batch-2 run
def test_stack_branches_layout():
    c = {"context": np.ones((77, 8), np.float32), "pooled": np.full((1, 4), 2.0, np.float32)}
    u = {"context": np.zeros((77, 8), np.float32), "pooled": np.full((1, 4), 3.0, np.float32)}
    both = StableDiffusionPipeline._stack_branches(c, u)
    want = JaxPipeline._stack_branches(c, u)
    assert both["context"].shape == (2, 77, 8) and both["pooled"].shape == (2, 4)
    assert both["context"][0].max() == 1.0 and both["context"][1].max() == 0.0
    assert both["pooled"][0, 0] == 2.0 and both["pooled"][1, 0] == 3.0
    for key in ("context", "pooled"):
        np.testing.assert_array_equal(both[key], want[key])
    plain = StableDiffusionPipeline._stack_branches(c["context"], u["context"])
    np.testing.assert_array_equal(plain, JaxPipeline._stack_branches(c["context"], u["context"]))


@pytest.mark.parametrize("xl_", [False, True], ids=["sd15", "xl"])
def test_cfg2_runs_one_batch2_unet_run_a_step(xl, xl2, xl_):
    """A batch-2 UNet runs cond (row 0) and uncond (row 1) in one run a step,
    in both loops: the JAX package's batch-2 latents at the loop bar, and the
    port's batch-1 latents at the JAX suite's batch-vs-sequential bar
    (tests/test_cfg_batch.py)."""
    if xl_:
        (one, _), (port, jax) = xl, xl2
    else:
        one, port, jax = _port(), _port(batch=2), JaxPipeline.from_synthetic(tiny=True, batch=2)
    assert port._unet_batch() == 2 and one._unet_batch() == 1
    kw = dict(steps=3, seed=7, sampler="euler_a", decode=False)
    with _count_unet_runs(port) as batches:
        host = port.generate(PROMPT, "blurry", **kw).latents
        assert batches == [2, 2, 2]
        dev = port.generate_on_device(PROMPT, "blurry", **kw).latents
        assert batches == [2] * 6
    _close(host, jax.generate(PROMPT, "blurry", **kw).latents)
    _close(dev, host)
    seq = one.generate(PROMPT, "blurry", **kw).latents
    np.testing.assert_allclose(host, seq, rtol=2e-3, atol=1e-3)
    assert float(np.abs(host - seq).mean()) < 1e-3 * float(np.abs(seq).mean())


def test_denoise_cfg2_matches_jax(xl, xl2):
    port, jax = xl2
    both = port._stack_branches(port.encode_prompt_xl(PROMPT), port.encode_prompt_xl("dog"))
    x = np.random.RandomState(0).randn(4, 16, 16).astype(np.float32) * np.float32(8.0)
    got = port._denoise_cfg2(x, 7.5, both, 7.0)
    want = jax._denoise_cfg2(x, 7.5, both, 7.0)
    _close(got, want)
    # each row is the single-branch denoiser of its branch (a batch-1 UNet)
    c, u = ({"context": both["context"][i], "pooled": both["pooled"][i:i + 1]} for i in (0, 1))
    two_runs = xl[1].denoise(x, 7.5, c, u, 7.0)
    np.testing.assert_allclose(got, two_runs, rtol=2e-3, atol=1e-3)


# ------------------------------------------------------------------ generate_batch
@pytest.mark.parametrize("xl_,n", [(False, 3), (True, 2), (False, 1)],
                         ids=["sd15_batch3", "xl_batch2", "sd15_batch1"])
def test_generate_batch_matches_jax(xl_, n):
    prompts = ["a photo of a cat", "a dog", "a horse on mars"][:n]
    seeds = [7, 11, 13][:n]
    port = _port(xl=xl_, batch=n)
    jax = JaxPipeline.from_synthetic(tiny=True, xl=xl_, batch=n)
    got = port.generate_batch(prompts, steps=2, seeds=seeds, decode=False)
    want = jax.generate_batch(prompts, steps=2, seeds=seeds, decode=False)
    assert len(got) == n
    for a, b in zip(got, want):
        _close(a.latents, b.latents)
    # and image i is the sequential generate with seed i (the JAX suite's bar)
    one = _port(xl=xl_)
    for r, p, s in zip(got, prompts, seeds):
        np.testing.assert_allclose(r.latents, one.generate(p, steps=2, seed=s, decode=False).latents,
                                   rtol=5e-3, atol=2e-4)


def test_generate_batch_multistage_sampler_batches_each_call_site():
    """heun's second stage: the three threads' denoiser calls meet at the
    barrier and run as ONE batched run per call site (1 + 1 + 1 for two
    steps, the last one single-stage), giving the JAX package's latents."""
    prompts, seeds = ["a cat", "a dog", "an astronaut"], [1, 2, 3]
    port = _port(batch=3)
    calls = []
    orig = port._denoise_batch

    def counting(xb, s, conds, unconds, cfg):
        calls.append(xb.shape[0])
        return orig(xb, s, conds, unconds, cfg)

    port._denoise_batch = counting
    got = port.generate_batch(prompts, steps=2, seeds=seeds, sampler="heun", decode=True)
    assert calls == [3, 3, 3]
    want = JaxPipeline.from_synthetic(tiny=True, batch=3).generate_batch(prompts, steps=2, seeds=seeds,
                                                                          sampler="heun", decode=True)
    for a, b in zip(got, want):
        # heun's last stage at a small sigma turns float32 rounding into
        # ~1e-2 on latents of ~60, between any two of the batched and
        # sequential runs of either package alike: the JAX suite's heun bar
        # (tests/test_sd_pipeline.py:286)
        _close(a.latents, b.latents, tol=5e-2)
        assert _levels(a.image, b.image) <= 1
    assert not np.allclose(got[0].latents, got[1].latents)


def test_generate_batch_wrong_batch_raises():
    with pytest.raises(ValueError, match="batch"):
        _port().generate_batch(["a", "b"], steps=1, decode=False)
    with pytest.raises(ValueError, match="batch"):
        _port(batch=2).generate_batch(["a", "b", "c"], steps=1, decode=False)


def test_generate_batch_relays_a_thread_error():
    """An error in one sampler thread breaks the barrier and reaches the
    caller; no thread is left waiting."""
    port = _port(batch=2)
    orig = port._denoise_batch
    n = []

    def failing(xb, s, conds, unconds, cfg):
        n.append(1)
        if len(n) > 1:  # the second-stage call site
            raise RuntimeError("denoiser failed")
        return orig(xb, s, conds, unconds, cfg)

    port._denoise_batch = failing
    with pytest.raises(RuntimeError, match="denoiser failed"):
        port.generate_batch(["a", "b"], steps=2, seeds=[1, 2], sampler="heun", decode=False)


# ------------------------------------------------------------ the device loop
@pytest.mark.parametrize("which", ["base", "base_batch2", "turbo"])
def test_xl_generate_on_device_matches_host_loop(xl, xl2, turbo, which):
    port = {"base": xl, "base_batch2": xl2, "turbo": turbo}[which][0]
    for sampler, steps, seed in (("euler_a", 3, 7), ("euler", 2, 9)):
        host = port.generate(PROMPT, "dog", steps=steps, seed=seed, sampler=sampler, decode=False)
        dev = port.generate_on_device(PROMPT, "dog", steps=steps, seed=seed, sampler=sampler, decode=False)
        _close(dev.latents, host.latents)


# --------------------------------------------------------------------- decode
def _latent(seed=0):
    return np.random.RandomState(seed).randn(4, 16, 16).astype(np.float32)


def test_xl_decode_whole_and_tiled_match_jax(xl):
    port, jax = xl
    assert port.vae_scale == np.float32(VAE_SCALE_XL) != VAE_SCALE and port.vae_scale == jax.vae_scale
    assert _levels(port.decode(_latent()), jax.decode(_latent())) <= 1
    assert _levels(port.decode(_latent(1), tiled=True), jax.decode(_latent(1), tiled=True)) <= 1
    got = port._decode_tiled(_latent(2), tile=8, stride=6, ramp=4)
    assert _levels(got, jax._decode_tiled(_latent(2), tile=8, stride=6, ramp=4)) <= 1


# ---------------------------------------------------------------- from_dir
def _save(folder, builder, renames=()) -> None:
    """model.txt and the .bin files; weight names hold '/', so the folder
    gets subfolders (GraphBuilder.save writes flat names). ``renames``:
    (builder name, converted graph's name) of tensors in the text."""
    for name, arr in builder.weights.items():
        path = os.path.join(folder, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.asarray(arr).tofile(path)
    text = builder.to_text()
    for old, new in renames:
        text = text.replace(old, new)
    with open(os.path.join(folder, "model.txt"), "w") as f:
        f.write(text)


def test_from_dir_reads_an_sdxl_folder(tmp_path):
    """The reference's SDXL folder names, written from the TINY graphs: the
    port reads both encoders, the UNet, the decoder and its tile model and
    gives the JAX pipeline's encodings, latents and image."""
    import dataclasses

    from onnxstream_tpu_torch.models.sd.clip import CLIP_TINY, CLIP_TINY_G, build_text_encoder
    from onnxstream_tpu_torch.models.sd.unet import TINY_XL, build_unet
    from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder

    # the encoders' outputs under the converted graphs' names, which from_dir
    # asks for as extra outputs (the builder's own names are not there)
    penult = "penultimate_hidden_state"
    for sub, b, renames in (
            ("sdxl_text_encoder_1_fp32", build_text_encoder(CLIP_TINY, seed=0), [(penult, "out_5F_13")]),
            ("sdxl_text_encoder_2_fp32", build_text_encoder(CLIP_TINY_G, seed=7),
             [(penult, "out_5F_33"), ("pooled_output", "out_5F_0")]),
            ("sdxl_unet_fp16", build_unet(TINY_XL, seed=1), []),
            ("sdxl_vae_decoder_fp16", build_vae_decoder(dataclasses.replace(VAE_TINY, sample=16), seed=2), []),
            ("sdxl_vae_decoder_32x32_fp16", build_vae_decoder(dataclasses.replace(VAE_TINY, sample=8), seed=2), [])):
        _save(str(tmp_path / sub), b, renames)
    (tmp_path / "sdxl_tokenizer").mkdir()
    vocab = {chr(ord("a") + i) + "</w>": 10 + i for i in range(26)}
    (tmp_path / "sdxl_tokenizer" / "vocab.json").write_text(json.dumps(vocab))

    pipes = [StableDiffusionPipeline.from_dir(str(tmp_path), xl=True, compute_dtype="float32", res=(128, 128),
                                              device=CPU),
             JaxPipeline.from_dir(str(tmp_path), xl=True, compute_dtype="float32", res=(128, 128))]
    port = pipes[0]
    assert port.xl and port.vae_scale == VAE_SCALE_XL and port.context_dim == 2048
    assert "out_5F_13" in port.text_encoder.config.extra_outputs
    assert "out_5F_33" in port.text_encoder_2.config.extra_outputs
    outs = []
    for p in pipes:
        p._clip_seq, p._tile_size = 7, 8  # the tiny encoders' context and tile model, as from_synthetic sets them
        outs.append((p.encode_prompt_xl("a b c"), p.generate("a b c", "d", steps=2, seed=3, sampler="euler",
                                                             tiled_decode=True)))
    (e1, r1), (e2, r2) = outs
    for key in ("context", "pooled"):
        np.testing.assert_allclose(e1[key], e2[key], rtol=1e-5, atol=1e-5)
    _close(r1.latents, r2.latents)
    assert r1.image.shape == (32, 32, 3) and _levels(r1.image, r2.image) <= 1


def test_from_dir_without_a_unet_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        StableDiffusionPipeline.from_dir(str(tmp_path), xl=True, device=CPU)


# ------------------------------------------------------------------------ CLI
@pytest.mark.parametrize("flags", [["--xl"], ["--xl", "--turbo"]], ids=["xl", "turbo"])
def test_sd_cli_xl(tmp_path, flags):
    from PIL import Image

    from onnxstream_tpu_torch.cli.sd_main import main

    out = str(tmp_path / "xl.png")
    rc = main(["--synthetic", "tiny", "--device", "cpu", *flags, "--steps", "2", "--prompt", "a cat",
               "--output", out, "--compute-dtype", "float32"])
    assert rc == 0
    assert Image.open(out).size == (32, 32)

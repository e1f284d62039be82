"""The SD1.5 text-to-image slice end to end: the port's pipeline against the JAX one.

Both packages build the TINY SD1.5 pipeline (CLIP_TINY, the TINY UNet, VAE_TINY)
from the same seed, in float32 on the CPU, and must agree: prompt encoding to
1e-5, latents of the host loop for four samplers to rtol = atol = 3e-4 (the JAX
suite's on-device-vs-host bar, ``tests/test_sd_pipeline.py:328``), the port's
device loop against its host loop to the same bar, and decoded images (full,
tiled, calibrated W8A8) to one level of 255. The copied numpy modules (rng,
tokenizer, samplers, scheduler) must give the JAX package's values exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from onnxstream_tpu.models.sd import rng as jax_rng
from onnxstream_tpu.models.sd import samplers as jax_samplers
from onnxstream_tpu.models.sd import scheduler as jax_scheduler
from onnxstream_tpu.models.sd import tokenizer as jax_tokenizer
from onnxstream_tpu.models.sd.pipeline import StableDiffusionPipeline as JaxPipeline
from onnxstream_tpu.models.sd.vae import VAE_TINY as JAX_VAE_TINY
from onnxstream_tpu.models.sd.vae import build_vae_decoder as jax_build_vae_decoder
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
from onnxstream_tpu_torch.models.sd import rng, samplers, scheduler, tokenizer
from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline, qu8_decoder
from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder
from onnxstream_tpu_torch.runtime.quantization import RangeData

CPU = torch.device("cpu")
PROMPT = "a photo of a fluffy cat riding a horse"
# A weighted prompt renormalizes the chunk by mean(hidden) / mean(weighted
# hidden) (reference sd.cpp:2196-2216). The tiny encoder's final LayerNorm
# leaves that mean near 0, so the ratio turns float32 rounding into O(1)
# differences between any two implementations: the weighting is compared on
# the same hidden states instead (test_tokenizer_copy_matches_jax).
WEIGHTED = "a photo of a (fluffy cat:1.3) riding a horse"


@pytest.fixture(scope="module")
def pipes():
    return (StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU),
            JaxPipeline.from_synthetic(tiny=True))


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# ------------------------------------------------------------ prompt encoding
@pytest.mark.parametrize("prompt", [PROMPT, "", "astronaut on mars, dog, " * 12])
def test_encode_prompt_matches_jax(pipes, prompt):
    port, jax = pipes
    got, want = port.encode_prompt(prompt), jax.encode_prompt(prompt)
    assert got.shape == want.shape == (7, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the sampler loop
@pytest.mark.parametrize("sampler", ["euler_a", "euler", "heun", "dpm++2m"])
def test_generate_latents_match_jax(pipes, sampler):
    port, jax = pipes
    kw = dict(steps=3, seed=7, sampler=sampler, decode=False)
    got = port.generate(PROMPT, "dog", **kw).latents
    want = jax.generate(PROMPT, "dog", **kw).latents
    assert got.shape == want.shape == (4, 16, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("sampler,steps,seed", [("euler_a", 3, 7), ("euler", 2, 9)])
def test_generate_on_device_matches_host_loop(pipes, sampler, steps, seed):
    port, _ = pipes
    host = port.generate("a cat", steps=steps, seed=seed, sampler=sampler, decode=False)
    dev = port.generate_on_device("a cat", steps=steps, seed=seed, sampler=sampler, decode=False)
    assert isinstance(dev.latents, np.ndarray) and dev.latents.dtype == np.float32
    np.testing.assert_allclose(dev.latents, host.latents, rtol=3e-4, atol=3e-4)


def test_generate_on_device_refuses_other_samplers(pipes):
    with pytest.raises(ValueError):
        pipes[0].generate_on_device("a", sampler="heun")


# --------------------------------------------------------------------- decode
def _latent(seed=0):
    return np.random.RandomState(seed).randn(4, 16, 16).astype(np.float32)


def test_decode_matches_jax(pipes):
    port, jax = pipes
    got, want = port.decode(_latent()), jax.decode(_latent())
    assert got.shape == (32, 32, 3)  # VAE_TINY upsamples by 2
    assert _levels(got, want) <= 1


def test_decode_tiled_matches_jax(pipes):
    port, jax = pipes
    got = port._decode_tiled(_latent(1), tile=8, stride=6, ramp=4)
    want = jax._decode_tiled(_latent(1), tile=8, stride=6, ramp=4)
    assert _levels(got, want) <= 1
    # the default grid (the tile model's 8 x 8 tiles, stride 6) and the
    # decode(tiled=True) entry point
    assert _levels(port.decode(_latent(1), tiled=True), jax.decode(_latent(1), tiled=True)) <= 1


def test_qu8_decode_matches_jax():
    """calibrate -> quantize -> W8A8: the same range names and the same image
    to one level, every group-1 Conv through qconv (the range values are held
    to JAX's in tests/test_torch_qlinear.py)."""
    g = build_vae_decoder(VAE_TINY, seed=7)
    jg = jax_build_vae_decoder(JAX_VAE_TINY, seed=7)
    assert g.to_text() == jg.to_text()
    z = np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)

    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    cal = Session(SessionConfig(device=CPU, fuse_ops_in_attention=True, range_data_calibrate=True),
                  weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    cal.read_string(g.to_text())
    cal.add_tensor("latent", z)
    cal.run()
    ranges = cal._executor().range_data.data

    jcal = JaxSession(JaxConfig(fuse_ops_in_attention=True, range_data_calibrate=True),
                      weights_provider=JaxDict(dict(jg.weights)))
    jcal.read_string(jg.to_text())
    jcal.add_tensor("latent", z)
    jcal.run(eager=True)
    jranges = dict(jcal._executor().range_data.data)
    assert sorted(ranges) == sorted(jranges) and "latent" in ranges and len(ranges) > 5

    from onnxstream_tpu.convert.quantize import quantize_graph_weights as jax_quantize

    qs = qu8_decoder(g.to_text(), g.weights, jranges, device=CPU)
    jtext, jweights = jax_quantize(jg.to_text(), jg.weights)
    jq = JaxSession(JaxConfig(fuse_ops_in_attention=True, use_uint8_arithmetic=True, range_data=jranges),
                    weights_provider=JaxDict(jweights))
    jq.read_string(jtext)
    imgs = []
    for pipe, sess in ((port, qs), (JaxPipeline.from_synthetic(tiny=True), jq)):
        pipe.vae_decoder = sess
        imgs.append(pipe.decode(z[0] * np.float32(pipe.vae_scale)))
    assert _levels(*imgs) <= 1
    routes = qs._executor().quant_routes
    n_conv = sum(op.op_type == "Conv" for op in qs.graph.ops)
    assert list(routes.values()).count("qconv") >= n_conv - 1  # post_quant_conv (16 values) stays float
    assert "qmatmul" in routes.values()


def test_from_dir_runs_a_qu8_decoder_folder(tmp_path):
    """The reference folder layout written from the TINY graphs, the decoder
    as ``vae_decoder_qu8`` with its ``range_data.txt``: the port reads the
    .bin files, turns on W8A8 for the decoder, and gives the JAX pipeline's
    latents and image."""
    import json

    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights
    from onnxstream_tpu_torch.models.sd.clip import CLIP_TINY, build_text_encoder
    from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet

    def save(sub, text, weights):
        # weight names hold '/', so the folder has subfolders
        for name, arr in weights.items():
            os.makedirs(os.path.dirname(str(tmp_path / sub / name)), exist_ok=True)
            np.asarray(arr).tofile(str(tmp_path / sub / name))
        (tmp_path / sub / "model.txt").write_text(text)

    for sub, b in (("text_encoder_fp32", build_text_encoder(CLIP_TINY, seed=0)),
                   ("unet_fp32", build_unet(TINY, seed=1))):
        save(sub, b.to_text(), b.weights)
    g = build_vae_decoder(dataclasses.replace(VAE_TINY, sample=16), seed=2)  # from_synthetic's decoder
    save("vae_decoder_qu8", *quantize_graph_weights(g.to_text(), g.weights))
    cal = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    cal.calibrate_decoder(True)
    cal.decode(_latent())
    qdir = tmp_path / "vae_decoder_qu8"
    cal.calibration_ranges().write(str(qdir / "range_data.txt"))
    (tmp_path / "tokenizer").mkdir()
    vocab = {chr(ord("a") + i) + "</w>": 10 + i for i in range(26)}
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))

    pipes = [StableDiffusionPipeline.from_dir(str(tmp_path), compute_dtype="float32", res=(128, 128), device=CPU),
             JaxPipeline.from_dir(str(tmp_path), compute_dtype="float32", res=(128, 128))]
    cfg = pipes[0].vae_decoder.config
    assert cfg.use_uint8_arithmetic and "latent" in cfg.range_data and pipes[0].vae_tile_session is None
    outs = []
    for p in pipes:
        p._clip_seq = CLIP_TINY.seq  # the tiny encoder's context, as from_synthetic sets it
        outs.append(p.generate("a b c", steps=2, seed=3, sampler="euler"))
    np.testing.assert_allclose(outs[0].latents, outs[1].latents, rtol=3e-4, atol=3e-4)
    assert _levels(outs[0].image, outs[1].image) <= 1
    assert "qconv" in pipes[0].vae_decoder._executor().quant_routes.values()


# ------------------------------------------------------------------------ CLI
def test_sd_cli_image(tmp_path):
    from PIL import Image

    from onnxstream_tpu_torch.cli.sd_main import main

    out = str(tmp_path / "img.png")
    rc = main(["--synthetic", "tiny", "--device", "cpu", "--steps", "2", "--seed", "5", "--prompt", "a cat",
               "--output", out, "--compute-dtype", "float32", "--embed-parameters"])
    assert rc == 0
    im = Image.open(out)
    assert im.size == (32, 32)
    assert "a cat" in (im.text or {}).get("parameters", "")


def test_sd_cli_decode_latents_and_calibrate(tmp_path, monkeypatch):
    from onnxstream_tpu_torch.cli.sd_main import main

    monkeypatch.chdir(tmp_path)
    lat = str(tmp_path / "l.bin")
    rc = main(["--synthetic", "tiny", "--device", "cpu", "--steps", "2", "--save-latents", lat,
               "--compute-dtype", "float32", "--sampler", "dpm++2m"])
    assert rc == 0 and os.path.getsize(lat) == 4 * 16 * 16 * 4
    rc = main(["--synthetic", "tiny", "--device", "cpu", "--decode-latents", lat, "--output", "d.png",
               "--compute-dtype", "float32", "--decoder-calibrate", "--not-tiled"])
    assert rc == 0 and os.path.exists("d.png")
    ranges = RangeData.read(str(tmp_path / "range_data.txt")).data
    assert "latent" in ranges and len(ranges) > 5


@pytest.mark.parametrize("flag", ["--download"])
def test_sd_cli_refuses_later_slices(flag, tmp_path, monkeypatch):
    """--download is no longer refused: with --models-path the CLI fetches
    the stable-diffusion-1.5 catalog entry first, as the JAX CLI does. The
    entry points at a file:// folder in the reference's layout written from
    the TINY graphs (tokenizer, text_encoder_fp32, unet_fp16, vae_decoder_fp16,
    vae_decoder_qu8 with its range_data.txt); every file arrives, and a
    decode from the fetched folder writes the bytes a decode from the source
    folder writes."""
    from onnxstream_tpu_torch.cli.sd_main import main
    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights
    from onnxstream_tpu_torch.models.sd.clip import CLIP_TINY, build_text_encoder
    from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet
    from onnxstream_tpu_torch.utils.download import MODEL_CATALOG

    src, dst = tmp_path / "src", tmp_path / "dst"
    build_text_encoder(CLIP_TINY, seed=0).save(str(src / "text_encoder_fp32"))
    build_unet(TINY, seed=1).save(str(src / "unet_fp16"), float16=True)
    vae = build_vae_decoder(dataclasses.replace(VAE_TINY, sample=16), seed=2)
    vae.save(str(src / "vae_decoder_fp16"), float16=True)
    text, weights = quantize_graph_weights(vae.to_text(), vae.weights)
    qdir = src / "vae_decoder_qu8"
    qdir.mkdir()
    (qdir / "model.txt").write_text(text)
    for name, arr in weights.items():
        os.makedirs(os.path.dirname(str(qdir / name)), exist_ok=True)
        np.asarray(arr).tofile(str(qdir / name))
    ranges = RangeData()
    ranges.update("latent", -3.0, 3.0)
    ranges.write(str(qdir / "range_data.txt"))
    (src / "tokenizer").mkdir()
    (src / "tokenizer" / "vocab.txt").write_text("".join(chr(ord("a") + i) + "</w>\n" for i in range(26)))
    (src / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    # the converter writes each Conv weight twice, *_nchw.bin and its (0, 2, 3, 1) *_nhwc.bin companion,
    # which the reference's folders hold and the downloader fetches
    from onnxstream_tpu_torch.ir import parse_model_txt

    for folder in ("text_encoder_fp32", "unet_fp16", "vae_decoder_fp16", "vae_decoder_qu8"):
        for t in parse_model_txt((src / folder / "model.txt").read_text()).weights.values():
            if t.name.endswith("_nchw.bin"):
                a = np.fromfile(str(src / folder / t.name), t.dtype.storage_np).reshape(t.shape)
                np.ascontiguousarray(a.transpose(0, 2, 3, 1)).tofile(str(src / folder / (t.name[:-9] + "_nhwc.bin")))
    name = "stable-diffusion-1.5"
    monkeypatch.setitem(MODEL_CATALOG, name, {**MODEL_CATALOG[name], "url": f"file://{src}/"})
    lat = str(tmp_path / "l.bin")
    _latent().astype(np.float32).tofile(lat)
    argv = ["--device", "cpu", "--res", "128x128", "--decode-latents", lat, "--compute-dtype", "float32",
            "--not-tiled"]
    assert main(argv + ["--models-path", str(src), "--output", str(tmp_path / "want.png")]) == 0
    assert main(argv + ["--models-path", str(dst), flag, "--output", str(tmp_path / "got.png")]) == 0
    rel = lambda root: sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)
    assert rel(str(dst)) == rel(str(src)) and len(rel(str(src))) > 100
    assert (tmp_path / "got.png").read_bytes() == (tmp_path / "want.png").read_bytes()


# ------------------------------------------------- the copied numpy modules
def test_rng_copy_matches_jax():
    for seed in (0, 1, 42, 999):
        np.testing.assert_array_equal(rng.randn_4_w_h(seed, 8, 6), jax_rng.randn_4_w_h(seed, 8, 6))
    a, b = rng.GlibcRand(123), jax_rng.GlibcRand(123)
    assert [a.rand() for _ in range(50)] == [b.rand() for _ in range(50)]


@pytest.mark.parametrize("prompt", [WEIGHTED, "", "a, b, ((c)), [d:0.5] " * 20, "(unclosed cat"])
def test_tokenizer_copy_matches_jax(prompt):
    vocab = {chr(ord("a") + i) + "</w>": 10 + i for i in range(26)}
    vocab.update({"cat</w>": 40, ",</w>": 267})
    got = tokenizer.ClipTokenizer(vocab, merges=None).encode_with_weights(prompt)
    want = jax_tokenizer.ClipTokenizer(vocab, merges=None).encode_with_weights(prompt)
    assert len(got) == len(want)
    for (t1, m1), (t2, m2) in zip(got, want):
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    assert tokenizer.parse_prompt_attention(prompt) == jax_tokenizer.parse_prompt_attention(prompt)
    h = np.random.RandomState(3).randn(77, 8).astype(np.float32)
    mults = np.asarray(want[-1][1], np.float32)
    np.testing.assert_array_equal(tokenizer.apply_multipliers(h, mults), jax_tokenizer.apply_multipliers(h, mults))


@pytest.mark.parametrize("sampler", samplers.SAMPLERS)
def test_sampler_copy_matches_jax(sampler):
    """Every sampler over 4 steps with a fixed toy denoiser: the same latents
    bit for bit, and the same schedule."""
    assert samplers.SAMPLERS == jax_samplers.SAMPLERS
    np.testing.assert_array_equal(scheduler.sigma_schedule(4), jax_scheduler.sigma_schedule(4))

    def den(x, s):
        return (np.tanh(x) * np.float32(0.8) + np.float32(0.01 * s)).astype(np.float32)

    outs = []
    for mod, sch in ((samplers, scheduler), (jax_samplers, jax_scheduler)):
        sigma = sch.sigma_schedule(4)
        x = (rng.randn_4_w_h(3, 6, 5) * sigma[0]).astype(np.float32)
        st = mod.SamplerState(sampler, 4, seed=11)
        for i in range(4):
            x = mod.prescale_sample(x, sampler, 4, i, sigma, False)
            x = mod.sampler_step(st, x, den(x, float(sigma[i])), sigma, i, den)
        outs.append(np.asarray(x))
    np.testing.assert_array_equal(outs[0], outs[1])


# --------------------------------------------- the GroupNorm routes, end to end
def _set_routes(pipe, **options):
    """Turn the options on in every Session of a pipeline (``set_option``
    re-fuses the loaded graphs)."""
    for s in (pipe.text_encoder, pipe.unet, pipe.vae_decoder, pipe.vae_tile_session):
        if s is not None:
            for name, value in options.items():
                s.set_option(name, value)


def test_pipeline_under_gn_routes_matches_jax():
    """The TINY SD1.5 pipeline with every Session under config A
    (``fuse_gn_conv`` + ``fuse_groupnorm``): the device loop's latents against
    the JAX pipeline under the same options (its fused ops through their jnp
    references on the CPU) at the loop's bar, against the port's default
    pipeline at the fused-vs-decomposed bar, and the decoded image to one level."""
    port, jax = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU), JaxPipeline.from_synthetic(tiny=True)
    base = port.generate_on_device(PROMPT, "dog", steps=3, seed=7, decode=False).latents
    for pipe in (port, jax):
        _set_routes(pipe, fuse_gn_conv=True, fuse_groupnorm=True)
    for s in (port.unet, port.vae_decoder):
        kinds = [op.op_type for op in s.graph.ops]
        assert "ostpu.gn_silu_conv" in kinds and "InstanceNormalization" not in kinds
    got = port.generate_on_device(PROMPT, "dog", steps=3, seed=7, decode=False).latents
    want = jax.generate(PROMPT, "dog", steps=3, seed=7, sampler="euler_a", decode=False).latents
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, base, rtol=5e-4, atol=5e-4)
    assert _levels(port.decode(got), jax.decode(got)) <= 1
    assert _levels(port.decode(got, tiled=True), jax.decode(got, tiled=True)) <= 1


@pytest.mark.parametrize("calibrated_fused", [True, False])
def test_qu8_decode_under_fuse_groupnorm_matches_jax(calibrated_fused):
    """The calibrated W8A8 decoder with its GroupNorm chains fused. Ranges are
    keyed by op name: calibrated under the fusion, a conv quantizes its input
    with the fused op's range; calibrated without it, that name is missing and
    both packages fall back to the conv's own range. Either way every W8A8 op
    picks the (scale, zero point) the JAX executor picks and the convs stay on
    qconv. With the matching calibration the image is the JAX session's to one
    level; with the fallback ranges (a coarser step, so one activation that
    rounds the other way moves the image by a few levels) on average."""
    from onnxstream_tpu.convert.quantize import quantize_graph_weights as jax_quantize

    g = build_vae_decoder(VAE_TINY, seed=7)
    z = np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)
    jcal = JaxSession(JaxConfig(fuse_ops_in_attention=True, range_data_calibrate=True,
                                fuse_groupnorm=calibrated_fused), weights_provider=JaxDict(dict(g.weights)))
    jcal.read_string(g.to_text())
    jcal.add_tensor("latent", z)
    jcal.run(eager=True)
    ranges = dict(jcal._executor().range_data.data)
    assert any(k.endswith("_gn_silu") for k in ranges) == calibrated_fused

    qs = qu8_decoder(g.to_text(), g.weights, ranges, device=CPU)
    qs.set_option("fuse_groupnorm", True)
    jtext, jweights = jax_quantize(g.to_text(), g.weights)
    jq = JaxSession(JaxConfig(fuse_ops_in_attention=True, use_uint8_arithmetic=True, range_data=ranges,
                              fuse_groupnorm=True), weights_provider=JaxDict(jweights))
    jq.read_string(jtext)
    assert [op.name for op in qs.graph.ops] == [op.name for op in jq.graph.ops]
    assert "InstanceNormalization" not in [op.op_type for op in qs.graph.ops]
    imgs = []
    for pipe, sess in ((StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU), qs),
                       (JaxPipeline.from_synthetic(tiny=True), jq)):
        pipe.vae_decoder = sess
        imgs.append(pipe.decode(z[0] * np.float32(pipe.vae_scale)))
    pe, je = qs._executor(), jq._executor()
    assert len(pe._qlinear) == 16
    for i in pe._qlinear:
        got, want = pe._activation_qparams(qs.graph.ops[i]), je._activation_qparams(jq.graph.ops[i])
        assert tuple(map(float, got)) == tuple(map(float, want))
    routes = list(pe.quant_routes.values())
    assert routes.count("qconv") >= sum(op.op_type == "Conv" for op in qs.graph.ops) - 1
    if calibrated_fused:
        assert _levels(*imgs) <= 1
    else:
        assert np.abs(imgs[0].astype(np.int32) - imgs[1].astype(np.int32)).mean() < 1.0

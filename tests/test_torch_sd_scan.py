"""generate_on_device's step and _decode_tiled's tile grid as device programs,
against the JAX package on the CPU.

The port runs one euler / euler_a step (the UNet runs, CFG, the update) as a
``DeviceProgram`` over static buffers read at a device step counter, the
counterpart of JAX's ``lax.scan`` body; on a card the program is captured
into one CUDA graph and replayed once a step. The tiled decode is one such
program over a latent buffer. Here, on the CPU, the same bodies run step by
step without a graph (the code path the card captures, minus the capture):

  * the per-step stack the port builds equals, float32-exact, the one the
    JAX package's ``generate_on_device`` builds from its scheduler and
    samplers modules, and the seeded normal latents from libstdc++ equal
    the Python polar method's and the JAX package's;
  * the loop's latents are within rtol = atol = 3e-4 of JAX's
    ``generate_on_device`` (the bar of tests/test_torch_sd_pipeline.py) for
    SD1.5 and SDXL with a batch-1 UNet (its segment function vmapped over
    the CFG pair, one call a step, as JAX's ``jax.vmap``), SD1.5 with a
    batch-2 UNet (the CFG pair as one run; JAX vmaps a batch-1 UNet over the
    pair) and Turbo, with euler and euler_a, and again over later calls
    under the same key with other seeds, prompts and samplers (the buffers
    are refilled and the counter zeroed);
  * the tiled decode is within one level of JAX's vmapped ``_decode_tiled``
    at several (tile, stride, ramp) settings, under the calibrated W8A8 and
    the ``use_uint8_qdq`` tile decoders, and for a latent smaller than the
    tile, the decoder's segment function called once a grid;
  * the warm-up / capture / replay rule, with the capture stood in for.

The captures themselves run on the card: tests/test_torch_capture_card.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from onnxstream_tpu.models.sd import rng as jax_rng
from onnxstream_tpu.models.sd import samplers as jax_samplers
from onnxstream_tpu.models.sd import scheduler as jax_sched
from onnxstream_tpu.models.sd.pipeline import StableDiffusionPipeline as JaxPipeline
from onnxstream_tpu_torch import Session
from onnxstream_tpu_torch.models.sd import pipeline as sd_pipeline
from onnxstream_tpu_torch.models.sd import rng as sd_rng
from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline, step_stack
from onnxstream_tpu_torch.runtime import executor as executor_mod
from onnxstream_tpu_torch.runtime.executor import capture_problem, segment_fn_problem

CPU = torch.device("cpu")
PROMPT = "a photo of a fluffy cat riding a horse"
TOL = 3e-4  # tests/test_torch_sd_pipeline.py:76, the JAX suite's on-device-vs-host bar

# family -> (the port's from_synthetic options, the JAX pipeline's): the
# batch-2 UNet is held to JAX's vmapped batch-1 loop, which JAX runs for it
FAMILIES = {
    "sd15": ({}, {}),
    "sd15_batch2": ({"batch": 2}, {}),
    "sdxl": ({"xl": True}, {"xl": True}),
    "turbo": ({"xl": True, "turbo": True}, {"xl": True, "turbo": True}),
}


@pytest.fixture(scope="module")
def ports():
    return {}


@pytest.fixture(scope="module")
def jaxes():
    return {}


def _jax(jaxes, family):
    jkw = FAMILIES[family][1]
    jkey = tuple(sorted(jkw.items()))
    if jkey not in jaxes:
        jaxes[jkey] = JaxPipeline.from_synthetic(tiny=True, **jkw)
    return jaxes[jkey]


def _pair(ports, jaxes, family):
    if family not in ports:
        ports[family] = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU, **FAMILIES[family][0])
    return ports[family], _jax(jaxes, family)


@contextlib.contextmanager
def _no_session_runs(sess: Session):
    """Session.run of sess raises inside: the body calls the segment
    function, as the graph the card captures does."""
    def refuse(*args, **kw):
        raise AssertionError("the device program ran the session")

    sess.run = refuse
    try:
        yield
    finally:
        del sess.run


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _step_programs(pipe):
    return {k: p for k, p in pipe.device_programs.items() if k[0] == "gen"}


# family -> the step's form (key[5]) and the words of its program's name
FORMS = {"sd15": ("vmap", "batch-1 UNet vmapped over the CFG pair"), "sd15_batch2": ("pair", "batch-2 UNet"),
         "sdxl": ("vmap", "batch-1 UNet vmapped over the CFG pair"), "turbo": ("cond", "cond only")}


@pytest.fixture
def segment_runs(monkeypatch):
    """The executors whose segment ran, one entry a run of a segment
    function (a vmapped call is one run)."""
    runs = []
    run = executor_mod.Executor._run_segment

    def spy(self, *a, **kw):
        runs.append(self)
        return run(self, *a, **kw)

    monkeypatch.setattr(executor_mod.Executor, "_run_segment", spy)
    return runs


# -------------------------------------------------------------- the per-step stack
def _jax_stack(steps, seed, sampler, turbo, latw, lath):
    """The per-step stack as JAX's generate_on_device builds it
    (onnxstream_tpu/models/sd/pipeline.py:519-540, 625-632), from the JAX
    package's own modules."""
    sigma = jax_sched.sigma_schedule(steps)
    x0 = np.asarray(jax_rng.randn_4_w_h(seed % 1000, latw, lath) * sigma[0], np.float32)
    state = jax_samplers.SamplerState(sampler, steps, seed=seed, turbo=turbo)
    c_ins, c_outs, ts, slopes, ups, noises = [], [], [], [], [], []
    for i in range(steps):
        s_cur = float(sigma[i])
        c_in, c_out = jax_sched.get_scalings(s_cur)
        c_ins.append(c_in)
        c_outs.append(c_out)
        ts.append(jax_sched.sigma_to_t(s_cur))
        if sampler == "euler_a":
            up, down = jax_samplers._ancestral_sigmas(s_cur, float(sigma[i + 1]))
            noises.append(state.noise(latw, lath))
            slopes.append((down - s_cur) / s_cur)
            ups.append(up)
        else:
            si1 = jax_samplers._reshaper(float(sigma[i + 1]), i, steps, turbo)
            noises.append(np.zeros_like(x0))
            slopes.append((si1 - s_cur) / s_cur)
            ups.append(0.0)
    return x0, {"ts": np.asarray(ts, np.float32), "c_in": np.asarray(c_ins, np.float32),
                "c_out": np.asarray(c_outs, np.float32), "slope": np.asarray(slopes, np.float32),
                "up": np.asarray(ups, np.float32), "noise": np.stack(noises).astype(np.float32)}


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("turbo", [False, True], ids=["base", "turbo"])
@pytest.mark.parametrize("sampler", ["euler", "euler_a"])
def test_step_stack_matches_jax(sampler, turbo, steps):
    x0, got = step_stack(steps, 1234, sampler, turbo, 12, 10)
    jx0, want = _jax_stack(steps, 1234, sampler, turbo, 12, 10)
    assert x0.dtype == np.float32 and x0.shape == (4, 10, 12)
    np.testing.assert_array_equal(x0, jx0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if sampler == "euler_a":
        # the last step goes to sigma 0: no noise is added there
        assert np.abs(got["noise"]).max() > 0 and (got["up"][:-1] > 0).all() and got["up"][-1] == 0
    else:
        assert not got["noise"].any() and not got["up"].any()


@pytest.mark.parametrize("seed,w,h", [(0, 8, 6), (5, 64, 64), (999, 128, 128), (123, 7, 3), (4294967295, 1, 1)])
def test_randn_from_libstdcxx_equals_the_polar_method_and_jax(seed, w, h):
    """randn_4_w_h calls libstdc++'s mt19937 and normal_distribution<float>:
    the bits of the Python polar method it replaced and of the JAX package's."""
    got = sd_rng.randn_4_w_h(seed, w, h)
    assert got.dtype == np.float32 and got.shape == (4, h, w)
    want = sd_rng.NormalDistributionFloat(sd_rng.MT19937(seed)).fill(4 * w * h).reshape(4, h, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_rng.randn_4_w_h(seed, w, h))


# ------------------------------------------------------------------ the step body
@pytest.mark.parametrize("sampler", ["euler", "euler_a"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_step_body_matches_jax_generate_on_device(ports, jaxes, family, sampler, segment_runs):
    port, jax = _pair(ports, jaxes, family)
    kw = dict(steps=3, seed=7, sampler=sampler, decode=False)
    with _no_session_runs(port.unet):
        got = port.generate_on_device(PROMPT, "dog", **kw).latents
    _close(got, jax.generate_on_device(PROMPT, "dog", **kw).latents)
    (key, prog), = [(k, p) for k, p in _step_programs(port).items() if k[1] == 3]
    form, words = FORMS[family]
    assert key[:4] == ("gen", 3, family == "turbo", 7.0) and key[5] == form and key[6] is True
    assert words in prog.what
    # one call of the UNet's segment function a step: the pair vmapped, batched or cond only
    assert sum(ex is prog.ex for ex in segment_runs) == 3
    # the counter ran once a step; nothing was captured on the CPU
    assert int(prog.static["counter"][0]) == 3 and prog.graph is None and prog.captures == 0
    assert "runs on cpu" in port.loop_capture_problem()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_later_calls_under_one_key_refill_the_buffers(ports, jaxes, family):
    """Three calls under one key (steps 2, cfg 5): other seeds, prompts and
    samplers, each the JAX package's latents, through one program."""
    port, jax = _pair(ports, jaxes, family)
    seen = []
    for prompt, neg, seed, sampler in (("a cat", "dog", 3, "euler_a"), (PROMPT, "", 11, "euler"),
                                       ("a dog", "blurry", 5, "euler_a")):
        kw = dict(steps=2, seed=seed, sampler=sampler, cfg_scale=5.0, decode=False)
        got = port.generate_on_device(prompt, neg, **kw).latents
        _close(got, jax.generate_on_device(prompt, neg, **kw).latents)
        seen.append(got)
        progs = [p for k, p in _step_programs(port).items() if k[1] == 2 and k[3] == 5.0]
        assert len(progs) == 1
    assert not np.allclose(seen[0], seen[1]) and not np.allclose(seen[0], seen[2])


def test_a_streamed_unet_runs_the_same_body_through_session_run(jaxes):
    """A UNet streamed from its provider (hbm_budget_bytes > 0) has a
    segment_fn_problem: the same step calls Session.run, twice a step, and
    gives JAX's latents."""
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    port.unet.config.hbm_budget_bytes = 64 << 10
    runs, run = [], port.unet.run
    port.unet.run = lambda *a, **kw: runs.append(1) or run(*a, **kw)
    try:
        got = port.generate_on_device(PROMPT, "dog", steps=2, seed=9, sampler="euler_a", decode=False).latents
    finally:
        del port.unet.run
    assert len(runs) == 4
    ex = port._loop_executor(1)
    assert len(ex.segments) > 1 and "streamed" in segment_fn_problem(ex)
    assert "runs on cpu" in port.loop_capture_problem()
    jax = _jax(jaxes, "sd15")
    _close(got, jax.generate_on_device(PROMPT, "dog", steps=2, seed=9, sampler="euler_a", decode=False).latents)


# (config, words of segment_fn_problem's reason; None: the body calls the segment function)
SEGMENT_FN_CASES = {
    "resident": ({}, None),
    "qdq": ({"use_uint8_qdq": True}, None),
    "streamed": ({"hbm_budget_bytes": 64 << 10}, "streamed"),
    "pp_devices": ({"hbm_budget_bytes": 64 << 10, "pp_devices": [CPU, CPU]}, "pipeline stages on 2"),
    "ops_printf": ({"ops_printf": True}, "ops_printf"),
    "calibration": ({"range_data_calibrate": True}, "range_data_calibrate"),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_FN_CASES))
def test_segment_fn_problem_names_what_needs_session_run(case):
    config, words = SEGMENT_FN_CASES[case]
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    for k, v in config.items():
        setattr(port.unet.config, k, v)
    ex = port._loop_executor(1)
    problem = segment_fn_problem(ex)
    assert (problem is None) if words is None else (words in problem), problem
    # on the CPU nothing is captured, whatever else stands in the way
    assert "runs on cpu" in capture_problem(ex)


def test_the_first_run_warms_up_the_second_captures_and_later_ones_replay(monkeypatch, jaxes):
    """The capture rule with the capture stood in for (its replay runs the
    body, as a real replay runs its ops): step 0 of the first call runs op by
    op, step 1 captures, every later step of that call and of later calls
    under the key replays; inside eager() the body runs op by op and the
    graph stays; a changed option drops it, and the loop warms up again."""
    captures = []

    class FakeGraph:
        def __init__(self, body):
            self.body, self.outputs, self.replays = body, None, 0

        def replay(self):
            self.replays += 1
            self.outputs = self.body()

    def fake_capture(body, device, pool, what, failed_at, static=(), holds=()):
        captures.append(what)
        return FakeGraph(body)

    monkeypatch.setattr(sd_pipeline, "capture_problem", lambda ex: None)
    monkeypatch.setattr(sd_pipeline, "capture_graph", fake_capture)
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    jax = _jax(jaxes, "sd15")
    bodies = []
    kw = dict(steps=3, seed=7, sampler="euler_a", decode=False)
    want = jax.generate_on_device(PROMPT, "dog", **kw).latents
    for call in range(3):
        _close(port.generate_on_device(PROMPT, "dog", **kw).latents, want)
        (prog,) = _step_programs(port).values()
        bodies.append(prog.graph.replays)
    assert captures == [prog.what] and prog.captures == 1
    assert "SD step (3 steps, batch-1 UNet vmapped over the CFG pair" in prog.what
    assert bodies == [2, 5, 8]  # step 0 of the first call ran op by op
    with port.eager():
        _close(port.generate_on_device(PROMPT, "dog", **kw).latents, want)
    assert prog.graph.replays == 8 and prog.captures == 1
    port.unet.config.use_flash_attention = False  # another dispatch key
    _close(port.generate_on_device(PROMPT, "dog", **kw).latents, want)
    assert prog.captures == 2 and prog.graph.replays == 2
    # the tiled decode: one program, eager at first, captured at the second call
    lat = np.random.RandomState(2).randn(4, 16, 16).astype(np.float32)
    imgs = [port.decode(lat, tiled=True) for _ in range(3)]
    (tile_prog,) = [p for k, p in port.device_programs.items() if k[0] == "tile"]
    assert tile_prog.captures == 1 and tile_prog.graph.replays == 2
    assert all(_levels(img, imgs[0]) == 0 for img in imgs)


# ------------------------------------------------------------------ the tile grid
@pytest.mark.parametrize("tile,stride,ramp", [(8, 6, 4), (8, 5, 6), (8, 3, 16), (8, 8, 0), (None, None, None)])
def test_tiled_decode_matches_jax(ports, jaxes, tile, stride, ramp, segment_runs):
    port, jax = _pair(ports, jaxes, "sd15")
    lat = np.random.RandomState(5).randn(4, 16, 16).astype(np.float32)
    with _no_session_runs(port.vae_tile_session):
        got = [port._decode_tiled(lat * s, tile=tile, stride=stride, ramp=ramp) for s in (1.0, 0.5)]
    # the decoder's segment function once a grid (JAX's vmap over the tiles), not once a tile
    assert len(segment_runs) == 2 and all(ex is port.vae_tile_session._executor() for ex in segment_runs)
    for s, img in zip((1.0, 0.5), got):
        assert img.shape == (32, 32, 3)
        assert _levels(img, jax._decode_tiled(lat * s, tile=tile, stride=stride, ramp=ramp)) <= 1
    assert _levels(got[0], got[1]) > 0
    want = (8, stride or 6, 4 if ramp is None else ramp)  # (tile, stride, ramp), the defaults filled in
    keys = [k for k in port.device_programs if k[0] == "tile" and k[2:5] == want]
    assert len(keys) == 1 and keys[0][1] == id(port.vae_tile_session)


def _qu8_tile_decoders(port, jax, lat):
    """The calibrated W8A8 tile decoders of both packages: the TINY tile
    decoder's graph calibrated by the JAX session on the tiles of the scaled
    latent ``lat`` (``--decoder-calibrate`` on the latents it then decodes),
    its weights quantized by each package's converter (as
    ``vae_decoder_qu8`` holds them)."""
    import dataclasses

    from onnxstream_tpu.convert.quantize import quantize_graph_weights as jax_quantize
    from onnxstream_tpu.models.sd.vae import VAE_TINY as JAX_VAE_TINY
    from onnxstream_tpu.models.sd.vae import build_vae_decoder as jax_build_vae_decoder
    from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
    from onnxstream_tpu.runtime.session import Session as JaxSession
    from onnxstream_tpu.runtime.weights import DictWeightsProvider as JaxDict
    from onnxstream_tpu_torch.models.sd.pipeline import qu8_decoder
    from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder

    g = build_vae_decoder(dataclasses.replace(VAE_TINY, sample=port._tile_size), seed=2)
    jg = jax_build_vae_decoder(dataclasses.replace(JAX_VAE_TINY, sample=port._tile_size), seed=2)
    jcal = JaxSession(JaxConfig(fuse_ops_in_attention=True, range_data_calibrate=True),
                      weights_provider=JaxDict(dict(jg.weights)))
    jcal.read_string(jg.to_text())
    z, t = lat / np.float32(jax.vae_scale), port._tile_size
    ys, xs = jax._tile_grid(z.shape[1], z.shape[2], t, t * 3 // 4)
    for sy in ys:
        for sx in xs:
            jcal.add_tensor("latent", np.ascontiguousarray(z[None, :, sy:sy + t, sx:sx + t]))
            jcal.run(eager=True)
    ranges = dict(jcal._executor().range_data.data)
    jtext, jweights = jax_quantize(jg.to_text(), jg.weights)
    jq = JaxSession(JaxConfig(fuse_ops_in_attention=True, use_uint8_arithmetic=True, range_data=ranges),
                    weights_provider=JaxDict(jweights))
    jq.read_string(jtext)
    return qu8_decoder(g.to_text(), g.weights, ranges, device=CPU), jq


@pytest.mark.parametrize("decoder", ["w8a8", "uint8_qdq"])
def test_tiled_decode_under_quantized_decoders_matches_jax(decoder, segment_runs):
    """The calibrated W8A8 tile decoder (kernels 3 and 4 under the vmap, the
    activations quantized per example's range) and QDQ without ranges (each
    tile's percentiles its own, as under JAX's vmap): one decoder call a
    grid, within one level of JAX's vmapped ``_decode_tiled``."""
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    jax = JaxPipeline.from_synthetic(tiny=True)
    lat = np.random.RandomState(8).randn(4, 16, 16).astype(np.float32)
    if decoder == "w8a8":
        port.vae_tile_session, jax.vae_tile_session = _qu8_tile_decoders(port, jax, lat)
    else:
        port.vae_tile_session.config.use_uint8_qdq = jax.vae_tile_session.config.use_uint8_qdq = True
    with _no_session_runs(port.vae_tile_session):
        got = port._decode_tiled(lat)
    assert len(segment_runs) == 1
    routes = set(port.vae_tile_session._executor().quant_routes.values())
    assert routes >= {"qconv", "qmatmul"} if decoder == "w8a8" else not routes
    assert _levels(got, jax._decode_tiled(lat)) <= 1


def test_a_latent_smaller_than_the_tile_decodes_as_one_clamped_tile(jaxes):
    """Tiles of 32 over a 16 x 16 latent, through the whole decoder: one tile
    of 16 (stride 12, ramp 8, all of it at origin 0), JAX's image, which is
    the plain decode's."""
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    jax = _jax(jaxes, "sd15")
    port.vae_tile_session = None
    lat = np.random.RandomState(6).randn(4, 16, 16).astype(np.float32)
    got = port._decode_tiled(lat, tile=32)
    jax_tile = jax.vae_tile_session
    jax.vae_tile_session = None
    try:
        want = jax._decode_tiled(lat, tile=32)
    finally:
        jax.vae_tile_session = jax_tile
    assert _levels(got, want) <= 1 and _levels(got, port.decode(lat)) == 0
    (key,) = [k for k in port.device_programs if k[0] == "tile"]
    assert key[1:7] == (id(port.vae_decoder), 16, 12, 8, 16, 16)


def test_calibration_through_a_tiled_decode_records_ranges():
    """range_data_calibrate is a segment_fn_problem: the tiles go through
    Session.run's per-op interpreter, which records the ranges."""
    port = StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)
    lat = np.random.RandomState(7).randn(4, 16, 16).astype(np.float32)
    port.calibrate_decoder(True)
    port.decode(lat, tiled=True)
    port.calibrate_decoder(False)
    ranges = port.calibration_ranges().data
    assert "latent" in ranges and len(ranges) > 5
    assert not [k for k in port.device_programs if k[0] == "tile" and k[-1]]
    port.decode(lat, tiled=True)
    assert [k for k in port.device_programs if k[0] == "tile" and k[-1]]

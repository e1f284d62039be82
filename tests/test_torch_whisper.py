"""The port's Whisper path against the JAX package, on the CPU.

The mel features bit for bit; the encoder / decoder builders' text and
weights equal; encoder outputs and decoder logits at WHISPER_TINY_TEST in
float32 within rtol = atol = 1e-4 (the JAX suite's bar for float32 reference
paths), in bfloat16 within 5e-2 * max; greedy tokens equal on several audio
seeds; the incremental decode against a full prefill; the first-step
suppression; the CLI; ``from_dir`` on a folder written from the builders;
``from_hf`` against the JAX pipeline and transformers' own logits. Inputs
come from numpy seeds.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from onnxstream_tpu.cli.whisper_main import main as jax_cli
from onnxstream_tpu.models.whisper import mel as jax_mel
from onnxstream_tpu.models.whisper import model as jax_model
from onnxstream_tpu.models.whisper.pipeline import WhisperPipeline as JaxWhisper
from onnxstream_tpu_torch.cli.whisper_main import main as port_cli
from onnxstream_tpu_torch.models.whisper import mel as port_mel
from onnxstream_tpu_torch.models.whisper import model as port_model
from onnxstream_tpu_torch.models.whisper.model import WHISPER_TINY_TEST, mangle
from onnxstream_tpu_torch.models.whisper.pipeline import WhisperPipeline

CPU = torch.device("cpu")
SR = 16000


def _audio(kind: str, seed: int = 0, seconds: float = 1.0) -> np.ndarray:
    n = int(SR * seconds)
    t = np.arange(n) / SR
    if kind == "noise":
        return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)
    if kind == "tone":
        return (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    if kind == "chirp":
        return (0.3 * np.sin(2 * np.pi * (100 + 1000 * t) * t)).astype(np.float32)
    return np.zeros(n, np.float32)


AUDIO = [("noise", 0), ("noise", 1), ("noise", 2), ("tone", 0), ("chirp", 0), ("silence", 0)]


@pytest.fixture(scope="module")
def pipes():
    return JaxWhisper.from_synthetic(), WhisperPipeline.from_synthetic(device=CPU)


# ------------------------------------------------------------------ mel
@pytest.mark.parametrize("kind,seed", AUDIO + [("noise_short", 0)])
def test_mel_features_bit_for_bit(kind, seed):
    a = _audio("noise", seed, 0.01) if kind == "noise_short" else _audio(kind, seed)
    for pad_to in (3000, 16):
        want = jax_mel.log_mel_spectrogram(a, pad_to=pad_to)
        got = port_mel.log_mel_spectrogram(a, pad_to=pad_to)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_mel_banks_and_raw_audio_bit_for_bit(tmp_path):
    np.testing.assert_array_equal(port_mel.librosa_mel_banks(), jax_mel.librosa_mel_banks())
    raw = tmp_path / "a.raw"
    (np.random.RandomState(0).randn(4000) * 3000).astype("<i2").tofile(str(raw))
    np.testing.assert_array_equal(port_mel.read_16bit_raw_audio(str(raw)), jax_mel.read_16bit_raw_audio(str(raw)))


# ------------------------------------------------------------------ builders
def _builders(pkg, which, cfg):
    if which == "encoder":
        return pkg.build_encoder(cfg, seed=3)
    return pkg.build_decoder(cfg, new_len=int(which[-1]), seed=4)


@pytest.mark.parametrize("which", ["encoder", "decoder_L4", "decoder_L1"])
def test_builders_match_jax(which):
    cfg = WHISPER_TINY_TEST
    jcfg = jax_model.WHISPER_TINY_TEST
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jb, pb = _builders(jax_model, which, jcfg), _builders(port_model, which, cfg)
    assert pb.to_text() == jb.to_text()
    assert sorted(pb.weights) == sorted(jb.weights)
    for name, arr in jb.weights.items():
        np.testing.assert_array_equal(pb.weights[name], arr)
        assert pb.weights[name].dtype == arr.dtype


def test_base_config_matches_jax():
    assert dataclasses.asdict(port_model.WHISPER_BASE) == dataclasses.asdict(jax_model.WHISPER_BASE)
    assert port_model.WHISPER_BASE.sot_sequence == jax_model.WHISPER_BASE.sot_sequence
    np.testing.assert_array_equal(port_model._sinusoids(1500, 512), jax_model._sinusoids(1500, 512))


def test_base_encoder_has_six_packed_attention_sites_at_1500_tokens():
    """At WHISPER_BASE the fused encoder holds 6 ostpu.sdpa ops with 8 packed
    heads over (1, 1500, 512): the sites that take kernel 1 on the card."""
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    b = port_model.build_encoder(port_model.WHISPER_BASE)
    s = Session(SessionConfig(device=CPU), weights_provider=DictWeightsProvider(params_from_numpy(b.weights)))
    s.read_string(b.to_text())
    sites = [op for op in s.graph.ops if op.op_type == "ostpu.sdpa"]
    assert len(sites) == 6 and all(op.attr_int("heads", 0) == 8 for op in sites)
    assert all(op.attr_int("causal", 0) == 0 and len(op.inputs) == 3 for op in sites)
    s.add_tensor(mangle("mel"), np.zeros((1, 80, 3000), np.float32))
    avals = s._executor().plan.avals  # planned on meta tensors: nothing runs
    assert all(avals[t.name].shape == (1, 1500, 512) for op in sites for t in op.inputs)


# ------------------------------------------------------------------ graphs
def _run_encoder(pipe, mel):
    pipe.encoder.clear_tensors()
    pipe.encoder.add_tensor(mangle("mel"), mel)
    out = pipe.encoder.run()
    return [np.asarray(out[mangle(n)], np.float32) for n in ("n_layer_cross_k", "n_layer_cross_v")]


def _run_decoder(pipe, tokens, offset, sk, sv, ck, cv):
    sess = pipe._decoder(len(tokens))
    sess.clear_tensors()
    sess.add_tensor(mangle("tokens"), np.asarray([tokens], np.int64))
    sess.add_tensor(mangle("offset"), np.asarray([offset], np.int64))
    sess.add_tensor(mangle("in_n_layer_self_k_cache"), sk)
    sess.add_tensor(mangle("in_n_layer_self_v_cache"), sv)
    sess.add_tensor(mangle("n_layer_cross_k"), ck)
    sess.add_tensor(mangle("n_layer_cross_v"), cv)
    out = sess.run()
    return [np.asarray(out[mangle(n)], np.float32)
            for n in ("logits", "out_n_layer_self_k_cache", "out_n_layer_self_v_cache")]


def _zeros(cfg):
    return np.zeros((cfg.n_text_layer, 1, cfg.n_text_ctx, cfg.n_text_state), np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_encoder_and_decoder_match_jax_fp32(pipes):
    jp, pp = pipes
    cfg = pp.cfg
    mel = port_mel.log_mel_spectrogram(_audio("chirp"), pad_to=2 * cfg.n_audio_ctx)
    want, got = _run_encoder(jp, mel), _run_encoder(pp, mel)
    for g, w in zip(got, want):
        assert g.shape == (cfg.n_text_layer, 1, cfg.n_audio_ctx, cfg.n_text_state)
        _close(g, w, 1e-4)
    ck, cv = want
    seq = list(cfg.sot_sequence)
    jl, jk, jv = _run_decoder(jp, seq, 0, _zeros(cfg), _zeros(cfg), ck, cv)
    pl, pk, pv = _run_decoder(pp, seq, 0, _zeros(cfg), _zeros(cfg), ck, cv)
    for g, w in ((pl, jl), (pk, jk), (pv, jv)):
        _close(g, w, 1e-4)
    jl, _, _ = _run_decoder(jp, [7], 4, jk, jv, ck, cv)
    pl, _, _ = _run_decoder(pp, [7], 4, pk, pv, ck, cv)
    assert pl.shape == (1, 1, cfg.n_vocab)
    _close(pl, jl, 1e-4)


def test_encoder_and_decoder_match_jax_bf16():
    jp = JaxWhisper.from_synthetic(compute_dtype="bfloat16")
    pp = WhisperPipeline.from_synthetic(compute_dtype="bfloat16", device=CPU)
    cfg = pp.cfg
    mel = port_mel.log_mel_spectrogram(_audio("noise", 4), pad_to=2 * cfg.n_audio_ctx)
    want, got = _run_encoder(jp, mel), _run_encoder(pp, mel)
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= 5e-2 * float(np.abs(w).max())
    jl = _run_decoder(jp, list(cfg.sot_sequence), 0, _zeros(cfg), _zeros(cfg), *want)[0]
    pl = _run_decoder(pp, list(cfg.sot_sequence), 0, _zeros(cfg), _zeros(cfg), *want)[0]
    assert float(np.abs(pl - jl).max()) <= 5e-2 * float(np.abs(jl).max())


@pytest.mark.parametrize("kind,seed", AUDIO)
def test_transcribe_tokens_match_jax(pipes, kind, seed):
    jp, pp = pipes
    a = _audio(kind, seed)
    want = jp.transcribe(a, max_tokens=8)
    assert pp.transcribe(a, max_tokens=8) == want


def test_transcribe_to_the_buffer_end_matches_jax(pipes):
    """No max_tokens: the loop runs until eot or the n_text_ctx buffer is full."""
    jp, pp = pipes
    a = _audio("noise", 5)
    assert pp.transcribe(a) == jp.transcribe(a)
    assert pp.transcribe(a, language_token=5, max_tokens=6) == jp.transcribe(a, language_token=5, max_tokens=6)


def test_one_plan_per_session_as_the_offset_grows(pipes):
    """One encoder plan, and one decoder Session for each of L = 4 and L = 1
    with one plan each however far the offset goes; the buffers fed back
    stay tensors in the compute dtype."""
    _, pp = pipes
    pp.transcribe(_audio("tone"), max_tokens=10)
    assert sorted(pp._decoders) == [1, 4]
    assert len(pp.encoder._executors) == 1
    assert all(len(s._executors) == 1 for s in pp._decoders.values())
    ck, _ = pp.encode(_audio("tone"))
    assert isinstance(ck, torch.Tensor) and ck.dtype == torch.float32


def test_incremental_matches_full_prefill(pipes):
    """Step-by-step decode over the fixed self-KV buffer equals one pass over
    the whole sequence (tests/test_whisper.py's check, on the port)."""
    _, pp = pipes
    cfg = pp.cfg
    seq = list(cfg.sot_sequence) + [5, 12]
    rng = np.random.RandomState(3)
    NL, Ta, d = cfg.n_text_layer, cfg.n_audio_ctx, cfg.n_text_state
    ck = rng.rand(NL, 1, Ta, d).astype(np.float32)
    cv = rng.rand(NL, 1, Ta, d).astype(np.float32)
    full = _run_decoder(pp, seq, 0, _zeros(cfg), _zeros(cfg), ck, cv)[0]
    lg, sk, sv = _run_decoder(pp, seq[:4], 0, _zeros(cfg), _zeros(cfg), ck, cv)
    np.testing.assert_allclose(lg[0], full[0, :4], rtol=1e-4, atol=1e-5)
    lg, sk, sv = _run_decoder(pp, [seq[4]], 4, sk, sv, ck, cv)
    np.testing.assert_allclose(lg[0, 0], full[0, 4], rtol=1e-4, atol=1e-5)
    lg, sk, sv = _run_decoder(pp, [seq[5]], 5, sk, sv, ck, cv)
    np.testing.assert_allclose(lg[0, 0], full[0, 5], rtol=1e-4, atol=1e-5)


def test_first_step_suppresses_eot_and_blank(pipes):
    jp, pp = pipes
    toks = pp.transcribe(np.zeros(8000, np.float32), max_tokens=1)
    assert len(toks) == 1 and toks[0] not in (pp.cfg.eot, pp.cfg.blank_id)
    assert toks == jp.transcribe(np.zeros(8000, np.float32), max_tokens=1)
    cfg = pp.cfg
    for t in (cfg.sot, cfg.no_timestamps, cfg.no_speech, cfg.translate, cfg.eot):
        assert t not in pp.transcribe(_audio("noise", 0), max_tokens=8)


def test_no_device_means_the_card():
    """Without a device the pipeline runs on cuda:0, and raises where there
    is no card: the CPU is used only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperPipeline.from_synthetic()


def test_cli_prints_the_jax_clis_tokens(tmp_path, capsys):
    raw = tmp_path / "audio.raw"
    (np.random.RandomState(0).randn(16000) * 3276).astype("<i2").tofile(str(raw))
    argv = ["--synthetic", "--audio", str(raw), "--max-tokens", "4"]
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    assert port_cli(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "tokens:" in got and got == want


def test_cli_needs_a_model_source(tmp_path):
    raw = tmp_path / "audio.raw"
    np.zeros(1600, "<i2").tofile(str(raw))
    assert port_cli(["--audio", str(raw), "--device", "cpu"]) == 2


# ------------------------------------------------------------------ from_dir
def _write(builder, directory):
    """GraphBuilder.save cannot write weight names that hold '/' (both
    packages), so the folder is written here."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model.txt"), "w") as f:
        f.write(builder.to_text())
    for name, arr in builder.weights.items():
        path = os.path.join(directory, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.asarray(arr).tofile(path)


def test_from_dir_matches_jax_and_the_synthetic_pipeline(tmp_path, pipes):
    """A folder in the reference layout written from the builders (the
    decoder built at L = 1): the port's from_dir against the JAX package's on
    the same folder, and against from_synthetic's sessions of the same seeds.
    One decoder Session serves every L."""
    _, synth = pipes
    cfg = WHISPER_TINY_TEST
    _write(port_model.build_encoder(cfg, seed=0), str(tmp_path / "encoder_fp32"))
    _write(port_model.build_decoder(cfg, new_len=1, seed=1), str(tmp_path / "decoder_fp32"))
    jp = JaxWhisper.from_dir(str(tmp_path), jax_model.WHISPER_TINY_TEST)
    pp = WhisperPipeline.from_dir(str(tmp_path), cfg, device=CPU)
    assert pp._decoder(1) is pp._decoder(4)
    mel = port_mel.log_mel_spectrogram(_audio("tone"), pad_to=2 * cfg.n_audio_ctx)
    want, got, ref = _run_encoder(jp, mel), _run_encoder(pp, mel), _run_encoder(synth, mel)
    for g, w, r in zip(got, want, ref):
        _close(g, w, 1e-4)
        np.testing.assert_array_equal(g, r)
    rng = np.random.RandomState(1)
    sk, sv = (rng.rand(*_zeros(cfg).shape).astype(np.float32) for _ in range(2))
    jl = _run_decoder(jp, [9], 3, sk, sv, *want)
    pl = _run_decoder(pp, [9], 3, sk, sv, *want)
    rl = _run_decoder(synth, [9], 3, sk, sv, *want)
    for g, w, r in zip(pl, jl, rl):
        _close(g, w, 1e-4)
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------------------------ from_hf
@pytest.fixture(scope="module")
def hf_trio():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=111, num_mel_bins=80, d_model=32,
        encoder_layers=2, encoder_attention_heads=2, max_source_positions=8,
        decoder_layers=2, decoder_attention_heads=2, max_target_positions=16,
        decoder_start_token_id=108, eos_token_id=107, pad_token_id=107,
    )
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    return hf, JaxWhisper.from_hf(hf), WhisperPipeline.from_hf(hf, device=CPU)


def test_from_hf_matches_jax_and_transformers(hf_trio):
    hf, jp, pp = hf_trio
    cfg = pp.cfg
    assert (cfg.sot, cfg.eot, cfg.n_vocab, cfg.n_audio_ctx) == (jp.cfg.sot, jp.cfg.eot, 111, 8)
    mel = np.random.RandomState(0).randn(1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32) * 0.5
    dec_ids = [cfg.sot, 5, 9, 42]
    with torch.no_grad():
        ref = hf(input_features=torch.tensor(mel), decoder_input_ids=torch.tensor([dec_ids])).logits[0].numpy()
    want, got = _run_encoder(jp, mel), _run_encoder(pp, mel)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    jl = _run_decoder(jp, dec_ids, 0, _zeros(cfg), _zeros(cfg), *want)[0]
    pl = _run_decoder(pp, dec_ids, 0, _zeros(cfg), _zeros(cfg), *got)[0]
    _close(pl, jl, 1e-4)
    np.testing.assert_allclose(pl[0], ref, rtol=1e-4, atol=1e-4)

"""Streamed runs on the card: the TINY UNet read from disk, double-buffered
on the copy stream, against the resident run, bit for bit.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there).
Every test carries the ``gpu`` marker and skips without a card. The CPU
schedule (fetch order, the double buffer, the providers) is tested in
tests/test_torch_streaming.py.
"""

import os

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the copy stream and pinned staging are CUDA's)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("provider", ["prefetch", "ram+prefetch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_tiny_unet_equals_resident_on_the_card(tmp_path, provider, dtype):
    dev = _card()
    build_unet(TINY, seed=1).save(str(tmp_path), float16=True)
    rng = np.random.default_rng(0)
    reqs = [{"sample": rng.standard_normal((1, 4, 16, 16), dtype=np.float32),
             "timestep": np.array([t], np.float32),
             "encoder_hidden_states": rng.standard_normal((1, 7, 32), dtype=np.float32)} for t in (999.0, 1.0)]
    outs = {}
    for budget in (0, 160 << 10):
        s = Session(SessionConfig(device=dev, compute_dtype=dtype, hbm_budget_bytes=budget),
                    weights_provider_name=provider)
        s.read_file(str(tmp_path / "model.txt"))
        for i, req in enumerate(reqs * 2):  # each request twice: the providers rewind
            for k, v in req.items():
                s.add_tensor(k, v)
            outs.setdefault(budget, []).append(s.run()["out_sample"])
        ex = s._executor()
        assert ex.streamed == (budget > 0) and (budget == 0 or len(ex.segments) > 4)
        assert (ex._copy_stream is not None) == (budget > 0)
        s.close()
    for got, want in zip(outs[160 << 10], outs[0]):
        assert np.isfinite(want).all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_streamed_weights_are_recorded_on_the_compute_stream(tmp_path, monkeypatch):
    """Every streamed weight, allocated on the copy stream, is record_stream-ed
    onto the compute stream (not the copy stream it was made on), so the
    allocator cannot hand its block to a later upload while a kernel reads it."""
    dev = _card()
    build_unet(TINY, seed=1).save(str(tmp_path), float16=True)
    s = Session(SessionConfig(device=dev, compute_dtype="bfloat16", hbm_budget_bytes=160 << 10),
                weights_provider_name="prefetch")
    s.read_file(str(tmp_path / "model.txt"))
    rng = np.random.default_rng(0)
    for k, shape in (("sample", (1, 4, 16, 16)), ("encoder_hidden_states", (1, 7, 32))):
        s.add_tensor(k, rng.standard_normal(shape, dtype=np.float32))
    s.add_tensor("timestep", np.array([500.0], np.float32))
    seen = []
    record = torch.Tensor.record_stream
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, stream: (seen.append(stream), record(t, stream))[1])
    s.run()
    ex = s._executor()
    compute = torch.cuda.current_stream(dev)
    n_weights = sum(len(seg.weight_args) for seg in ex.segments)
    assert len(seen) >= n_weights and all(st == compute for st in seen) and compute != ex._copy_stream
    s.close()

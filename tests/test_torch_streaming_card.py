"""Streamed and staged runs on the card: the TINY UNet read from disk,
double-buffered on the copy stream into two fixed weight slots, against the
resident run, bit for bit; from the second run on every segment replays a
CUDA graph of its own.

Each replay is held bit for bit to the same session run op by op
(``Executor.eager()``) and to the resident run; each segment's graph holds
the launches its capture recorded, and a run's replays add their sum to the
wrappers' counts. Pipeline stages on one card, a uint8 UNet under a budget
(kernel 5, its quantization vectors held by the graphs) and QDQ without
ranges on the TINY VAE replay the same way; a capture that fails in a later
segment names it and its op; segment k+1's copies wait for segment k-1's
end event, which guards the slot they fill.

This module imports neither JAX nor the JAX package, so it runs where only
PyTorch and a card are (``python -m pytest --noconftest -m gpu`` there).
Every test carries the ``gpu`` marker and skips without a card. The CPU
schedule (fetch order, the double buffer, the slots' offsets, the
providers) is tested in tests/test_torch_streaming.py.
"""

import re

import numpy as np
import pytest
import torch

from onnxstream_tpu_torch import Session, SessionConfig, kernels
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet
from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder
from onnxstream_tpu_torch.ops import _REGISTRY
from onnxstream_tpu_torch.runtime import executor as executor_mod
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

BUDGET = 160 << 10
FLASH_FAMILY = "flash_attention_packed+flash_attention"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the copy stream, pinned staging and CUDA graphs are CUDA's)")
    return torch.device("cuda")


def _requests() -> list:
    rng = np.random.default_rng(0)
    return [{"sample": rng.standard_normal((1, 4, 16, 16), dtype=np.float32),
             "timestep": np.array([t], np.float32),
             "encoder_hidden_states": rng.standard_normal((1, 7, 32), dtype=np.float32)} for t in (999.0, 1.0)]


def _push(s: Session, req: dict) -> None:
    for k, v in req.items():
        s.add_tensor(k, v)


def _launches_held(ex, before: dict) -> None:
    """A replayed run's wrapper counts advanced by the sum of its segments'
    graphs, as read from their kernel nodes."""
    after, total = kernels.launch_counts(), ex.graph_launches()
    per = [ex.graph_launches(si) for si in range(len(ex.segments))]
    assert total["kernel_nodes"] == sum(p["kernel_nodes"] for p in per) > 0
    for family, n in total.items():
        if family != "kernel_nodes":
            assert sum(after[k] - before[k] for k in family.split("+")) == n, family


def _replays_equal_eager_and(s: Session, reqs: list, want: list) -> None:
    """Each request twice (the providers rewind): the first run op by op,
    the second captures every segment's graph, later ones replay; each
    output bit for bit with ``want`` and with the same run inside eager()."""
    for i, req in enumerate(reqs * 2):
        _push(s, req)
        ex = s._executor()
        before = kernels.launch_counts()
        got = s.run()["out_sample" if "sample" in req else "image"]
        assert ex.captured == (i > 0)
        if i > 0:
            assert len(ex._replays) == len(ex.segments)
            _launches_held(ex, before)
        with ex.eager():
            eager = s.run()["out_sample" if "sample" in req else "image"]
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want[i % len(reqs)])
        np.testing.assert_array_equal(eager, got)


@pytest.mark.gpu
@pytest.mark.parametrize("provider", ["prefetch", "ram+prefetch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_tiny_unet_equals_resident_on_the_card(tmp_path, provider, dtype):
    dev = _card()
    build_unet(TINY, seed=1).save(str(tmp_path), float16=True)
    reqs = _requests()
    outs = {}
    for budget in (0, BUDGET):
        s = Session(SessionConfig(device=dev, compute_dtype=dtype, hbm_budget_bytes=budget),
                    weights_provider_name=provider)
        s.read_file(str(tmp_path / "model.txt"))
        if budget == 0:
            for req in reqs:
                _push(s, req)
                outs.setdefault(budget, []).append(s.run()["out_sample"])
        else:
            _replays_equal_eager_and(s, reqs, outs[0])
        ex = s._executor()
        assert ex.streamed == (budget > 0) and (budget == 0 or len(ex.segments) > 4)
        assert (ex._copy_stream is not None) == (budget > 0)
        if budget:
            mems = [ex.memory_analysis(si) for si in range(len(ex.segments))]
            assert all(m is not None and m["pool_bytes"] > 0 for m in mems)
            assert mems[0]["input_bytes"] > 0 and not any(m["input_bytes"] for m in mems[1:])
            acc = ex.hbm_accounting()
            assert acc["graph_bytes"] == max(m["pool_bytes"] for m in mems) + mems[0]["input_bytes"]
        s.close()
    assert all(np.isfinite(o).all() for o in outs[0])


@pytest.mark.gpu
def test_pipeline_stages_replay_a_graph_a_segment(tmp_path):
    """pp_devices=[cuda, cuda]: every segment's graph on its stage's device
    over its resident weights, bit for bit with the resident run."""
    dev = _card()
    build_unet(TINY, seed=1).save(str(tmp_path), float16=True)
    reqs = _requests()
    want = []
    s = Session(SessionConfig(device=dev, compute_dtype="bfloat16"), weights_provider_name="ram+prefetch")
    s.read_file(str(tmp_path / "model.txt"))
    for req in reqs:
        _push(s, req)
        want.append(s.run()["out_sample"])
    s = Session(SessionConfig(device=dev, compute_dtype="bfloat16", hbm_budget_bytes=BUDGET, pp_devices=[dev, dev]),
                weights_provider_name="ram+prefetch")
    s.read_file(str(tmp_path / "model.txt"))
    _replays_equal_eager_and(s, reqs, want)
    ex = s._executor()
    assert not ex.streamed and {ex.seg_stage(si) for si in range(len(ex.segments))} == {0, 1}
    assert all(not rep.hops for rep in ex._replays)  # one card: no activation changes device


@pytest.mark.gpu
def test_uint8_streamed_unet_replays_with_its_quantization_held(tmp_path):
    """The TINY UNet's 2-D weights quantized at each fetch to per-channel
    uint8 (kernel 5): the graphs hold the quantization vectors of their
    capture, and the replays stay bit for bit with the resident run, whose
    kernel-5 launches the streamed graphs hold too."""
    dev = _card()
    b = build_unet(TINY, seed=1)
    forced = {n for n, v in b.weights.items() if np.asarray(v).ndim == 2}
    cfg = dict(device=dev, compute_dtype="bfloat16", force_uint8_storage_set=forced, uint8_per_channel=True)
    reqs = _requests()
    want, launches = [], {}
    for budget in (0, BUDGET):
        s = Session(SessionConfig(hbm_budget_bytes=budget, **cfg),
                    weights_provider=DictWeightsProvider(params_from_numpy(b.weights)))
        s.read_string(b.to_text())
        if budget == 0:
            for req in reqs * 2:
                _push(s, req)
                want.append(s.run()["out_sample"])
        else:
            _replays_equal_eager_and(s, reqs, want)
        ex = s._executor()
        assert "w8_matmul" in ex.quant_routes.values()
        launches[budget] = ex.graph_launches()["w8_matmul"]
    assert launches[0] == launches[BUDGET] > 0


@pytest.mark.gpu
def test_qdq_without_ranges_replays_on_the_tiny_vae():
    """use_uint8_qdq with no calibrated range on the TINY VAE decoder: each
    range sorted on the card inside the graph, every replay bit for bit
    with the first (eager) run and with an eager run of the same input."""
    dev = _card()
    g = build_vae_decoder(VAE_TINY, seed=7)
    rng = np.random.default_rng(5)
    reqs = [{"latent": rng.standard_normal((1, 4, 8, 8), dtype=np.float32)} for _ in range(2)]
    want = []
    for replayed in (False, True):
        s = Session(SessionConfig(device=dev, use_uint8_qdq=True),
                    weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
        s.read_string(g.to_text())
        if replayed:
            _replays_equal_eager_and(s, reqs, want)
            continue
        for req in reqs:  # a session that only warms up: op by op
            _push(s, req)
            with s._executor().eager():
                want.append(s.run()["image"])


@pytest.mark.gpu
def test_a_failed_capture_names_the_segment_and_op(tmp_path, monkeypatch):
    """An op that waits for the card in a later segment of a streamed run:
    the capture raises, naming that segment and the op; nothing falls back,
    and with the op mended the next run captures every segment."""
    dev = _card()
    build_unet(TINY, seed=1).save(str(tmp_path), float16=True)
    s = Session(SessionConfig(device=dev, compute_dtype="bfloat16", hbm_budget_bytes=BUDGET),
                weights_provider_name="prefetch")
    s.read_file(str(tmp_path / "model.txt"))
    req = _requests()[0]
    _push(s, req)
    want = s.run()["out_sample"]
    ex = s._executor()
    seg_of = {oi: si for si, seg in enumerate(ex.segments) for oi in seg.op_indices}
    oi, victim = next((i, op) for i, op in enumerate(s.graph.ops)
                      if op.op_type == "Sigmoid" and seg_of.get(i, 0) > 1)
    impl = _REGISTRY["Sigmoid"]
    fn = impl.fn

    def syncing(ctx, op, ins):
        outs = fn(ctx, op, ins)
        if op.name == victim.name:
            outs[0].sum().item()  # the host waits for the value
        return outs

    monkeypatch.setattr(impl, "fn", syncing)
    want_msg = rf"capture of segment {seg_of[oi]} failed at op #{oi} Sigmoid \({re.escape(victim.name)}\)"
    with pytest.raises(RuntimeError, match=want_msg):
        s.run()
    assert not ex.captured
    monkeypatch.setattr(impl, "fn", fn)
    np.testing.assert_array_equal(s.run()["out_sample"], want)
    assert ex.captured and len(ex._replays) == len(ex.segments)
    np.testing.assert_array_equal(s.run()["out_sample"], want)


@pytest.mark.gpu
def test_streamed_weights_are_recorded_on_the_compute_stream(tmp_path, monkeypatch):
    """What guards the slots: before segment k+1's copies the copy stream
    waits for the end event recorded on the compute stream after segment
    k-1 (the last reader of that slot), in the eager run and in the replays;
    and no slot view is record_stream-ed (only quantization vectors made on
    the copy stream would be)."""
    dev = _card()
    build_unet(TINY, seed=1).save(str(tmp_path), float16=True)
    s = Session(SessionConfig(device=dev, compute_dtype="bfloat16", hbm_budget_bytes=BUDGET),
                weights_provider_name="prefetch")
    s.read_file(str(tmp_path / "model.txt"))
    _push(s, _requests()[0])
    ex = s._executor()
    log, recorded = [], []
    done, advance = executor_mod.Executor._segment_done, executor_mod._SegmentFetch.advance

    def spy_done(self_, si):
        done(self_, si)
        log.append(("done", si, self_._slot_done[si % 2]))

    def spy_advance(self_, n):
        if self_.done == 0 and n > 0:
            log.append(("fetch", self_.si, self_.ex._slot_done[self_.slot]))
        advance(self_, n)

    waits = []
    wait = torch.cuda.Stream.wait_event
    monkeypatch.setattr(executor_mod.Executor, "_segment_done", spy_done)
    monkeypatch.setattr(executor_mod._SegmentFetch, "advance", spy_advance)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", lambda st, ev: (waits.append((st, ev)), wait(st, ev))[1])
    record = torch.Tensor.record_stream
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, st: (recorded.append(t), record(t, st))[1])
    for _ in range(3):  # eager, capture, replay
        log.clear()
        s.run()
        ends = {si: ev for kind, si, ev in log if kind == "done"}
        fetches = [(si, ev) for kind, si, ev in log if kind == "fetch"]
        assert [si for si, _ in fetches] == [si for si, seg in enumerate(ex.segments) if seg.weight_args]
        assert len(fetches) == len(ex.segments) > 4
        for si, ev in fetches[2:]:
            assert ev is ends[si - 2]  # the event recorded after segment si - 2 = (k+1) - 2
            assert any(st == ex._copy_stream and e is ev for st, e in waits)
    assert ex.captured and not recorded
    s.close()

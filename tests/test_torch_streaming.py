"""Weight streaming in the port: the double-buffered segmented run, the
providers, and the names API, against the port's resident run and the JAX
package on the CPU.

The TINY UNet and LLAMA_TINY (prefill, 8 tokens) are written to a folder in
the reference's layout (model.txt and one .bin a weight) and read back from
disk by both Sessions. Outputs are held to the port's resident run bit for
bit, and to the JAX Session with the same ``hbm_budget_bytes`` within the
repo's bars (``tests/test_torch_session.py``): rtol = atol = 1e-4 in float32,
max|port - jax| <= 5e-2 * max|jax| in bfloat16. The streamed weights sit in
two fixed slots, at offsets the plan fixes, the same on every run.
"""

import os
import weakref

import numpy as np
import pytest
import torch

from onnxstream_tpu.dtypes import DType as JaxDType
from onnxstream_tpu.ops import registered_ops as jax_registered_ops
from onnxstream_tpu.runtime.config import SessionConfig as JaxConfig
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu.runtime.weights import CollectNamesWeightsProvider as JaxCollect
from onnxstream_tpu.runtime.weights import DiskPrefetchWeightsProvider as JaxPrefetch
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY, build_llama
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet
from onnxstream_tpu_torch.runtime import executor as executor_mod
from onnxstream_tpu_torch.runtime import native, weights
from onnxstream_tpu_torch.runtime.session import supported_ops
from onnxstream_tpu_torch.runtime.weights import (
    CollectNamesWeightsProvider,
    DiskPrefetchWeightsProvider,
    NativeDiskPrefetchWeightsProvider,
    RamWeightsProvider,
    make_provider,
)

CPU = torch.device("cpu")
# two budgets a model: a few segments, and many
BUDGETS = {"unet": (1 << 20, 160 << 10), "llama": (256 << 10, 64 << 10)}
PROVIDERS = ["nocache", "prefetch", "python_prefetch", "ram+prefetch"]


def _write(folder, builder) -> str:
    builder.save(folder)  # the port's builder gives the JAX builder's text and weights
    return os.path.join(folder, "model.txt")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    rng = np.random.default_rng(0)
    unet = build_unet(TINY, seed=1)
    llama = build_llama(LLAMA_TINY, new_len=8, seed=2)
    return {
        "unet": (_write(str(tmp_path_factory.mktemp("unet")), unet), {
            "sample": rng.standard_normal((1, 4, 16, 16), dtype=np.float32),
            "timestep": np.array([500.0], np.float32),
            "encoder_hidden_states": rng.standard_normal((1, 7, 32), dtype=np.float32)}),
        "llama": (_write(str(tmp_path_factory.mktemp("llama")), llama), {
            "input_5F_ids": rng.integers(0, 503, (1, 8)).astype(np.int64),
            "position_5F_ids": np.arange(8, dtype=np.int64)[None],
            "last_5F_pos": np.array([7], np.int64)}),
    }


def _provider(name: str, model_txt: str):
    prefix = os.path.dirname(model_txt) + os.sep
    if name == "python_prefetch":
        return DiskPrefetchWeightsProvider(prefix, max_bytes=64 << 10)
    return make_provider(name, prefix)


def _port(model_txt, inputs, provider="ram+prefetch", **cfg):
    s = Session(SessionConfig(device=CPU, **cfg), weights_provider=_provider(provider, model_txt))
    s.read_file(model_txt)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s


_JAX_OUT = {}


def _jax_out(models, model, budget, dtype):
    key = (model, budget, dtype)
    if key not in _JAX_OUT:
        model_txt, inputs = models[model]
        s = JaxSession(JaxConfig(compute_dtype=dtype, hbm_budget_bytes=budget), weights_provider_name="ram+prefetch")
        s.read_file(model_txt)
        for k, v in inputs.items():
            s.add_tensor(k, v)
        _JAX_OUT[key] = (s.run(), [seg.weight_bytes for seg in s._executor().segments])
    return _JAX_OUT[key]


def _held_to_jax(got, want, dtype):
    for name, w in want.items():
        if not np.issubdtype(np.asarray(w).dtype, np.floating):
            np.testing.assert_array_equal(got[name], w)
        elif dtype == "float32":
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4)
        else:
            assert float(np.abs(got[name] - w).max()) <= 5e-2 * float(np.abs(w).max()), name


@pytest.mark.parametrize("budget_index", [0, 1])
@pytest.mark.parametrize("provider", PROVIDERS)
@pytest.mark.parametrize("model", ["unet", "llama"])
def test_streamed_runs_equal_resident_and_jax(models, model, provider, budget_index):
    model_txt, inputs = models[model]
    budget = BUDGETS[model][budget_index]
    resident = _port(model_txt, inputs).run()
    s = _port(model_txt, inputs, provider, hbm_budget_bytes=budget)
    ex = s._executor()
    assert ex.streamed and len(ex.segments) >= (3 if budget_index == 0 else 6)
    for _ in range(3):  # the provider rewinds between runs
        out = s.run()
        assert set(out) == set(resident)
        for name in out:
            np.testing.assert_array_equal(out[name], resident[name])
    want, jax_seg_bytes = _jax_out(models, model, budget, "float32")
    _held_to_jax(out, want, "float32")
    # the same segments as the JAX executor, and their weight bytes
    acc = ex.hbm_accounting()
    assert acc["segment_weight_bytes"] == jax_seg_bytes
    assert acc["segments"] == len(jax_seg_bytes) and acc["weight_bytes"] == sum(jax_seg_bytes)
    s.close()


@pytest.mark.parametrize("model", ["unet", "llama"])
def test_ram_prefetch_converts_each_weight_once(models, model):
    """The converted weight goes back to the provider (JAX executor.py:
    531-537): under ram+prefetch a bfloat16 streamed session converts each
    float weight on the host in its first run and never again."""
    model_txt, inputs = models[model]
    budget = BUDGETS[model][1]
    s = _port(model_txt, inputs, "ram+prefetch", compute_dtype="bfloat16", hbm_budget_bytes=budget)
    ex = s._executor()
    floats = [w for w in ex.plan.arg_weights if w.file_dtype.is_float and w.transform is None]
    outs, counts = [], []
    for _ in range(3):
        outs.append(s.run())
        counts.append(ex.host_conversions)
    assert counts == [len(floats)] * 3 and len(floats) > 0
    for out in outs[1:]:
        for name in out:
            np.testing.assert_array_equal(out[name], outs[0][name])
    _held_to_jax(outs[0], _jax_out(models, model, budget, "bfloat16")[0], "bfloat16")
    # a provider that keeps no converted copy hands over the file's bytes,
    # converted on the device: no host conversion, the same bits
    s2 = _port(model_txt, inputs, "prefetch", compute_dtype="bfloat16", hbm_budget_bytes=budget)
    for _ in range(2):
        out = s2.run()
        for name in out:
            np.testing.assert_array_equal(out[name], outs[0][name])
    assert s2._executor().host_conversions == 0


@pytest.mark.parametrize("model", ["unet", "llama"])
def test_streamed_weights_sit_in_two_fixed_slots(models, model, monkeypatch):
    """A streamed run's weights are views of two slots allocated once, at
    the plan's offsets: each weight's data_ptr() is the same in runs 2 and
    3, segment si's in slot si % 2 (the segments alternate), no two weights
    of a segment overlap; the outputs stay bit for bit with the resident run
    and within the repo's bars of the JAX session."""
    model_txt, inputs = models[model]
    budget = BUDGETS[model][1]
    resident = _port(model_txt, inputs).run()
    s = _port(model_txt, inputs, "ram+prefetch", hbm_budget_bytes=budget)
    ex = s._executor()
    runs = []
    take = executor_mod._SegmentFetch.take

    def spy(self_):
        weights = take(self_)
        runs[-1].append((self_.si, {n: (t.data_ptr(), t.numel() * t.element_size()) for n, t in weights.items()}))
        return weights

    monkeypatch.setattr(executor_mod._SegmentFetch, "take", spy)
    for _ in range(3):
        runs.append([])
        out = s.run()
        for name in out:
            np.testing.assert_array_equal(out[name], resident[name])
    _held_to_jax(out, _jax_out(models, model, budget, "float32")[0], "float32")
    assert runs[1] == runs[2] and [si for si, _ in runs[1]] == list(range(len(ex.segments)))
    bases = [t.data_ptr() for t in ex._slots]
    assert len(ex.segments) >= 6 and bases[0] != bases[1]
    for si, ptrs in runs[1]:
        slot = ex._slots[si % 2]
        offsets = ex.slot_offsets[si]
        assert sorted(ptrs) == sorted(w.name for w in ex.segments[si].weight_args)
        assert all(ptr - bases[si % 2] == offsets[name] for name, (ptr, _) in ptrs.items())
        spans = sorted((offsets[name], offsets[name] + n) for name, (_, n) in ptrs.items())
        assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
        assert not spans or spans[-1][1] <= slot.numel()


class _Spy:
    """Records fetches and op dispatches of a streamed run, and which
    segments' weight tensors are alive at each op."""

    def __init__(self, monkeypatch, ex):
        self.events, self.alive_at_op, self.refs = [], [], []
        seg_of = {oi: si for si, seg in enumerate(ex.segments) for oi in seg.op_indices}
        fetch, eval_op = executor_mod._SegmentFetch._fetch, executor_mod.Executor._eval_op
        spy = self

        def _fetch(self_, w):
            dev = fetch(self_, w)
            spy.events.append(("fetch", self_.si, w.name))
            spy.refs.append((self_.si, weakref.ref(dev)))
            return dev

        def _eval_op(self_, oi, op, env, weights_env, device=None):
            spy.events.append(("op", seg_of[oi], oi))
            spy.alive_at_op.append({si for si, r in spy.refs if r() is not None})
            return eval_op(self_, oi, op, env, weights_env, device)

        monkeypatch.setattr(executor_mod._SegmentFetch, "_fetch", _fetch)
        monkeypatch.setattr(executor_mod.Executor, "_eval_op", _eval_op)


@pytest.mark.parametrize("provider", ["prefetch", "python_prefetch"])
@pytest.mark.parametrize("model", ["unet", "llama"])
def test_fetch_order_and_double_buffer(models, model, provider, monkeypatch):
    """Fetches follow stream_entries() (so the prefetcher serves in order),
    segment k+1's fetches all come before segment k's last op, and no more
    than two segments' weights are alive at any op."""
    model_txt, inputs = models[model]
    s = _port(model_txt, inputs, provider, hbm_budget_bytes=BUDGETS[model][1])
    ex = s._executor()
    spy = _Spy(monkeypatch, ex)
    s.run()
    fetched = [e[2] for e in spy.events if e[0] == "fetch"]
    assert fetched == [w.name for seg in ex.segments for w in seg.weight_args]
    first = list(dict.fromkeys(fetched))
    assert first == [e[0] for e in ex.plan.stream_entries()]
    for k in range(len(ex.segments) - 1):
        last_op_k = max(i for i, e in enumerate(spy.events) if e[0] == "op" and e[1] == k)
        fetches = [i for i, e in enumerate(spy.events) if e[0] == "fetch" and e[1] == k + 1]
        assert all(i < last_op_k for i in fetches) or len(ex.segments[k].op_indices) == 1
        first_op_k1 = min(i for i, e in enumerate(spy.events) if e[0] == "op" and e[1] == k + 1)
        assert all(i < first_op_k1 for i in fetches)
    assert max(len(a) for a in spy.alive_at_op) <= 2
    assert any(len(a) == 2 for a in spy.alive_at_op)  # the double buffer did overlap


@pytest.mark.parametrize("provider", ["ram+prefetch", "prefetch"])
def test_hbm_accounting_bound(models, provider):
    """The streamed bound is activations + segment k's and k+1's weights
    (+ the largest of k+1's converted on the device, in its file dtype, for a
    provider that keeps no converted copy); the resident one holds every
    weight."""
    model_txt, inputs = models["unet"]
    ex = _port(model_txt, inputs, provider, compute_dtype="bfloat16",
               hbm_budget_bytes=BUDGETS["unet"][1])._executor()
    acc = ex.hbm_accounting()
    wb, act = acc["segment_weight_bytes"], acc["segment_activation_bytes"]
    assert acc["mode"] == "streamed" and len(act) == len(wb) == acc["segments"]
    # float32 files, bf16 uploads: a weight converted on the device crosses at 2x its upload bytes
    conv = [max(2 * executor_mod.upload_bytes(w) for w in seg.weight_args) if provider == "prefetch" else 0
            for seg in ex.segments]
    assert acc["peak_bytes"] == max(a + w + n + c for a, w, n, c in zip(act, wb, wb[1:] + [0], conv[1:] + [0]))
    assert min(act) > 0 and acc["peak_bytes"] < acc["weight_bytes"]
    res = _port(model_txt, inputs)._executor().hbm_accounting()
    assert res["mode"] == "resident" and res["segments"] == 1
    assert res["peak_bytes"] == res["weight_bytes"] + res["segment_activation_bytes"][0]


def test_native_prefetcher_matches_jax_provider(tmp_path):
    arrays = {f"w{i}.bin": np.random.RandomState(i).rand(64 + i).astype(np.float32) for i in range(8)}
    arrays["h.bin"] = np.random.RandomState(9).rand(33).astype(np.float16)
    for n, a in arrays.items():
        a.tofile(str(tmp_path / n))
    entries = [(n, DType.float16 if a.dtype == np.float16 else DType.float32, a.shape) for n, a in arrays.items()]
    jentries = [(n, JaxDType(d.value), s) for n, d, s in entries]
    p = NativeDiskPrefetchWeightsProvider(str(tmp_path) + os.sep, max_bytes=256)
    j = JaxPrefetch(str(tmp_path) + os.sep, max_bytes=256)
    p.on_init(entries)
    j.on_init(jentries)
    for (n, d, s), (_, jd, _) in zip(entries, jentries):
        got = p.get(n, d, s)
        assert got.dtype == d.torch and tuple(got.shape) == s
        assert got.numpy().tobytes() == j.get(n, jd, s).tobytes()
    # restart, read into a caller's buffer, then out of order (direct read)
    p.on_restart()
    out = torch.empty(64, dtype=torch.float32)
    assert p.get_into("w0.bin", DType.float32, (64,), out) is out
    np.testing.assert_array_equal(out.numpy(), arrays["w0.bin"])
    np.testing.assert_array_equal(p.get("w5.bin", DType.float32, (69,)).numpy(), arrays["w5.bin"])
    with pytest.raises(ValueError):
        p.get_into("w1.bin", DType.float32, (65,), torch.empty(64))
    with pytest.raises(IOError):
        p.get("missing.bin", DType.float32, (4,))
    p.close()
    j.close()
    # a file missing from the announced order fails the reads after it
    q = NativeDiskPrefetchWeightsProvider(str(tmp_path) + os.sep)
    q.on_init([("gone.bin", DType.float32, (4,))])
    with pytest.raises(IOError):
        q.get("gone.bin", DType.float32, (4,))
    q.close()


def test_prefetch_is_native_and_a_failed_build_raises(tmp_path, monkeypatch):
    assert isinstance(make_provider("prefetch", str(tmp_path)), NativeDiskPrefetchWeightsProvider)
    ram = make_provider("ram+prefetch", str(tmp_path))
    assert isinstance(ram, RamWeightsProvider) and isinstance(ram.inner, NativeDiskPrefetchWeightsProvider)
    assert isinstance(make_provider("collect", ""), CollectNamesWeightsProvider)
    lib = native.prefetch_library()
    assert lib.parent.parent == native.CACHE_DIR and lib.name == "libostt_prefetch.so"
    # no fallback: a source that does not compile raises with g++'s error
    bad = tmp_path / "prefetch.cpp"
    bad.write_text("int ostpu_prefetch_new( {\n")
    monkeypatch.setattr(native, "PREFETCH_SOURCE", bad)
    monkeypatch.setattr(native, "CACHE_DIR", tmp_path / "cache")
    monkeypatch.setattr(weights, "_PREFETCH_LIB", [])
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for prefetch.cpp.*error:"):
        make_provider("prefetch", str(tmp_path))


def test_names_api_matches_jax(models):
    """collect's manifest, Session.get_weights_names and
    get_all_tensor_names give the JAX package's strings."""
    model_txt, inputs = models["unet"]
    s = _port(model_txt, inputs)
    j = JaxSession(JaxConfig(), weights_provider_name="ram+prefetch")
    j.read_file(model_txt)
    for k, v in inputs.items():
        j.add_tensor(k, v)
    assert s.get_weights_names() == j.get_weights_names() and s.get_weights_names().count("|") > 100
    entries = s._executor().plan.stream_entries()
    c, jc = CollectNamesWeightsProvider(), JaxCollect()
    c.on_init(entries)
    jc.on_init([(n, JaxDType(d.value), sh) for n, d, sh in entries])
    assert c.manifest() == jc.manifest()
    with pytest.raises(RuntimeError):
        c.get(entries[0][0], entries[0][1], entries[0][2])
    assert s.get_all_tensor_names() == j.get_all_tensor_names()
    s.run()
    j.run()
    assert s.get_all_tensor_names() == j.get_all_tensor_names() == ["out_sample", *inputs]


def test_supported_ops_differ_from_jax_only_by_the_pinned_set():
    ours, theirs = set(supported_ops()), set(jax_registered_ops())
    assert ours - theirs == {"ostpu.conv3x3_im2col"}
    # the layout pass's two op types are ported too: the JAX registry has no op the port lacks
    assert theirs - ours == set()

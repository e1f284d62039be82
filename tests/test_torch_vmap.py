"""The port's counterpart of ``jax.vmap``: the kernel wrappers' batching rules
and the executor's vmapped segment function, on the CPU.

  * each kernel wrapper under ``torch.func.vmap`` equals its plain twin on
    the stacked (folded) operands within 1e-6 in float32, and its
    implementation (``*_impl``, the launch on a card) is called once, at the
    folded batch: every operand mapped, an unmapped q beside mapped k / v
    (expanded as a stride-0 view), an unmapped mask (its broadcast strides
    kept), a mapped mask, a 2-D packed q, a channels-last qconv input; a
    mapped weight raises;
  * ``Executor.vmap_segment_fn`` raises and names an op that has no batching
    rule (functorch's per-example fallback is an error for its duration and
    is restored after); ``hbm_accounting(mapped=, size=)`` counts the mapped
    activations at the mapped size, and a vmapped call leaves the plain
    accounting as it was;
  * the TINY SD1.5 UNet vmapped over a (2, 1, 77, d) context pair (the
    latents and the timestep closed over) and the TINY tile decoder vmapped
    over 9 tiles equal per-example segment calls within 1e-5 in float32,
    under the default config, ``fuse_groupnorm``, config A (``fuse_gn_conv``
    + ``fuse_groupnorm``), config B (``use_pallas_smallconv`` +
    ``fuse_groupnorm``), ``use_nhwc_layout``, ``use_uint8_qdq`` (each
    example's ranges its own) and, for the decoder, the calibrated W8A8
    decoder.

The pipelines' two vmapped call sites are held to the JAX package's
``generate_on_device`` and ``_decode_tiled`` in tests/test_torch_sd_scan.py;
the kernels' batching rules on the card in the ``gpu`` tests of
tests/test_torch_*_card.py and in ``chip_smoke.py``.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch._C import _functorch as functorch

from onnxstream_tpu_torch import Session, SessionConfig, kernels
from onnxstream_tpu_torch.kernels import flash_attention as fa
from onnxstream_tpu_torch.kernels import gn_conv, gn_silu, matmul, qconv, qmatmul
from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline, qu8_decoder
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet
from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder
from onnxstream_tpu_torch.ops import _REGISTRY, OpImpl
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

CPU = torch.device("cpu")
TOL = 1e-6  # a wrapper under vmap against its twin on the folded operands, float32
SEGMENT_TOL = 1e-5  # a vmapped segment against per-example calls, float32
V = 3  # the map size of the wrapper cases


def _t(*shape, seed=0, dtype=np.float32):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape).astype(dtype))


def _u8(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8))


@pytest.fixture
def impl_calls(monkeypatch):
    """Spies on a module's ``*_impl``: the shapes of its first argument, one
    entry a call."""
    calls = []

    def spy(mod, name):
        impl = getattr(mod, name)

        def recorded(*a, **kw):
            calls.append(tuple(a[0].shape))
            return impl(*a, **kw)

        monkeypatch.setattr(mod, name, recorded)

    spy.calls = calls
    return spy


def _vmapped(fn, in_dims, *args):
    with kernels.no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*args)


@contextlib.contextmanager
def _batch_invariant():
    """The CPU's convolutions and products give each example the same bits
    at any batch: oneDNN off (its convolution rounds the last bit
    differently at batch 9 than at 1) and one thread (a product split over
    threads sums in another order at another batch). Under ``use_uint8_qdq``
    a percentile turns such a last bit into a quantization step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ------------------------------------------------------------------ kernels 1 and 2
# case -> (q, k, v shapes of one example, which of q / k / v are mapped)
PACKED_CASES = {
    "all_mapped": ((2, 24, 4 * 16), (2, 30, 2 * 16), (2, 30, 2 * 16), (0, 0, 0)),
    "q_unmapped": ((1, 24, 4 * 16), (1, 30, 4 * 16), (1, 30, 4 * 16), (None, 0, 0)),
    "packed_2d": ((24, 2 * 16), (30, 2 * 16), (30, 2 * 16), (0, 0, 0)),
    "nopad": ((1, 24, 2 * 40), (1, 30, 2 * 40), (1, 30, 2 * 40), (None, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_flash_attention_packed_under_vmap_is_one_folded_call(case, impl_calls):
    qs, ks, vs, dims = PACKED_CASES[case]
    heads = 4 if case == "q_unmapped" else 2
    ops = [_t(*((V,) + s if d is not None else s), seed=i) for i, (s, d) in enumerate(zip((qs, ks, vs), dims))]
    nopad = case == "nopad"
    impl_calls(fa, "flash_attention_packed_impl")
    got = _vmapped(lambda q, k, v: fa.flash_attention_packed(q, k, v, heads, causal=True, nopad=nopad), dims, *ops)
    lifted = [x if d is not None else x.expand(V, *x.shape) for x, d in zip(ops, dims)]
    if case == "packed_2d":
        want = fa.flash_attention_packed_reference(*lifted, heads, causal=True)
        folded = (V,) + qs
    else:
        want = fa.flash_attention_packed_reference(*(x.reshape(-1, *x.shape[2:]) for x in lifted), heads,
                                                   causal=True).reshape(V, *qs[:-1], -1)
        folded = (V * qs[0],) + qs[1:]
    _close(got, want)
    assert impl_calls.calls == [folded]


# case -> (q, k, v, mask shapes of one example, mapped dims of q, k, v, mask; GQA, k transposed)
HEAD_MAJOR_CASES = {
    "mask_unmapped": ((2, 4, 16, 8), (2, 4, 20, 8), (2, 4, 20, 8), (16, 20), (0, 0, 0, None)),
    "batch_mask_unmapped": ((2, 4, 16, 8), (2, 4, 20, 8), (2, 4, 20, 8), (2, 1, 16, 20), (0, 0, 0, None)),
    "mask_mapped": ((2, 4, 16, 8), (2, 2, 20, 8), (2, 2, 20, 8), (2, 16, 20), (0, 0, 0, 0)),
    "q_unmapped_kt": ((1, 4, 16, 8), (1, 4, 8, 20), (1, 4, 20, 8), (1, 1, 16, 20), (None, 0, 0, 0)),
    "rank3": ((4, 16, 8), (4, 20, 8), (4, 20, 8), None, (0, 0, 0, None)),
}


@pytest.mark.parametrize("case", sorted(HEAD_MAJOR_CASES))
def test_flash_attention_under_vmap_is_one_folded_call(case, impl_calls):
    qs, ks, vs, ms, dims = HEAD_MAJOR_CASES[case]
    kt = case == "q_unmapped_kt"
    shapes = (qs, ks, vs) + ((ms,) if ms else ())
    ops = [_t(*((V,) + s if d is not None else s), seed=i) for i, (s, d) in enumerate(zip(shapes, dims))]
    impl_calls(fa, "flash_attention_impl")
    if ms:
        fn = lambda q, k, v, m: fa.flash_attention(q, k, v, mask=m, k_transposed=kt, causal=True)  # noqa: E731
    else:
        fn = lambda q, k, v: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    got = _vmapped(fn, dims[:len(ops)], *ops)
    # the twin, one example at a time: what the folded call must equal
    ex = lambda x, d, i: x[i] if d is not None else x  # noqa: E731
    want = torch.stack([fa.flash_attention_reference(
        *(ex(x, d, i) for x, d in zip(ops[:3], dims)), mask=ex(ops[3], dims[3], i) if ms else None,
        k_transposed=kt, causal=True) for i in range(V)])
    _close(got, want)
    assert impl_calls.calls == [(V,) + qs if case == "rank3" else (V * qs[0],) + qs[1:]]


# ------------------------------------------------------------------ kernels 3 to 6
@pytest.mark.parametrize("case", ["w8a8_dyn_matmul", "w8a8_dyn_matmul_nk_vector", "w8_matmul", "qmatmul",
                                  "qmatmul_nk_u8_out"])
def test_row_kernels_under_vmap_fold_into_the_rows(case, impl_calls):
    a = _t(V, 2, 5, 32, seed=1)
    if case.startswith("w8a8_dyn_matmul"):
        nk = case.endswith("vector")
        w = torch.from_numpy(np.random.RandomState(2).randint(-127, 128, (16, 32) if nk else (32, 16))
                             .astype(np.int8))
        scale = torch.rand(16) if nk else 0.02
        impl_calls(qmatmul, "w8a8_dyn_matmul_impl")
        fn = lambda x: qmatmul.w8a8_dyn_matmul(x, w, scale, weight_nk=nk)  # noqa: E731
        twin = lambda x: qmatmul.w8a8_dyn_matmul_reference(x, w, scale, weight_nk=nk)  # noqa: E731
    elif case == "w8_matmul":
        w = _u8(32, 16, seed=2)
        impl_calls(qmatmul, "w8_matmul_impl")
        fn = lambda x: qmatmul.w8_matmul(x, w, 0.01, 128.0)  # noqa: E731
        twin = lambda x: qmatmul.w8_matmul_reference(x, w, 0.01, 128.0)  # noqa: E731
    else:
        a = _u8(V, 2, 5, 32, seed=1)
        nk = case.endswith("u8_out")
        w = _u8(16, 32, seed=2) if nk else _u8(32, 16, seed=2)
        kw = dict(out_scale=0.5, out_zero=7, weight_nk=True) if nk else dict(bias=np.arange(16) * 3.0)
        impl_calls(qmatmul, "qmatmul_impl")
        fn = lambda x: qmatmul.qmatmul(x, w, 0.02, 120, 0.01, 131, **kw)  # noqa: E731
        twin = lambda x: qmatmul.qmatmul_reference(x, w, 0.02, 120, 0.01, 131, **kw)  # noqa: E731
    got = _vmapped(fn, 0, a)
    _close(got, twin(a.reshape(-1, 32)).reshape(*a.shape[:-1], -1))
    assert impl_calls.calls == [tuple(a.shape)]  # the mapped axis leads A's rows


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_qconv_under_vmap_folds_into_n(channels_last, impl_calls):
    x = _t(V, 2, 16, 6, 7, seed=3)
    w = _u8(8, 16, 3, 3, seed=4)
    if channels_last:
        w = w.contiguous(memory_format=torch.channels_last)
    seen = []
    impl = qconv.qconv_impl

    def spy(x_q, *a, **kw):
        seen.append(x_q.is_contiguous(memory_format=torch.channels_last))
        return impl(x_q, *a, **kw)

    qconv.qconv_impl, saved = spy, impl
    try:
        got = _vmapped(lambda xe: qconv.qconv(qmatmul.quantize_activation(xe, 0.05, 128, channels_last), w, 0.05,
                                              128, 0.01, 120, bias=np.ones(8), pads=(1, 1, 1, 1)), 0, x)
    finally:
        qconv.qconv_impl = saved
    xq = qmatmul.quantize_activation(x.reshape(-1, 16, 6, 7), 0.05, 128)
    want = qconv.qconv_reference(xq, w, 0.05, 128, 0.01, 120, bias=np.ones(8), pads=(1, 1, 1, 1))
    _close(got, want.reshape(V, 2, 8, 6, 7))
    # one call at N = V x 2, the quantized input channels-last per example and after the fold
    assert seen == [channels_last]


def test_quantize_activation_keeps_its_bits_and_layout_under_vmap():
    x = _t(V, 2, 16, 4, 5, seed=5).to(torch.bfloat16)
    for cl in (False, True):
        got = _vmapped(lambda xe: qmatmul.quantize_activation(xe, 0.03, 100, cl), 0, x)
        want = qmatmul.quantize_activation(x.reshape(-1, 16, 4, 5), 0.03, 100, cl)
        assert torch.equal(got.reshape(-1, 16, 4, 5), want)
        assert want.is_contiguous(memory_format=torch.channels_last if cl else torch.contiguous_format)


def test_a_mapped_weight_raises_under_vmap():
    a, w = _t(4, 32), _u8(V, 32, 16)
    with pytest.raises(ValueError, match="closed over"):
        _vmapped(lambda we: qmatmul.w8_matmul(a, we, 0.01, 3.0), 0, w)
    with pytest.raises(ValueError, match="closed over"):
        _vmapped(lambda b: matmul.matmul(a, b), 0, _t(V, 32, 16))


# ------------------------------------------------------------------ kernels 7 to 9
@pytest.mark.parametrize("case", ["gn_silu", "gn_silu_conv", "matmul", "conv3x3_im2col"])
def test_nhwc_and_row_kernels_under_vmap_fold_into_the_batch(case, impl_calls):
    if case in ("gn_silu", "gn_silu_conv"):
        x = _t(V, 2, 32, 5, 6, seed=6)
        sg, sb, gamma, beta = _t(8, seed=7), _t(8, seed=8), _t(32, seed=9), _t(32, seed=10)
        if case == "gn_silu":
            impl_calls(gn_silu, "gn_silu_impl")
            fn = lambda xe: gn_silu.gn_silu(xe, sg, sb, gamma, beta, 8, 1e-5, True)  # noqa: E731
            twin = lambda xf: gn_silu.gn_silu_reference(xf, sg, sb, gamma, beta, 8, 1e-5, True)  # noqa: E731
        else:
            w9, bias = _t(9, 12, 32, seed=11), _t(12, seed=12)
            impl_calls(gn_conv, "gn_silu_conv_impl")
            fn = lambda xe: gn_conv.gn_silu_conv(xe, sg, sb, gamma, beta, w9, bias, groups=8, eps=1e-5)  # noqa: E731
            twin = lambda xf: gn_conv.gn_silu_conv_reference(xf, sg, sb, gamma, beta, w9, bias, 8, 1e-5)  # noqa: E731
    elif case == "matmul":
        x, b, bias = _t(V, 40, 64, seed=13), _t(64, 24, seed=14), _t(24, seed=15)
        impl_calls(matmul, "matmul_impl")
        fn = lambda xe: matmul.matmul(xe, b, bias)  # noqa: E731
        twin = lambda xf: matmul.matmul_reference(xf, b, bias)  # noqa: E731
    else:
        x, w9co, bias = _t(V, 2, 5, 6, 16, seed=16), _t(9 * 16, 24, seed=17), _t(24, seed=18)
        impl_calls(matmul, "conv3x3_im2col_impl")
        fn = lambda xe: matmul.conv3x3_im2col(xe, w9co, bias)  # noqa: E731
        twin = lambda xf: matmul.matmul_reference(  # the im2col of the folded batch, one product
            torch.cat([torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))[:, i:i + 5, j:j + 6].reshape(-1, 16)
                       for i in range(3) for j in range(3)], dim=1), w9co, bias).reshape(*xf.shape[:3], 24)
    got = _vmapped(fn, 0, x)
    folded = x.reshape(-1, *x.shape[2:])
    want = twin(folded)
    _close(got, want.reshape(V, -1, *want.shape[1:]), tol=TOL if case != "gn_silu_conv" else 1e-5)
    assert impl_calls.calls[:1] == [tuple(folded.shape)] and len(impl_calls.calls) == 1


# ------------------------------------------------------------------ the executor
@pytest.fixture(scope="module")
def port():
    return StableDiffusionPipeline.from_synthetic(tiny=True, device=CPU)


def _tile_decoder(port):
    """The TINY tile decoder's builder: from_synthetic's graph and weights."""
    return build_vae_decoder(dataclasses.replace(VAE_TINY, sample=port._tile_size), seed=2)


def _session(builder, **config) -> Session:
    s = Session(SessionConfig(device=CPU, fuse_ops_in_attention=True, **config),
                weights_provider=DictWeightsProvider(params_from_numpy(builder.weights)))
    s.read_string(builder.to_text())
    return s


def _decoder_session(port, **config) -> Session:
    """The TINY tile decoder in a session of its own under ``config``."""
    return _session(_tile_decoder(port), **config)


def _executor(sess: Session, inputs: dict):
    sess.clear_tensors()
    for k, v in inputs.items():
        sess.add_tensor(k, v)
    ex = sess._executor()
    resident = ex._fetch_segment_weights(ex.segments[0], 0)
    return ex, [resident[w.name] for w in ex.segments[0].weight_args]


def test_an_op_without_a_batching_rule_raises_and_names_itself(port, monkeypatch):
    """A Conv followed by an in-place clamp_ (which has no batching rule):
    the vmapped segment raises with the op's name, and functorch's fallback
    setting is what it was before, after the error too."""
    conv = _REGISTRY["Conv"]

    def clamped(ctx, op, ins):
        return [y.clamp_(-1e30, 1e30) for y in conv.fn(ctx, op, ins)]

    sess = _decoder_session(port)
    name = next(iter(sess.graph.inputs))
    tiles = _t(9, 1, 4, 8, 8, seed=20)
    ex, weights = _executor(sess, {name: tiles[0]})
    monkeypatch.setitem(_REGISTRY, "Conv", OpImpl(fn=clamped, host=conv.host, internal=conv.internal))
    for before in (True, False):
        torch._C._functorch._set_vmap_fallback_enabled(before)
        try:
            with pytest.raises(RuntimeError, match="clamp_.*vmap fallback"):
                ex.vmap_segment_fn({name: 0})(weights, {name: tiles})
            assert torch._C._functorch._is_vmap_fallback_enabled() is before
        finally:
            torch._C._functorch._set_vmap_fallback_enabled(True)


def test_vmap_segment_fn_refuses_an_unknown_or_empty_map(port):
    sess = _decoder_session(port)
    name = next(iter(sess.graph.inputs))
    ex, _ = _executor(sess, {name: _t(1, 4, 8, 8)})
    for in_dims in ({"nothing": 0}, {name: None}):
        with pytest.raises(ValueError, match="maps inputs of its own"):
            ex.vmap_segment_fn(in_dims)


CONFIGS = {
    "default": {},
    "fuse_groupnorm": {"fuse_groupnorm": True},
    "config_a": {"fuse_gn_conv": True, "fuse_groupnorm": True},
    "config_b": {"use_pallas_smallconv": True, "fuse_groupnorm": True},
    "nhwc": {"use_nhwc_layout": True},
    "uint8_qdq": {"use_uint8_qdq": True},
}


@contextlib.contextmanager
def _per_example_ranges(ex):
    """Holds every QDQ of a vmapped call to the rule on each example alone:
    the QDQ'd tensor's slice i is ``_maybe_qdq`` of the example's own
    values, bit for bit (its percentiles its own, as under JAX's vmap).
    Yields the names checked."""
    checked = []
    qdq = ex._maybe_qdq

    def held(op, outs):
        res = qdq(op, outs)
        for spec, o, r in zip(op.outputs, outs, res):
            if r is o or not functorch.is_batchedtensor(o):
                continue
            po, pr = functorch.get_unwrapped(o), functorch.get_unwrapped(r)
            do, dr = functorch.maybe_get_bdim(o), functorch.maybe_get_bdim(r)
            for i in range(po.shape[do]):
                fake = types.SimpleNamespace(outputs=[spec], op_type=op.op_type, name=op.name)
                assert torch.equal(pr.select(dr, i), qdq(fake, [po.select(do, i)])[0]), spec.name
            checked.append(spec.name)
        return res

    ex._maybe_qdq = held
    try:
        yield checked
    finally:
        del ex._maybe_qdq


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_unet_vmapped_over_the_context_pair_equals_per_example_calls(port, config):
    """The loop's UNet at batch 1, its segment function vmapped over the
    stacked cond / uncond contexts with the latents and the timestep closed
    over, as generate_on_device's step calls it. Under ``use_uint8_qdq``
    every QDQ is also held to the rule on each example alone, bit for bit,
    and the products and convolutions are made batch-invariant
    (``_batch_invariant``)."""
    s = _session(build_unet(TINY, seed=1), **CONFIGS[config])  # from_synthetic's UNet
    names = port._unet_input_names()
    ctx = _t(2, 1, port._clip_seq, port.context_dim, seed=21)
    acts = {names["sample"]: _t(1, 4, port.lath, port.latw, seed=22), names["timestep"]: torch.tensor([500.0])}
    ex, weights = _executor(s, {**acts, names["context"]: ctx[0]})
    before = ex.hbm_accounting()
    qdq = config == "uint8_qdq"
    with _batch_invariant() if qdq else contextlib.nullcontext():
        with _per_example_ranges(ex) if qdq else contextlib.nullcontext([]) as checked:
            got = ex.vmap_segment_fn({names["context"]: 0})(weights, {**acts, names["context"]: ctx})
        assert (len(checked) > 20) == qdq
        fn = ex.segment_fn(0)
        for out_name, out in got.items():
            want = torch.stack([fn(weights, {**acts, names["context"]: ctx[i]})[out_name] for i in range(2)])
            _close(out, want, SEGMENT_TOL)
    assert ex.hbm_accounting() == before
    mapped = ex.hbm_accounting(mapped=[names["context"]], size=2)
    assert before["segment_activation_bytes"][0] < mapped["segment_activation_bytes"][0]
    assert mapped["segment_activation_bytes"][0] < 2 * before["segment_activation_bytes"][0]


@pytest.mark.parametrize("config", sorted(CONFIGS) + ["w8a8"])
def test_tile_decoder_vmapped_over_nine_tiles_equals_per_example_calls(port, config):
    """The tile decoder vmapped over a stack of 9 tiles, as the tiled
    decode calls it; ``w8a8``: the calibrated W8A8 decoder (kernels 3 and 4
    under the vmap, ranges calibrated on the tiles). Under ``use_uint8_qdq``
    every QDQ is also held to the rule on each example alone, bit for bit,
    and the products and convolutions are made batch-invariant
    (``_batch_invariant``)."""
    tiles = _t(9, 1, 4, port._tile_size, port._tile_size, seed=23)
    if config == "w8a8":
        cal = _decoder_session(port, range_data_calibrate=True)
        name = next(iter(cal.graph.inputs))
        for tile in tiles:
            cal.clear_tensors()
            cal.add_tensor(name, tile)
            cal.run()
        g = _tile_decoder(port)
        sess = qu8_decoder(g.to_text(), g.weights, cal._executor().range_data.data, device=CPU)
    else:
        sess = _decoder_session(port, **CONFIGS[config])
    name = next(iter(sess.graph.inputs))
    ex, weights = _executor(sess, {name: tiles[0]})
    qdq = config == "uint8_qdq"
    with _batch_invariant() if qdq else contextlib.nullcontext():
        with _per_example_ranges(ex) if qdq else contextlib.nullcontext([]) as checked:
            got = ex.vmap_segment_fn({name: 0})(weights, {name: tiles})
        assert (len(checked) > 10) == qdq
        fn = ex.segment_fn(0)
        for out_name, out in got.items():
            want = torch.stack([fn(weights, {name: tile})[out_name] for tile in tiles])
            _close(out, want, SEGMENT_TOL)
    if config == "w8a8":
        assert {"qconv", "qmatmul"} <= set(ex.quant_routes.values())

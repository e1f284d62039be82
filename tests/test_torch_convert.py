"""The port's ONNX converter (convert/onnx2txt.py, convert/onnxproto.py,
cli/onnx2txt_main.py) against the JAX package's.

Every case of tests/test_convert.py, with one more bar: for the same ONNX
bytes the port writes a model.txt and .bin files byte-identical to the JAX
converter's, and each converted graph runs through both Sessions on the CPU
to float32 rtol = atol = 1e-4. The width-0.1 real-architecture SD1.5 UNet
(tools/torch_sd_unet.py through torch.onnx.export) carries ``slow`` as
tests/test_fullsize_convert.py does.
"""

import os
import sys

import numpy as np
import pytest
import torch

from onnxstream_tpu.convert import onnx2txt as jax_onnx2txt
from onnxstream_tpu.convert import onnxproto as jax_proto
from onnxstream_tpu.runtime.session import Session as JaxSession
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.convert.onnx2txt import convert, mangle_name, quantize_uint8
from onnxstream_tpu_torch.convert.onnxproto import TP_INT64, encode_model, encode_node, load_onnx

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, folder)] = open(p, "rb").read()
    return out


def _both(data, tmp_path, tag="m", **kw):
    """Convert with both packages; every written file must be byte-identical.
    Returns (model.txt text, the port's folder)."""
    ours, theirs = str(tmp_path / f"{tag}_port"), str(tmp_path / f"{tag}_jax")
    text = convert(data, ours, **kw)
    assert text == jax_onnx2txt.convert(data, theirs, **kw)
    a, b = _files(ours), _files(theirs)
    assert sorted(a) == sorted(b) and "model.txt" in a
    for name in a:
        assert a[name] == b[name], name
    return text, ours


def _run_both(folder, inputs):
    """The converted folder through the port's Session (CPU) and the JAX
    Session, float32, within rtol = atol = 1e-4; returns the port's outputs."""
    ps = Session(SessionConfig(device=CPU), weights_provider_name="nocache")
    js = JaxSession(weights_provider_name="nocache")
    for s in (ps, js):
        s.read_file(os.path.join(folder, "model.txt"))
        for k, v in inputs.items():
            s.add_tensor(k, v)
    got, want = ps.run(), js.run()
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-4)
    return got


def _simple_model():
    """x (1,2,3) -> Mul w -> Add b -> y ; weights as initializers."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    b = np.array([0.5, 1.5, 2.5], np.float32)
    nodes = [
        encode_node("Mul", ["x", "w"], ["t0"], name="mul_0"),
        encode_node("Add", ["t0", "b"], ["y"], name="add_0"),
    ]
    data = encode_model(nodes, inputs=[("x", (1, 2, 3))], outputs=[("y", (1, 2, 3))],
                        initializers={"w": w, "b": b})
    return data, w, b


def test_proto_roundtrip():
    data, w, b = _simple_model()
    # the port's writer and reader are the JAX package's, byte for byte
    jnodes = [jax_proto.encode_node("Mul", ["x", "w"], ["t0"], name="mul_0"),
              jax_proto.encode_node("Add", ["t0", "b"], ["y"], name="add_0")]
    assert data == jax_proto.encode_model(jnodes, inputs=[("x", (1, 2, 3))], outputs=[("y", (1, 2, 3))],
                                          initializers={"w": w, "b": b})
    g = load_onnx(data)
    assert [n.op_type for n in g.nodes] == ["Mul", "Add"]
    assert g.nodes[0].inputs == ["x", "w"]
    np.testing.assert_array_equal(g.initializers["w"].data, w)
    np.testing.assert_array_equal(g.initializers["b"].data, b)
    assert g.inputs[0].name == "x" and g.inputs[0].dims == (1, 2, 3)


def test_mangle_name_matches_reference():
    # reference src/bindings.py:310-317 / notebook get_final_name
    assert mangle_name("a.b/c") == "a_2E_b_2F_c" == jax_onnx2txt.mangle_name("a.b/c")
    assert mangle_name("input_ids") == "input_5F_ids"
    assert mangle_name("plain123") == "plain123"


def test_convert_and_run(tmp_path):
    data, w, b = _simple_model()
    text, out = _both(data, tmp_path)
    assert "mul_5F_0:Mul" in text
    assert "w.bin(float32:2,3)" in text
    x = np.random.RandomState(0).rand(1, 2, 3).astype(np.float32)
    res = _run_both(out, {"x": x})
    np.testing.assert_allclose(res["y"], x * w + b, rtol=1e-5)


def test_convert_constant_inlining(tmp_path):
    c = np.array([2.0], np.float32)
    nodes = [
        encode_node("Constant", [], ["cst"], name="const_0", value=c),
        encode_node("Mul", ["x", "cst"], ["y"], name="mul_0"),
    ]
    data = encode_model(nodes, inputs=[("x", (2, 2))], outputs=[("y", (2, 2))], initializers={})
    text, out = _both(data, tmp_path)
    assert "Constant" not in text
    assert "cst.bin(float32:1)" in text
    _run_both(out, {"x": np.random.RandomState(1).rand(2, 2).astype(np.float32)})


def test_convert_gemm_transpose_fold(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    nodes = [encode_node("Gemm", ["x", "w"], ["y"], name="gemm_0", transB=1, alpha=1.0, beta=1.0)]
    data = encode_model(nodes, inputs=[("x", (2, 3))], outputs=[("y", (2, 4))], initializers={"w": w})
    text, out = _both(data, tmp_path)
    assert "w_transposed.bin(float32:3,4)" in text
    assert "transB" not in text
    saved = np.fromfile(out + "/w_transposed.bin", np.float32).reshape(3, 4)
    np.testing.assert_array_equal(saved, w.T)
    _run_both(out, {"x": np.random.RandomState(2).rand(2, 3).astype(np.float32)})


def test_convert_conv_dual_layout(tmp_path):
    w = np.random.RandomState(0).rand(4, 3, 3, 3).astype(np.float32)
    bias = np.zeros(4, np.float32)
    nodes = [encode_node("Conv", ["x", "w", "bias"], ["y"], name="conv_0",
                         kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1],
                         dilations=[1, 1], group=1)]
    data = encode_model(nodes, inputs=[("x", (1, 3, 8, 8))], outputs=[("y", (1, 4, 8, 8))],
                        initializers={"w": w, "bias": bias})
    text, out = _both(data, tmp_path)
    assert "w_nchw.bin(float32:4,3,3,3)" in text
    nhwc = np.fromfile(out + "/w_nhwc.bin", np.float32).reshape(4, 3, 3, 3)
    np.testing.assert_array_equal(nhwc, w.transpose(0, 2, 3, 1))
    _run_both(out, {"x": np.random.RandomState(3).rand(1, 3, 8, 8).astype(np.float32)})


def test_convert_fp16(tmp_path):
    data, w, b = _simple_model()
    text, out = _both(data, tmp_path, fp16=True)
    assert "w.bin(float16:2,3)" in text
    saved = np.fromfile(out + "/w.bin", np.float16)
    np.testing.assert_array_equal(saved, w.astype(np.float16).reshape(-1))
    _run_both(out, {"x": np.random.RandomState(4).rand(1, 2, 3).astype(np.float32)})


def test_convert_quantize(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(16, 16).astype(np.float32)
    nodes = [encode_node("MatMul", ["x", "w"], ["y"], name="mm_0")]
    data = encode_model(nodes, inputs=[("x", (1, 16))], outputs=[("y", (1, 16))],
                        initializers={"w": w})
    text, out = _both(data, tmp_path, quantize=True)
    assert "uint8[" in text
    _run_both(out, {"x": rng.rand(1, 16).astype(np.float32)})

    # quantize math: the JAX package's, and the dequantized values approximate the original
    q = quantize_uint8(w)
    jq = jax_onnx2txt.quantize_uint8(w)
    assert q is not None and q[1:] == jq[1:] and np.array_equal(q[0], jq[0])
    qa, scale, zero = q
    deq = (qa.astype(np.float32) - zero) * scale
    assert np.abs(deq - np.clip(w, (0 - zero) * scale, (255 - zero) * scale)).max() < scale


def test_convert_shape_inference_via_ops(tmp_path):
    # no value_info in the file: shapes must come from the port's op impls
    w = np.random.RandomState(1).rand(3, 5).astype(np.float32)
    nodes = [
        encode_node("MatMul", ["x", "w"], ["t0"], name="mm_0"),
        encode_node("Sigmoid", ["t0"], ["y"], name="sig_0"),
    ]
    data = encode_model(nodes, inputs=[("x", (2, 3))], outputs=[("y", (2, 5))], initializers={"w": w})
    text, out = _both(data, tmp_path)
    assert "t0(2,5)" in text and "y(2,5)" in text
    _run_both(out, {"x": np.random.RandomState(5).rand(2, 3).astype(np.float32)})


def test_convert_int64_shape_math(tmp_path):
    # Reshape with an int64 initializer folds through the static path
    shape = np.array([4, 2], np.int64)
    nodes = [encode_node("Reshape", ["x", "shp"], ["y"], name="r_0")]
    data = encode_model(nodes, inputs=[("x", (2, 4))], outputs=[("y", (4, 2))],
                        initializers={"shp": shape})
    text, out = _both(data, tmp_path)
    assert "y(4,2)" in text
    assert "shp.bin(int64:2)" in text
    _run_both(out, {"x": np.random.RandomState(6).rand(2, 4).astype(np.float32)})


def test_cli(tmp_path, capsys):
    from onnxstream_tpu.cli.onnx2txt_main import main as jax_main
    from onnxstream_tpu_torch.cli.onnx2txt_main import main

    data, _, _ = _simple_model()
    src = tmp_path / "m.onnx"
    src.write_bytes(data)
    args = ["--fp16", "--input-shape", "x=1,2,3"]
    assert main([str(src), str(tmp_path / "out")] + args) == 0
    said = capsys.readouterr().out
    assert "2 ops" in said
    assert jax_main([str(src), str(tmp_path / "jax_out")] + args) == 0
    assert said.replace("/out/", "/jax_out/") == capsys.readouterr().out
    assert _files(str(tmp_path / "out")) == _files(str(tmp_path / "jax_out"))


def test_convert_dynamic_dim_errors_and_override(tmp_path):
    w = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    nodes = [encode_node("MatMul", ["x", "w"], ["y"], name="mm_0")]
    # dim 0 encodes an unknown batch (the writer has no dim_param, 0 == unknown)
    data = encode_model(nodes, inputs=[("x", (0, 3))], outputs=[("y", (0, 5))],
                        initializers={"w": w})
    with pytest.raises(ValueError, match="dynamic/unknown dims"):
        convert(data, str(tmp_path / "m1"))
    text, out = _both(data, tmp_path, tag="m2", input_shapes={"x": (2, 3)})
    assert "y(2,5)" in text
    _run_both(out, {"x": np.random.RandomState(7).rand(2, 3).astype(np.float32)})


def test_shared_weight_divergent_transforms_fork_files(tmp_path):
    """A weight consumed with different transforms must not overwrite one
    .bin with conflicting contents: quantize turns an eligible consumer's ref
    uint8 while an excluded consumer (Conv bias, input 2) keeps fp32; the two
    refs point at different files, each with its own bytes."""
    s = np.arange(3, dtype=np.float32) + 0.25
    k = (np.arange(9, dtype=np.float32).reshape(3, 3, 1, 1) / 10.0)
    nodes = [
        encode_node("Mul", ["x2", "s"], ["m0"], name="m"),
        encode_node("Conv", ["x", "k", "s"], ["z"], name="c", kernel_shape=[1, 1]),
    ]
    data = encode_model(
        nodes, inputs=[("x", (1, 3, 4, 4)), ("x2", (2, 3))],
        outputs=[("z", (1, 3, 4, 4)), ("m0", (2, 3))],
        initializers={"s": s, "k": k})
    txt, d = _both(data, tmp_path, quantize=True)
    refs = [tok for line in txt.splitlines()
            for tok in line.split("*")[1].split(";") if ".bin" in tok]
    by_file = {}
    for r in refs:
        fn, spec = r.split("(", 1)
        by_file.setdefault(fn, set()).add(spec.split(":")[0])
        assert os.path.exists(os.path.join(d, fn)), fn
    for fn, dtypes in by_file.items():
        assert len(dtypes) == 1, (fn, dtypes)
    s_files = [fn for fn in by_file if fn.startswith("s")]
    assert len(s_files) == 2, (s_files, by_file)
    rng = np.random.RandomState(8)
    _run_both(d, {"x": rng.rand(1, 3, 4, 4).astype(np.float32), "x2": rng.rand(2, 3).astype(np.float32)})


def test_int64_input_feeding_a_mul_weight(tmp_path):
    """An int64 graph input times an int64 weight: both converters infer
    the device dtype the same way (32-bit device integers), so the weight
    gets the notebook's float32 cast in both."""
    w = np.array([2, 3], np.int64)
    nodes = [encode_node("Mul", ["ids", "w"], ["y"], name="mul_0")]
    data = encode_model(nodes, inputs=[("ids", (1, 2))], outputs=[("y", (1, 2))],
                        initializers={"w": w}, input_types={"ids": TP_INT64})
    text, _ = _both(data, tmp_path)
    assert "w.bin(" in text


@pytest.mark.slow
def test_fullarch_unet_converted_forward_matches_jax_and_torch(tmp_path):
    """tools/torch_sd_unet.py SDUNet at width 0.1 through torch.onnx.export:
    both converters write the same files, and the port's Session matches the
    torch module within 2e-3 * max (the JAX test's bar) and the JAX
    Session within 1e-4 * max."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from torch_sd_unet import SDUNet, export_onnx

    torch.manual_seed(0)
    model = SDUNet(width=0.1).eval()
    lat, ctx_len = 16, 12
    _, out_dir = _both(export_onnx(model, lat=lat, ctx_len=ctx_len), tmp_path)
    rng = np.random.RandomState(1)
    inputs = {mangle_name("sample"): rng.randn(1, 4, lat, lat).astype(np.float32),
              mangle_name("timestep"): np.array([500.0], np.float32),
              mangle_name("encoder_hidden_states"): rng.randn(1, ctx_len, 768).astype(np.float32)}
    ours = _run_both(out_dir, inputs)[mangle_name("out_sample")]
    with torch.no_grad():
        ref = model(*(torch.tensor(v) for v in inputs.values())).numpy()
    assert np.abs(ours - ref).max() < 2e-3 * max(1.0, np.abs(ref).max())

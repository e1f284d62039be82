"""The port's in-tab interpreter (onnxstream_tpu_torch/api/interp.js) under
the port's minijs.

* the conv net, tensor-op and full-op-switch graphs of
  tests/torch_js_fetch.py: bit for bit with the JAX package's interp.js
  under the JAX package's minijs, and within 2e-4 of the port's float32
  Session on the CPU;
* every op body hashed to tests/test_interp_twins.py's JS_TWIN_HASHES, so
  the numpy twins there cover the port's copy too;
* the structural checks of tests/test_interp_js.py on the port's files;
* examples/yolo_browser/offline.html's script over the port's interp.js:
  its nms() held to the port's non_max_suppression, its runFrame() contract
  held to the port's Session.
"""

import functools
import inspect
import os
import re

import numpy as np
import pytest

from conftest import YOLO_DIR, has_yolo
from test_interp_twins import JS_TWIN_HASHES, _js_function_hash
from torch_js_fetch import GRAPHS, INTERP_JS, max_gap, run_interp, run_session

from onnxstream_tpu_torch.minijs import Engine, JSThrow
from onnxstream_tpu_torch.minijs.values import JSObject, NativeFunction

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_INTERP_JS = os.path.join(ROOT, "onnxstream_tpu", "api", "interp.js")
CLIENT_JS = os.path.join(ROOT, "onnxstream_tpu_torch", "api", "client.js")
OFFLINE = os.path.join(ROOT, "examples", "yolo_browser", "offline.html")
SESSION_TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _graph(name):
    return GRAPHS[name]()


@functools.lru_cache(maxsize=None)
def _port_js(name):
    return run_interp(*_graph(name))


def _source(path=INTERP_JS) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_port_interp_bit_for_bit_with_jax_pair(name):
    jax = run_interp(*_graph(name), minijs="onnxstream_tpu.minijs", interp_js=JAX_INTERP_JS)
    port = _port_js(name)
    for out in jax:
        assert port[out].shape == jax[out].shape
        assert port[out].tobytes() == jax[out].tobytes(), out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_port_interp_within_tolerance_of_port_session(name):
    gap = max_gap(_port_js(name), run_session(*_graph(name)))
    assert gap < SESSION_TOL, f"{name}: max|interp.js - Session| = {gap}"


def test_port_interp_error_paths_throw():
    eng = Engine()
    eng.run_file(INTERP_JS)
    model = eng.await_(eng.call_method(eng.global_get("InterpModel"), "create"))
    with pytest.raises(JSThrow, match="no tensor named"):
        eng.await_(eng.call_method(model, "get_tensor", "nope"))


@pytest.mark.parametrize("fn", sorted(JS_TWIN_HASHES))
def test_port_op_body_matches_twin_hash(fn):
    assert _js_function_hash(_source(), fn) == JS_TWIN_HASHES[fn]


def test_port_interp_differs_from_jax_copy_only_in_comments():
    """Outside comments the two files are the same program."""
    code = lambda s: [ln for ln in (l.split("//")[0].rstrip() for l in s.splitlines()) if ln]
    assert code(_source()) == code(_source(JAX_INTERP_JS))
    assert "TPU" not in _source()


# ------------------------------------------------------------ structure
def _strip_js(src: str) -> str:
    """Remove comments and string / template literals (keeps structure)."""
    out, i, n = [], 0, len(src)
    while i < n:
        c = src[i]
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = n if j == -1 else j
        elif c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            i = n if j == -1 else j + 2
        elif c in "'\"`":
            q, j = c, i + 1
            while j < n and src[j] != q:
                j += 2 if src[j] == "\\" else 1
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _interp_ops():
    src = _source()
    ops = set(re.findall(r'case "(\w+)":', src))
    unary_block = re.search(r"const UNARY = \{(.*?)\n\};", src, re.S).group(1)
    return ops | set(re.findall(r"(\w+):", unary_block))


@pytest.mark.parametrize("path", [INTERP_JS, CLIENT_JS], ids=["interp.js", "client.js"])
def test_js_delimiters_balanced(path):
    body = _strip_js(_source(path))
    for o, c in ("{}", "()", "[]"):
        assert body.count(o) == body.count(c), f"{path}: unbalanced {o}{c}"


def test_api_surface_matches_client_js():
    """InterpModel stays a drop-in for client.js's Model."""
    def methods(path):
        return set(re.findall(r"^\s+(?:static\s+)?async (\w+)\(", _source(path), re.M))

    missing = methods(CLIENT_JS) - methods(INTERP_JS) - {"_check"}
    assert not missing, f"interp.js missing client.js methods: {missing}"


def test_interp_covers_injected_ops():
    from onnxstream_tpu_torch.models.yolo.pipeline import YOLO_POST_OPS, YOLO_PRE_OPS

    injected = set(re.findall(r":(\w+)\*input", YOLO_PRE_OPS + YOLO_POST_OPS))
    assert injected <= _interp_ops(), f"missing injected ops: {injected - _interp_ops()}"


@pytest.mark.skipif(not has_yolo(), reason="reference yolov8n model not present")
def test_interp_covers_real_model_ops():
    used = set()
    for line in open(YOLO_DIR + "model.txt"):
        line = line.strip()
        if line:
            used.add(line.split("*", 1)[0].rsplit(":", 1)[1])
    assert used <= _interp_ops(), f"yolov8n needs ops missing from interp.js: {used - _interp_ops()}"


def test_offline_page_pushes_the_port_pipelines_tensors():
    """The page pushes what the port's YoloPipeline.detect pushes, and runs
    in-tab only."""
    from onnxstream_tpu_torch.models.yolo.pipeline import YoloPipeline

    page = _source(OFFLINE)
    assert "InterpModel.create" in page and "runParity" in page
    assert "client.js" not in page and "Model.create(base" not in page
    pushed = re.findall(r's\.add_tensor\("(\w+)"', inspect.getsource(YoloPipeline.detect))
    assert len(pushed) == 6
    for arg in pushed:
        assert f'"{arg}"' in page, f"offline.html must push {arg}"


def _op_lines():
    from onnxstream_tpu_torch.models.yolo.pipeline import YOLO_POST_OPS, YOLO_PRE_OPS

    text = "\n".join([YOLO_PRE_OPS, YOLO_POST_OPS, *(_graph(n)[0] for n in sorted(GRAPHS))])
    if has_yolo():
        text += open(YOLO_DIR + "model.txt").read()
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


def test_grammar_agrees_with_python_parser():
    """interp.js's field splits agree with the port's ir.py on every line."""
    from onnxstream_tpu_torch.ir import parse_op_line

    lines = _op_lines()
    assert len(lines) > 40
    for no, line in enumerate(lines, 1):
        node = parse_op_line(line, no, allow_dynamic=True)
        fields = line.split("*")
        assert len(fields) in (3, 4)
        assert fields[0].rsplit(":", 1)[1] == node.op_type  # the JS lastIndexOf(':') split
        assert len(fields[1][6:].split(";")) == len(node.inputs)
        assert len(fields[2][7:].split(";")) == len(node.outputs)


def test_interp_covers_whisper_graph_ops():
    from onnxstream_tpu_torch.models.whisper.model import WHISPER_TINY_TEST, build_decoder, build_encoder

    used = set()
    for g in (build_encoder(WHISPER_TINY_TEST).graph(), build_decoder(WHISPER_TINY_TEST, new_len=4).graph()):
        used |= {op.op_type for op in g.ops}
    assert used <= _interp_ops(), f"whisper needs ops missing from interp.js: {used - _interp_ops()}"


# ------------------------------------------------- the YOLO offline page
def _load_page() -> Engine:
    """The page's inline script, top to bottom, over the port's interp.js
    with DOM stubs."""
    eng = Engine()
    elements = {}

    def _get_el(this, args):
        key = eng.from_js(args[0])
        if key not in elements:
            elements[key] = JSObject({"textContent": "", "value": "", "width": 640.0, "height": 640.0})
        return elements[key]

    eng.scope.declare("document", JSObject({
        "getElementById": NativeFunction("getElementById", _get_el),
        "createElement": NativeFunction("createElement", lambda t, a: JSObject({"width": 0.0, "height": 0.0})),
    }))
    eng.scope.declare("window", eng.scope.lookup("globalThis"))
    eng.run_file(INTERP_JS)
    eng.run(re.search(r"<script>(.*)</script>", _source(OFFLINE), re.S).group(1))
    return eng


def test_yolo_page_loads_over_port_interp():
    eng = _load_page()
    assert "runParity" in eng.scope.lookup("globalThis").props
    for fn in ("nms", "iou", "buildModel", "runFrame"):
        assert eng.scope.lookup(fn) is not None


def test_yolo_page_nms_matches_port_pipeline():
    from onnxstream_tpu_torch.models.yolo import non_max_suppression

    eng = _load_page()
    js_nms = eng.scope.lookup("nms")
    rng = np.random.RandomState(5)
    for trial in range(4):
        n = 40
        centers, wh = rng.rand(n, 2) * 4, rng.rand(n, 2) * 2  # clustered, so suppression triggers
        if trial == 3:
            wh[::7] = 0.0  # zero-area boxes: iou() is 0
        boxes = np.stack([centers[:, 0], centers[:, 1], centers[:, 0] + wh[:, 0], centers[:, 1] + wh[:, 1]],
                         axis=1).astype(np.float32)
        scores = rng.rand(n).astype(np.float32)
        py = non_max_suppression(boxes, scores, 10, 0.45, 0.25)
        out = eng.interp.call(js_nms, None, [eng.to_js(boxes.reshape(-1)), eng.to_js(scores), 10.0, 0.45, 0.25])
        assert [int(v) for v in eng.from_js(out)] == list(py), f"trial {trial}"


def test_yolo_page_runframe_contract_matches_port_session():
    """The page's injected-op contract (the port's YOLO_PRE_OPS + a head +
    YOLO_POST_OPS, dynamic shapes, int64 arguments, split_arg, named outputs)
    through the port's interp.js, against the port's Session."""
    from onnxstream_tpu_torch.convert.builder import GraphBuilder
    from onnxstream_tpu_torch.models.yolo.pipeline import YOLO_POST_OPS, YOLO_PRE_OPS

    H = 4  # the page hardcodes 640; the contract is size-agnostic
    g = GraphBuilder(seed=2)
    x = g.input("images", (1, 3, H, H))
    conv = g.emit("Conv", [x, g.weight("head_w", g.randn(6, 3, 1, 1)), g.weight("head_b", g.randn(6))],
                  [(1, 6, H, H)], name="head", out_names=["conv_raw"])
    g.emit("Reshape", [conv, g.weight("oshape", np.array([1, 6, H * H], np.int64))], [(1, 6, H * H)], name="rs",
           out_names=["output0"])
    text = YOLO_PRE_OPS + g.to_text() + "\n" + YOLO_POST_OPS
    pushes = [("slice_start", np.array([0], np.int64)), ("slice_end", np.array([3], np.int64)),
              ("slice_axis", np.array([3], np.int64)), ("div_value", np.array([255.0], np.float32)),
              ("split_arg", np.array([4, 2], np.int64))]
    rgba = (np.random.RandomState(9).rand(H * H * 4) * 255).astype(np.float32)

    eng = _load_page()
    call = lambda obj, m, *a: eng.await_(eng.call_method(obj, m, *a))
    model = call(eng.global_get("InterpModel"), "create")
    call(model, "set_option", "support_dynamic_shapes", True)
    call(model, "read_string", text)
    manifest = eng.from_js(call(model, "get_weights_names"))
    for part in manifest.split("|"):
        typ, name = part.split(":", 1)
        call(model, "add_weights_file", typ, name,
             np.ascontiguousarray(g.weights[name], np.int64 if typ == "int64" else np.float32))
    call(model, "add_tensor", "images_raw", [1.0, float(H), float(H), 4.0], rgba)
    for name, data in pushes:
        call(model, "add_tensor", name, [float(data.size)], data, "int64" if data.dtype == np.int64 else None)
    call(model, "run")
    js = {n: np.asarray(eng.from_js(eng.get(call(model, "get_tensor", n), "data")), np.float32)
          for n in ("output0_0", "output0_1")}
    py = run_session(text, g.weights, {"images_raw": rgba.reshape(1, H, H, 4), **dict(pushes)},
                     ["output0_0", "output0_1"])
    for n in js:
        assert np.abs(js[n] - py[n].ravel()).max() < SESSION_TOL, n

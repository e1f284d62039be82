"""Helpers that run the port's JavaScript under minijs, without JAX.

    from torch_js_fetch import load_client, call, client_request, run_interp, GRAPHS

* ``load_client``: an engine with ``api/client.js`` loaded and a ``fetch()``
  over urllib declared in it (a browser's ``fetch`` resolves on 4xx / 5xx
  too; only network errors reject), each call's HTTP seconds logged;
  ``client_request``: one request of a fresh model through it, timed.
* ``run_interp``: ``api/interp.js``'s InterpModel over one graph, the way a
  page drives it (read_string, the weights manifest, add_tensor, run,
  get_tensor).
* ``GRAPHS``: the conv net, tensor-op and full-op-switch graphs that
  interp.js runs, built with the port's GraphBuilder from fixed seeds.

Every helper takes the minijs package by name (the port's by default), so a
test can drive the JAX package's engine and JS through the same code. The
module imports numpy, the standard library and the port only: chip_smoke.py
imports it on the machine with the card, which has no JAX.
"""

from __future__ import annotations

import importlib
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MINIJS = "onnxstream_tpu_torch.minijs"
CLIENT_JS = os.path.join(REPO, "onnxstream_tpu_torch", "api", "client.js")
INTERP_JS = os.path.join(REPO, "onnxstream_tpu_torch", "api", "interp.js")

# client.js has no read_file method (neither has the reference's wasm.js
# Model): a page that may name a server-side path posts it itself, through
# the Model's own error check
READ_FILE_JS = """
async function readFile(model, path) {
    await model._check(await fetch(`${model.base}/models/${model.handle}/read_file`,
                                   { method: "POST", body: path }));
}
"""


def _parts(minijs: str):
    return (importlib.import_module(minijs), importlib.import_module(minijs + ".values"),
            importlib.import_module(minijs + ".runtime"))


def call(eng, obj, method: str, *args):
    """``await obj.method(...args)``."""
    return eng.await_(eng.call_method(obj, method, *args))


def make_fetch(eng, minijs: str = PORT_MINIJS, log: list | None = None):
    """fetch() backed by urllib: an already settled promise of a
    Response-like object (json / text / arrayBuffer / headers.get). Each
    call appends (method, seconds of the HTTP exchange) to ``log``."""
    _, v, rt = _parts(minijs)

    def _fetch(this, args):
        url = eng.from_js(args[0])
        opts = args[1] if len(args) > 1 and isinstance(args[1], v.JSObject) else None
        method, body = "GET", None
        if opts is not None:
            m = opts.props.get("method", v.UNDEF)
            if m is not v.UNDEF:
                method = eng.from_js(m)
            b = opts.props.get("body", v.UNDEF)
            if b is not v.UNDEF and b is not v.NULL:
                if isinstance(b, v.JSTypedArray):
                    body = b.arr.tobytes()
                elif isinstance(b, rt.JSArrayBuffer):
                    body = b.data.tobytes()
                else:
                    body = str(eng.from_js(b)).encode()
        req = urllib.request.Request(url, data=body, method=method)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                payload, ctype = resp.read(), resp.headers.get("Content-Type", "") or ""
        except urllib.error.HTTPError as e:
            payload, ctype = e.read(), e.headers.get("Content-Type", "") or ""
            e.close()
        if log is not None:
            log.append((method, time.perf_counter() - t0))

        def settled(value):
            return v.JSPromise(value=value)

        headers = v.JSObject({"get": v.NativeFunction(
            "get", lambda t, a: ctype if eng.from_js(a[0]).lower() == "content-type" else v.NULL)})
        return settled(v.JSObject({
            "headers": headers,
            "json": v.NativeFunction("json", lambda t, a: settled(eng.to_js(json.loads(payload.decode())))),
            "text": v.NativeFunction("text", lambda t, a: settled(payload.decode())),
            "arrayBuffer": v.NativeFunction("arrayBuffer", lambda t, a: settled(
                rt.JSArrayBuffer(np.frombuffer(payload, np.uint8).copy()))),
        }))

    return v.NativeFunction("fetch", _fetch)


def load_client(minijs: str = PORT_MINIJS, client_js: str = CLIENT_JS, log: list | None = None):
    """(engine, Model class) with client.js run in a fresh engine, fetch()
    and encodeURIComponent declared, and ``readFile(model, path)``
    (READ_FILE_JS) defined."""
    pkg, v, _ = _parts(minijs)
    eng = pkg.Engine()
    eng.scope.declare("fetch", make_fetch(eng, minijs, log))
    eng.scope.declare("encodeURIComponent", v.NativeFunction(
        "encodeURIComponent", lambda t, a: urllib.parse.quote(str(eng.from_js(a[0])), safe="")))
    eng.run_file(client_js)
    eng.run(READ_FILE_JS)
    return eng, eng.get(eng.get(eng.scope.lookup("module"), "exports"), "Model")


def read_file(eng, model, path: str) -> None:
    eng.await_(eng.call(eng.scope.lookup("readFile"), model, path))


def tensor_of(eng, t) -> np.ndarray:
    """A ``{shape, data}`` object of get_tensor as a float32 array."""
    shape = [int(d) for d in eng.from_js(eng.get(t, "shape"))]
    return np.asarray(eng.from_js(eng.get(t, "data")), np.float32).reshape(shape)


def client_request(url: str, model_txt: str, inputs: dict, output: str):
    """One request of a fresh model through client.js, as phase_serve's
    Python client makes them: create (wp=prefetch), set_option
    use_bf16_arithmetic, read_file, add_tensor for every input, run,
    get_tensor(``output``), delete. Returns the output and the
    split in ms: ``setup`` (create, options, read_file), the request's
    ``puts``, ``run`` and ``get`` (the HTTP exchanges), ``js`` (the rest of
    the request: the JS engine's own marshalling and interpretation),
    ``request`` (PUTs to GET) and ``delete``."""
    log = []
    eng, model_cls = load_client(log=log)
    t0 = time.perf_counter()
    model = call(eng, model_cls, "create", url, "prefetch")
    call(eng, model, "set_option", "use_bf16_arithmetic", True)
    read_file(eng, model, model_txt)
    t1 = time.perf_counter()
    n0 = len(log)
    for k, x in inputs.items():
        call(eng, model, "add_tensor", k, list(x.shape), np.ascontiguousarray(x, np.float32).reshape(-1))
    call(eng, model, "run")
    out = tensor_of(eng, call(eng, model, "get_tensor", output))
    t2 = time.perf_counter()
    call(eng, model, "delete")
    t3 = time.perf_counter()
    http = {"PUT": 0.0, "POST": 0.0, "GET": 0.0}
    for method, s in log[n0:n0 + len(inputs) + 2]:
        http[method] += s * 1e3
    split = {"setup": (t1 - t0) * 1e3, "puts": http["PUT"], "run": http["POST"], "get": http["GET"],
             "js": (t2 - t1) * 1e3 - sum(http.values()), "request": (t2 - t1) * 1e3, "delete": (t3 - t2) * 1e3}
    return out, split


def run_interp(text: str, weights: dict, inputs: dict, out_names, minijs: str = PORT_MINIJS,
               interp_js: str = INTERP_JS) -> dict:
    """interp.js's InterpModel over ``text`` in a fresh engine: every weight
    its manifest names pushed as float32 or int64, every input pushed, one
    run; {name: float32 array} of ``out_names``."""
    eng = _parts(minijs)[0].Engine()
    eng.run_file(interp_js)
    model = call(eng, eng.global_get("InterpModel"), "create")
    call(eng, model, "read_string", text)
    manifest = eng.from_js(call(eng, model, "get_weights_names"))
    for part in (manifest.split("|") if manifest else []):
        typ, name = part.split(":", 1)
        buf = np.ascontiguousarray(weights[name], np.int64 if typ == "int64" else np.float32)
        call(eng, model, "add_weights_file", typ, name, buf)
    for k, x in inputs.items():
        x = np.asarray(x)
        if x.dtype == np.int64:
            call(eng, model, "add_tensor", k, list(x.shape), x.reshape(-1), "int64")
        else:
            call(eng, model, "add_tensor", k, list(x.shape), np.ascontiguousarray(x, np.float32).reshape(-1))
    call(eng, model, "run")
    return {n: tensor_of(eng, call(eng, model, "get_tensor", n)) for n in out_names}


def run_session(text: str, weights: dict, inputs: dict, out_names, device: str = "cpu") -> dict:
    """The port's float32 Session over the same graph: {name: float32 array}."""
    import torch

    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    s = Session(SessionConfig(compute_dtype="float32", device=torch.device(device)),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, x in inputs.items():
        s.add_tensor(k, np.asarray(x))
    res = s.run()
    s.close()
    return {n: np.asarray(res[n], np.float32) for n in out_names}


def max_gap(a: dict, b: dict) -> float:
    """The largest |a - b| over every output (shapes must agree)."""
    gaps = []
    for n in a:
        if a[n].shape != b[n].shape:
            raise AssertionError(f"{n}: shape {a[n].shape} against {b[n].shape}")
        gaps.append(float(np.abs(a[n].astype(np.float64) - b[n].astype(np.float64)).max()))
    return max(gaps)


# ------------------------------------------------------------------ graphs
def conv_net():
    """YOLO-flavored conv net: Conv(+bias, pad) -> Sigmoid -> Mul (SiLU) ->
    MaxPool -> grouped Conv -> Resize + Concat -> Reshape -> Transpose ->
    MatMul -> Softmax. (text, weights, inputs, outputs)."""
    from onnxstream_tpu_torch.convert.builder import GraphBuilder

    g = GraphBuilder(seed=0)
    x = g.input("img", (1, 4, 8, 8))
    c1 = g.conv(x, 8, 3, pad=1, name="c1")
    sg = g.emit("Sigmoid", [c1], [(1, 8, 8, 8)], name="sg")
    silu = g.emit("Mul", [c1, sg], [(1, 8, 8, 8)], name="silu")
    mp = g.emit("MaxPool", [silu], [(1, 8, 4, 4)], {"kernel_shape": "2,2", "strides": "2,2"}, name="mp")
    c2 = g.conv(mp, 8, 3, pad=1, groups=2, name="c2")
    up = g.emit("Resize", [mp, None, g.weight("scales", np.array([1, 1, 2, 2], np.float32))],
                [(1, 8, 8, 8)], {"mode": "nearest"}, name="up")
    cat = g.emit("Concat", [up, silu], [(1, 16, 8, 8)], {"axis": 1}, name="cat")
    rs = g.emit("Reshape", [cat, g.weight("rs_shape", np.array([1, 16, 64], np.int64))], [(1, 16, 64)], name="rs")
    tr = g.emit("Transpose", [rs], [(1, 64, 16)], {"perm": "0,2,1"}, name="tr")
    mm = g.emit("MatMul", [tr, g.weight("mm_w", g.randn(16, 8))], [(1, 64, 8)], name="mm")
    sm = g.emit("Softmax", [mm], [(1, 64, 8)], {"axis": "-1"}, name="sm")
    inputs = {"img": np.random.RandomState(7).randn(1, 4, 8, 8).astype(np.float32)}
    return g.to_text(), g.weights, inputs, [sm.name, c2.name]


def tensor_ops():
    """Index and shape machinery: Slice (with a reversing step), Split,
    Gather, Where / Greater, ReduceMean, broadcasting Add / Sub / Div / Pow,
    Unsqueeze / Squeeze / Flatten / Identity."""
    from onnxstream_tpu_torch.convert.builder import GraphBuilder

    g = GraphBuilder(seed=1)
    i64 = lambda *v: np.array(v, np.int64)
    f32 = lambda *v: np.array(v, np.float32)
    x = g.input("x", (2, 3, 8))
    sl = g.emit("Slice", [x, g.weight("st", i64(1)), g.weight("en", i64(7)), g.weight("ax", i64(2))],
                [(2, 3, 6)], name="sl")
    sl = g.emit("Slice", [sl, g.weight("st2", i64(5)), g.weight("en2", i64(-(2 ** 50))), g.weight("ax2", i64(2)),
                          g.weight("sp2", i64(-1))], [(2, 3, 6)], name="slrev")
    s1, s2 = g.emit("Split", [sl], [(2, 3, 3), (2, 3, 3)], {"axis": "2", "split": "3,3"}, name="sp",
                    out_names=["sp_a", "sp_b"])
    add = g.emit("Add", [s1, g.weight("bias", g.randn(3, 1))], [(2, 3, 3)], name="add")
    sub = g.emit("Sub", [add, s2], [(2, 3, 3)], name="sub")
    dv = g.emit("Div", [sub, g.weight("den", f32(2.0))], [(2, 3, 3)], name="dv")
    sh = g.emit("Add", [dv, g.weight("two", f32(2.5))], [(2, 3, 3)], name="sh")
    pw = g.emit("Pow", [sh, g.weight("exp", f32(2.0))], [(2, 3, 3)], name="pw")
    gt = g.emit("Greater", [pw, g.weight("thr", f32(4.0))], [(2, 3, 3)], name="gt")
    wh = g.emit("Where", [gt, pw, dv], [(2, 3, 3)], name="wh")
    rm = g.emit("ReduceMean", [wh], [(2, 1, 3)], {"axes": "1", "keepdims": "1"}, name="rm")
    gth = g.emit("Gather", [wh, g.weight("idx", i64(0, 2))], [(2, 2, 3)], {"axis": 1}, name="gth")
    un = g.emit("Unsqueeze", [gth], [(2, 2, 1, 3)], {"axes": "2"}, name="un")
    sq = g.emit("Squeeze", [un], [(2, 2, 3)], {"axes": "2"}, name="sq")
    fl = g.emit("Flatten", [sq], [(2, 6)], {"axis": "1"}, name="fl")
    idn = g.emit("Identity", [rm], [(2, 1, 3)], name="idn")
    inputs = {"x": np.random.RandomState(3).randn(2, 3, 8).astype(np.float32)}
    return g.to_text(), g.weights, inputs, [fl.name, idn.name]


def full_op_switch():
    """The rest of interp.js's op switch: Equal, Less, ScatterND and the
    whole UNARY table (Sqrt, Erf, Cos, Sin, Neg, Relu, Exp, Tanh, Sigmoid)."""
    from onnxstream_tpu_torch.convert.builder import GraphBuilder

    g = GraphBuilder(seed=4)
    f32 = lambda *v: np.array(v, np.float32)
    x = g.input("x", (2, 4))
    eq = g.emit("Equal", [x, g.weight("zero", np.zeros((1,), np.float32))], [(2, 4)], name="eq")
    ls = g.emit("Less", [x, g.weight("half", f32(0.5))], [(2, 4)], name="ls")
    wh = g.emit("Where", [ls, x, g.weight("neg1", f32(-1.0))], [(2, 4)], name="wh")
    sq = g.emit("Mul", [wh, wh], [(2, 4)], name="sq")
    cur = g.emit("ScatterND", [wh, g.weight("sidx", np.array([[0], [1]], np.int64)), sq], [(2, 4)], name="sc")
    for i, un in enumerate(["Sqrt", "Erf", "Cos", "Sin", "Neg", "Relu", "Exp", "Tanh", "Sigmoid"]):
        cur = g.emit(un, [cur], [(2, 4)], name=f"u{i}_{un.lower()}")
    # Equal surfaces through a Where: the interpreter stores booleans as f32
    eqf = g.emit("Where", [eq, g.weight("nine", f32(9.0)), x], [(2, 4)], name="eqf")
    x0 = (np.random.RandomState(8).rand(2, 4) * 0.8).astype(np.float32)
    x0[0, 0] = 0.0  # the Equal-true branch
    return g.to_text(), g.weights, {"x": x0}, [cur.name, eqf.name]


GRAPHS = {"conv_net": conv_net, "tensor_ops": tensor_ops, "full_op_switch": full_op_switch}

"""The port's browser / node client (onnxstream_tpu_torch/api/client.js)
under the port's minijs, against the port's HTTP server on the CPU.

    client.js (minijs, tests/torch_js_fetch.py's fetch over urllib)
      -> HTTP -> onnxstream_tpu_torch/cli/serve_main.py (a thread, port 0)
        -> the port's Session on the CPU

* the full Model flow: every tensor byte for byte with a direct port
  Session run, and with the JAX package's client.js (under its minijs)
  against the JAX package's server on the same requests;
* the error surface: the server's {"error": ...} thrown as a JS Error by
  client.js's _check, the same errors as the JAX pair's;
* the flow chip_smoke.py runs on the card (``client_request``): prefetch
  provider, use_bf16_arithmetic, read_file of a folder, run, get_tensor,
  delete; bit for bit with a direct Session under the same settings and
  with the Python HTTP client on the same server; read_file refused where
  the server does not allow it.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from torch_js_fetch import GRAPHS, call, client_request, load_client, read_file, tensor_of

from onnxstream_tpu.cli import serve_main as jax_serve_main
from onnxstream_tpu_torch import Session, SessionConfig
from onnxstream_tpu_torch.api import capi
from onnxstream_tpu_torch.cli import serve_main
from onnxstream_tpu_torch.minijs import JSThrow
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLIENT_JS = os.path.join(ROOT, "onnxstream_tpu", "api", "client.js")
MODEL = (
    "m:Mul*input:x(2,3);w.bin(float32:2,3)*output:y(2,3)\n"
    "a:Add*input:y(2,3);b.bin(float32:3)*output:z(2,3)\n"
)
W = np.arange(6, dtype=np.float32)
B = np.array([1, 2, 3], np.float32)
X = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)


@pytest.fixture(scope="module")
def servers():
    """{"port": url, "jax": url, "closed": url}: the port's server and the
    JAX package's with read_file allowed, and the port's without."""
    saved = capi._device[0]
    made = {"port": serve_main.serve("127.0.0.1", 0, allow_read_file=True, device="cpu"),
            "jax": jax_serve_main.serve("127.0.0.1", 0, allow_read_file=True),
            "closed": serve_main.serve("127.0.0.1", 0, device="cpu")}
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in made.values()]
    for t in threads:
        t.start()
    yield {k: f"http://127.0.0.1:{s.server_address[1]}" for k, s in made.items()}
    for s in made.values():
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=30)
    capi._device[0] = saved


def _client(which: str):
    if which == "jax":
        return load_client("onnxstream_tpu.minijs", JAX_CLIENT_JS)
    return load_client()


def _flow(which: str, url: str) -> dict:
    """test_client_js_exec.py's flow plus the rest of the Model surface."""
    eng, model_cls = _client(which)
    model = call(eng, model_cls, "create", url, "dict")
    call(eng, model, "add_weights_file", "float32", "w.bin", W)
    call(eng, model, "add_weights_file", "float32", "b.bin", B)
    call(eng, model, "read_string", MODEL)
    names = eng.from_js(call(eng, model, "get_weights_names"))
    call(eng, model, "add_extra_output", "y")
    call(eng, model, "add_tensor", "x", [2.0, 3.0], X.ravel())
    call(eng, model, "run")
    out = {n: tensor_of(eng, call(eng, model, "get_tensor", n)) for n in ("z", "y")}
    tensors = sorted(eng.from_js(call(eng, model, "get_all_tensor_names")))
    call(eng, model, "clear_tensors")
    call(eng, model, "delete")
    return {"weights_names": names, "tensor_names": tensors, **out}


def test_client_js_full_flow_matches_session_and_jax_pair(servers):
    port, jax = _flow("port", servers["port"]), _flow("jax", servers["jax"])
    s = Session(SessionConfig(device=torch.device("cpu")),
                weights_provider=DictWeightsProvider(params_from_numpy({"w.bin": W, "b.bin": B})))
    s.read_string(MODEL)
    s.add_extra_output("y")
    s.add_tensor("x", X)
    direct = {n: np.asarray(v, np.float32) for n, v in s.run().items()}
    s.close()
    assert port["weights_names"] == jax["weights_names"] == "float32:w.bin|float32:b.bin"
    assert port["tensor_names"] == jax["tensor_names"] == ["x", "y", "z"]
    for n in ("z", "y"):
        assert port[n].shape == (2, 3)
        assert port[n].tobytes() == jax[n].tobytes() == direct[n].tobytes(), n
    np.testing.assert_array_equal(port["z"], X * W.reshape(2, 3) + B)


# each case: the calls before the one that must throw, then that call
ERROR_CASES = {
    "garbage_model_text": [("read_string", ("not a model",))],
    "run_without_input": [("read_string", (MODEL,)), ("run", ())],
    "unknown_option": [("set_option", ("bogus", True))],
    "unknown_tensor": [("get_tensor", ("nope",))],
}


def _thrown(which: str, url: str, calls) -> tuple:
    """The error client.js throws at the last of ``calls``: (class, message)."""
    eng, model_cls = _client(which)
    model = call(eng, model_cls, "create", url, "dict")
    try:
        for method, args in calls[:-1]:
            call(eng, model, method, *args)
        method, args = calls[-1]
        with pytest.raises(Exception) as e:  # the JAX engine's JSThrow is another class
            call(eng, model, method, *args)
    finally:
        call(eng, model, "delete")
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_client_js_error_surface_matches_jax_pair(servers, case):
    port = _thrown("port", servers["port"], ERROR_CASES[case])
    assert port[0] == "JSThrow"
    assert port == _thrown("jax", servers["jax"], ERROR_CASES[case])


def _folder(tmp_path) -> str:
    """conv_net's graph as a converted folder: model.txt and a .bin a weight."""
    text, weights, _, _ = GRAPHS["conv_net"]()
    for name, arr in weights.items():
        np.asarray(arr).tofile(tmp_path / name)
    (tmp_path / "model.txt").write_text(text)
    return str(tmp_path / "model.txt")


def _python_client(url: str, model_txt: str, inputs: dict, output: str) -> np.ndarray:
    """phase_serve's Python flow on the same server."""
    def req(method, path, body=None):
        with urllib.request.urlopen(urllib.request.Request(url + path, data=body, method=method)) as r:
            return r.read()

    h = json.loads(req("POST", "/models?wp=prefetch"))["handle"]
    req("POST", f"/models/{h}/options?name=use_bf16_arithmetic&value=1")
    assert json.loads(req("POST", f"/models/{h}/read_file", model_txt.encode())) == {}
    for k, v in inputs.items():
        req("PUT", f"/models/{h}/tensors/{k}?type=float32&dims={','.join(map(str, v.shape))}", v.tobytes())
    assert json.loads(req("POST", f"/models/{h}/run")) == {}
    body = req("GET", f"/models/{h}/tensors/{output}")
    req("DELETE", f"/models/{h}")
    nd = int(np.frombuffer(body, "<u4", 1)[0])
    return np.frombuffer(body, "<f4", offset=4 + 4 * nd).reshape(np.frombuffer(body, "<u4", nd, 4))


def test_client_request_read_file_flow_bit_for_bit(servers, tmp_path):
    model_txt = _folder(tmp_path)
    _, _, inputs, outs = GRAPHS["conv_net"]()
    out, split = client_request(servers["port"], model_txt, inputs, outs[0])
    s = Session(SessionConfig(device=torch.device("cpu")), weights_provider_name="prefetch")
    s.set_option("use_bf16_arithmetic", True)
    s.read_file(model_txt)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    direct = np.asarray(s.run()[outs[0]], np.float32)
    s.close()
    assert out.shape == (1, 64, 8) and np.isfinite(out).all()
    assert out.tobytes() == direct.tobytes()
    assert out.tobytes() == _python_client(servers["port"], model_txt, inputs, outs[0]).tobytes()
    assert set(split) == {"setup", "puts", "run", "get", "js", "request", "delete"}
    assert all(v >= 0 for k, v in split.items() if k != "js")
    assert split["request"] >= split["puts"] + split["run"] + split["get"]


def test_client_read_file_refused_where_not_allowed(servers, tmp_path):
    model_txt = _folder(tmp_path)
    eng, model_cls = load_client()
    model = call(eng, model_cls, "create", servers["closed"], "prefetch")
    with pytest.raises(JSThrow, match="read_file disabled"):
        read_file(eng, model, model_txt)
    call(eng, model, "delete")

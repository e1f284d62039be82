"""The port's HTTP model server on the CPU, held to the JAX package's server
on the same requests: the model flow byte for byte, run errors, options, the
read-file and CORS gates, examples/whisper_http/run.py against the port's
server (the port's WhisperPipeline's tokens), and the YOLO browser flow
around tests/yolo_standin.py. Counterpart of tests/test_serve.py."""

import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from onnxstream_tpu.cli import serve_main as jax_serve_main
from onnxstream_tpu_torch.api import capi
from onnxstream_tpu_torch.cli import serve_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = (
    "m:Mul*input:x(2,3);w.bin(float32:2,3)*output:y(2,3)\n"
    "a:Add*input:y(2,3);b.bin(float32:3)*output:z(2,3)\n"
)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def urls():
    saved = capi._device[0]
    port, jax = serve_main.serve("127.0.0.1", 0, device="cpu"), jax_serve_main.serve("127.0.0.1", 0)
    yield _start(port), _start(jax)
    port.shutdown()
    jax.shutdown()
    capi._device[0] = saved


def _req(method, url, body=None):
    r = urllib.request.Request(url, data=body, method=method)
    with urllib.request.urlopen(r) as resp:
        return resp.read(), resp.headers.get("Content-Type", "")


def _new(url, wp="dict"):
    return json.loads(_req("POST", f"{url}/models?wp={wp}")[0])["handle"]


def _tensor(body):
    ndims = struct.unpack_from("<I", body)[0]
    dims = struct.unpack_from(f"<{ndims}I", body, 4)
    return np.frombuffer(body, np.float32, offset=4 + 4 * ndims).reshape(dims)


def _flow(url):
    h = _new(url)
    w = np.arange(6, dtype=np.float32)
    b = np.array([1, 2, 3], np.float32)
    _req("PUT", f"{url}/models/{h}/weights/w.bin?type=float32", w.tobytes())
    _req("PUT", f"{url}/models/{h}/weights/b.bin?type=float32", b.tobytes())
    _req("POST", f"{url}/models/{h}/read_string", MODEL.encode())
    names = _req("GET", f"{url}/models/{h}/weights_names")[0]
    _req("POST", f"{url}/models/{h}/extra_output?name=y")
    x = np.full((2, 3), 2.0, np.float32)
    _req("PUT", f"{url}/models/{h}/tensors/x?type=float32&dims=2,3", x.tobytes())
    run = _req("POST", f"{url}/models/{h}/run")[0]
    z, ctype = _req("GET", f"{url}/models/{h}/tensors/z")
    y = _req("GET", f"{url}/models/{h}/tensors/y")[0]
    tnames = _req("GET", f"{url}/models/{h}/tensor_names")[0]
    _req("POST", f"{url}/models/{h}/clear_tensors")
    _req("DELETE", f"{url}/models/{h}")
    return names, run, z, ctype, y, tnames


def test_http_model_flow_matches_jax(urls):
    got, want = _flow(urls[0]), _flow(urls[1])
    assert got == want
    names, run, z, ctype, _, tnames = got
    assert names == b"float32:w.bin|float32:b.bin" and json.loads(run) == {} and "octet-stream" in ctype
    np.testing.assert_array_equal(_tensor(z), 2 * np.arange(6, dtype=np.float32).reshape(2, 3) + [1, 2, 3])
    assert set(tnames.decode().split("|")) == {"x", "y", "z"}


def test_http_run_error_and_options_match_jax(urls):
    out = []
    for url in urls:
        h = _new(url)
        _req("POST", f"{url}/models/{h}/read_string", MODEL.encode())
        err = json.loads(_req("POST", f"{url}/models/{h}/run")[0])  # no input pushed
        _req("POST", f"{url}/models/{h}/options?name=use_bf16_arithmetic&value=1")
        with pytest.raises(urllib.error.HTTPError) as e:
            _req("POST", f"{url}/models/{h}/options?name=bogus&value=1")
        with pytest.raises(urllib.error.HTTPError) as e404:
            _req("POST", f"{url}/nothing")
        out.append((err, e.value.code, json.loads(e.value.read()), e404.value.code))
        _req("DELETE", f"{url}/models/{h}")
    assert out[0] == out[1]
    assert "error" in out[0][0] and out[0][1] == 400 and out[0][3] == 404


def test_http_read_file_gated_and_no_wildcard_cors(urls):
    url = urls[0]
    h = _new(url)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req("POST", f"{url}/models/{h}/read_file", b"/etc/hostname")
    assert ei.value.code == 403
    with urllib.request.urlopen(urllib.request.Request(f"{url}/models/{h}/tensor_names")) as resp:
        assert resp.headers.get("Access-Control-Allow-Origin") is None
    _req("DELETE", f"{url}/models/{h}")


@pytest.mark.parametrize("wp", ["ram", "prefetch"])
def test_http_read_file_and_cors_opt_in(tmp_path, wp):
    (tmp_path / "model.txt").write_text(MODEL)
    np.arange(6, dtype=np.float32).tofile(str(tmp_path / "w.bin"))
    np.array([1, 2, 3], np.float32).tofile(str(tmp_path / "b.bin"))
    srv = serve_main.serve("127.0.0.1", 0, allow_origin="http://localhost:3000", allow_read_file=True, device="cpu")
    url = _start(srv)
    try:
        h = _new(url, wp)
        body, _ = _req("POST", f"{url}/models/{h}/read_file", str(tmp_path / "model.txt").encode())
        assert json.loads(body) == {}
        _req("PUT", f"{url}/models/{h}/tensors/x?type=float32&dims=2,3", np.ones(6, np.float32).tobytes())
        assert json.loads(_req("POST", f"{url}/models/{h}/run")[0]) == {}
        z = _tensor(_req("GET", f"{url}/models/{h}/tensors/z")[0])
        np.testing.assert_array_equal(z, np.arange(6, dtype=np.float32).reshape(2, 3) + [1, 2, 3])
        with urllib.request.urlopen(urllib.request.Request(f"{url}/models/{h}/tensor_names")) as resp:
            assert resp.headers.get("Access-Control-Allow-Origin") == "http://localhost:3000"
        _req("DELETE", f"{url}/models/{h}")
    finally:
        srv.shutdown()


def test_whisper_http_example_gives_the_port_pipelines_tokens(urls):
    """examples/whisper_http/run.py (the JAX package's builders on the
    client side) against the port's server: the tokens of the port's
    WhisperPipeline with the same synthetic seeds."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples/whisper_http/run.py"),
         "--server", urls[0], "--synthetic", "--max-tokens", "4"],
        capture_output=True, text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    from onnxstream_tpu_torch.models.whisper import WhisperPipeline

    audio = np.random.RandomState(0).randn(16000).astype(np.float32) * 0.1
    expect = WhisperPipeline.from_synthetic(device=torch.device("cpu")).transcribe(audio, max_tokens=4)
    assert r.stdout.strip() == f"tokens: {expect}" and expect


PRE_OPS = (
    "pre_0:Slice*input:images_raw();slice_start();slice_end();slice_axis()*output:slice_output()\n"
    "pre_1:Transpose*input:slice_output()*output:trans_output()*perm:0,3,1,2\n"
    "pre_2:Div*input:trans_output();div_value()*output:images()\n"
)
POST_OPS = (
    "post_0:Transpose*input:output0()*output:trans2_output()*perm:0,2,1\n"
    "post_1:Split*input:trans2_output();split_arg()*output:output0_0();output0_1()*axis:2"
)


def _yolo_browser_flow(url, folder, size):
    """examples/yolo_browser/index.html's protocol: text ops injected around
    model.txt, weights uploaded from the manifest, pushed Slice / Div /
    Split arguments, an RGBA frame in, the two split outputs back."""
    from yolo_standin import standin_image

    h = _new(url)
    _req("POST", f"{url}/models/{h}/options?name=support_dynamic_shapes&value=1")
    model_txt = open(os.path.join(folder, "model.txt")).read()
    _req("POST", f"{url}/models/{h}/read_string", (PRE_OPS + model_txt + "\n" + POST_OPS).encode())
    entries = _req("GET", f"{url}/models/{h}/weights_names")[0].decode().split("|")
    for e in entries:
        typ, name = e.split(":", 1)
        with open(os.path.join(folder, name), "rb") as f:
            _req("PUT", f"{url}/models/{h}/weights/{name}?type={typ}", f.read())

    def put(name, dims, arr, typ="float32"):
        dimstr = ",".join(str(d) for d in dims)
        _req("PUT", f"{url}/models/{h}/tensors/{name}?type={typ}&dims={dimstr}", np.asarray(arr).tobytes())

    put("images_raw", (1, size, size, 4), standin_image(size, seed=1)[None].astype(np.float32))
    put("slice_start", (1,), np.array([0], np.int64), "int64")
    put("slice_end", (1,), np.array([3], np.int64), "int64")
    put("slice_axis", (1,), np.array([3], np.int64), "int64")
    put("div_value", (1,), np.array([255.0], np.float32))
    put("split_arg", (2,), np.array([4, 80], np.int64), "int64")
    assert json.loads(_req("POST", f"{url}/models/{h}/run")[0]) == {}
    out = [_tensor(_req("GET", f"{url}/models/{h}/tensors/{n}")[0]) for n in ("output0_0", "output0_1")]
    _req("DELETE", f"{url}/models/{h}")
    return entries, out


def test_http_yolo_browser_flow_on_the_standin(urls, tmp_path):
    """The browser flow around the stand-in head (YOLOv8n's I/O contract,
    not YOLOv8n) at 320 x 320: the port's server against the JAX server."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from yolo_standin import anchors, write_standin

    from onnxstream_tpu_torch.models.yolo import non_max_suppression

    size = 320
    write_standin(str(tmp_path), size=size, seed=0)
    (entries, (boxes, scores)), (jentries, (jboxes, jscores)) = (
        _yolo_browser_flow(url, str(tmp_path), size) for url in urls)
    assert entries == jentries and len(entries) == 16  # 4 a stride, 3 reshape shapes, the scale
    assert boxes.shape == (1, anchors(size), 4) and scores.shape == (1, anchors(size), 80)
    np.testing.assert_allclose(boxes, jboxes, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)
    xywh, cls = boxes[0], scores[0]
    corners = np.stack([xywh[:, 1] - xywh[:, 3] / 2, xywh[:, 0] - xywh[:, 2] / 2,
                        xywh[:, 1] + xywh[:, 3] / 2, xywh[:, 0] + xywh[:, 2] / 2], axis=1)
    keep = non_max_suppression(corners, cls.max(axis=1), iou_threshold=0.45, score_threshold=0.25)
    assert np.isfinite(corners).all() and len(keep) > 0

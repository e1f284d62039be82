"""`serve` — HTTP model server of the PyTorch/CUDA port.

Counterpart of ``onnxstream_tpu/cli/serve_main.py``: the same endpoints,
CORS and read-file gates, over ``onnxstream_tpu_torch.api.capi``. The
reference runs models in the browser via WASM (reference src/wasm.js +
examples/*_wasm); a GPU cannot live in a browser tab, so the client API
shape stays (the port's api/client.js mirrors the wasm.js Model surface;
api/interp.js runs the same IR in the tab itself) and execution moves
server-side onto the card.

    python -m onnxstream_tpu_torch.cli.serve_main --device cuda --port 8080

``--device`` (``cuda``, the default: the first card; or ``cpu``) is where
every model's session runs.

Endpoints (one model instance per handle, mirroring the C ABI surface of
reference src/exports.cpp):

  POST /models?wp=<name>                 -> {"handle": N}
  DELETE /models/<h>
  POST /models/<h>/read_string           (text body)
  GET  /models/<h>/weights_names         -> "type:name|..."
  PUT  /models/<h>/weights/<name>?type=  (raw bytes body)
  PUT  /models/<h>/tensors/<name>?type=&dims=1,2,3   (raw bytes body)
  POST /models/<h>/run                   -> {} or {"error": ...}
  GET  /models/<h>/tensors/<name>        -> binary: u32 ndims, u32 dims[],
                                            f32 data[] (little-endian)
  GET  /models/<h>/tensor_names          -> "a|b|c"
  POST /models/<h>/clear_tensors
  POST /models/<h>/options?name=&value=0|1
  POST /models/<h>/extra_output?name=
"""

from __future__ import annotations

import argparse
import json
import re
import struct
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np


def make_handler(allow_origin: str | None = None, allow_read_file: bool = False):
    from onnxstream_tpu_torch.api import capi

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _cors(self):
            # no wildcard by default: a localhost server that can read
            # arbitrary files must not be drivable by any web page
            # (CORS/DNS-rebinding); opt in per-origin with --allow-origin
            if allow_origin:
                self.send_header("Access-Control-Allow-Origin", allow_origin)

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self._cors()
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode())

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _route(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            m = re.match(r"^/models(?:/(\d+))?(?:/([a-z_]+))?(?:/(.+))?$", u.path)
            if not m:
                # sentinel distinct from the create route ('POST /models'):
                # unmatched paths must 404, not mint a model handle
                return None, "__bad__", None, q
            h = int(m.group(1)) if m.group(1) else None
            # client.js encodeURIComponent-encodes tensor/weight names (raw
            # ONNX names contain '/', ':', '%'): decode before use
            arg = unquote(m.group(3)) if m.group(3) else m.group(3)
            return h, m.group(2), arg, q

        def do_POST(self):
            h, action, arg, q = self._route()
            try:
                if h is None and action is None:
                    handle = capi.model_new_2(0, q.get("wp", "dict"))
                    return self._json({"handle": handle})
                if action == "read_string":
                    capi.model_read_string(h, self._body().decode())
                    return self._json({})
                if action == "read_file":
                    if not allow_read_file:
                        return self._json(
                            {"error": "read_file disabled (start with --allow-read-file)"}, 403)
                    err = capi.model_read_file(h, self._body().decode())
                    return self._json({"error": err} if err else {})
                if action == "run":
                    err = capi.model_run_2(h)
                    return self._json({"error": err} if err else {})
                if action == "clear_tensors":
                    capi.model_clear_tensors(h)
                    return self._json({})
                if action == "options":
                    capi.model_set_option(h, q["name"], int(q.get("value", "1")))
                    return self._json({})
                if action == "extra_output":
                    capi.model_add_extra_output(h, q["name"])
                    return self._json({})
            except Exception as e:
                return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
            self._json({"error": "bad route"}, 404)

        def do_PUT(self):
            h, action, name, q = self._route()
            try:
                if action == "weights":
                    capi.model_add_weights_file(h, q.get("type", "float32"), name, self._body())
                    return self._json({})
                if action == "tensors":
                    dims = [int(d) for d in q["dims"].split(",") if d]
                    capi.model_add_tensor(h, q.get("type", "float32"), name, dims, self._body())
                    return self._json({})
            except Exception as e:
                return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
            self._json({"error": "bad route"}, 404)

        def do_GET(self):
            h, action, name, q = self._route()
            try:
                if action == "weights_names":
                    return self._send(200, capi.model_get_weights_names(h).encode(), "text/plain")
                if action == "tensor_names":
                    return self._send(200, capi.model_get_all_tensor_names(h).encode(), "text/plain")
                if action == "tensors":
                    dims, data = capi.model_get_tensor(h, name)
                    payload = struct.pack("<I", len(dims))
                    payload += struct.pack(f"<{len(dims)}I", *dims)
                    payload += np.asarray(data, np.float32).tobytes()
                    return self._send(200, payload, "application/octet-stream")
            except Exception as e:
                return self._json({"error": f"{type(e).__name__}: {e}"}, 400)
            self._json({"error": "bad route"}, 404)

        def do_DELETE(self):
            h, _, _, _ = self._route()
            try:
                capi.model_delete(h)
                self._json({})
            except Exception as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)

        def do_OPTIONS(self):
            self.send_response(204)
            self._cors()
            self.send_header("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.end_headers()

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8080, allow_origin: str | None = None,
          allow_read_file: bool = False, device: str | None = None) -> ThreadingHTTPServer:
    """The server, not yet serving (call ``serve_forever``). ``device``
    (``"cuda"``, ``"cpu"``), when given, is set on capi for every model made
    from then on."""
    if device is not None:
        from onnxstream_tpu_torch.api import capi

        capi.set_device(device)
    server = ThreadingHTTPServer(
        (host, port), make_handler(allow_origin=allow_origin, allow_read_file=allow_read_file))
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="serve", description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--allow-origin", default=None,
                   help="value for Access-Control-Allow-Origin (omitted by default)")
    p.add_argument("--allow-read-file", action="store_true",
                   help="enable POST /models/<h>/read_file (reads server-side paths)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models run (cuda: the first card)")
    args = p.parse_args(argv)
    server = serve(args.host, args.port, allow_origin=args.allow_origin,
                   allow_read_file=args.allow_read_file, device=args.device)
    print(f"serving on http://{args.host}:{server.server_address[1]} ({args.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The 15-function model API (reference src/exports.cpp:42-311), Python side.

Counterpart of ``onnxstream_tpu/api/capi.py``, with the same handle table,
provider names and error strings. It is the one implementation behind every
binding of the port:

  * ``api/csrc/exports.cpp`` embeds CPython and forwards each `extern "C"`
    function here, giving ``libonnxstream_tpu_torch.so``
    (``runtime/native.py exports_library``), usable from C and anything
    else;
  * ``api/bindings.py``'s PyModel calls it in process;
  * ``api/bindings.py``'s Model loads the shared library through ctypes;
  * ``cli/serve_main.py`` serves it over HTTP.

Sessions are made on the module's device: the first CUDA card unless the
caller named another with ``set_device`` (the server's ``--device``, the
tests' ``set_device("cpu")``); with no card and no ``set_device`` a new
model raises. An embedded interpreter (the C library) reads the initial
device from the environment variable ``ONNXSTREAM_TPU_TORCH_DEVICE`` when
it is set.

Handles are integers; tensors cross the boundary as flat buffers + dims,
float32 only on output (reference model_get_tensor, exports.cpp:205-233).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.runtime.config import SessionConfig, default_device
from onnxstream_tpu_torch.runtime.session import Session
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, RamWeightsProvider

_lock = threading.Lock()
_handles: Dict[int, "_Ctx"] = {}
_next_handle = 1
_device: List[Optional[torch.device]] = [None]


def set_device(device) -> None:
    """The device new models' sessions run on (``"cuda"`` = the first card,
    ``"cpu"``, or a ``torch.device``); models made earlier keep theirs."""
    _device[0] = default_device() if str(device) == "cuda" else torch.device(device)


def get_device() -> torch.device:
    if _device[0] is None:
        set_device(os.environ.get("ONNXSTREAM_TPU_TORCH_DEVICE") or "cuda")
    return _device[0]


class _Ctx:
    def __init__(self, session: Session, dict_provider: Optional[DictWeightsProvider]):
        self.session = session
        self.dict_provider = dict_provider


# client-supplied weights (the WASM add_weights_file flow): eager instances
_DICT_PROVIDERS = {
    # reference model_new_2 names (src/exports.cpp:62-85)
    "::onnxstream::WeightsProvider": lambda: DictWeightsProvider(),
    "::onnxstream::RamWeightsProvider<::onnxstream::WeightsProvider>": lambda: RamWeightsProvider(DictWeightsProvider()),
    "dict": lambda: DictWeightsProvider(),
}
# disk-backed providers resolve LAZILY inside the Session so the .bin path
# prefix comes from the model.txt directory at read_file time (an eager
# instance with prefix "" could only find weights relative to the cwd)
_LAZY_PROVIDERS = {
    "::onnxstream::DiskNoCacheWeightsProvider": "nocache",
    "::onnxstream::DiskPrefetchWeightsProvider": "prefetch",
    "::onnxstream::RamWeightsProvider<::onnxstream::DiskPrefetchWeightsProvider>": "ram+prefetch",
    "nocache": "nocache",
    "prefetch": "prefetch",
    "ram": "ram",
    "ram+prefetch": "ram+prefetch",
}


def model_new() -> int:
    return model_new_2(0, "dict")


def model_new_2(threads_count: int, wp_name: str) -> int:
    """threads_count is accepted for ABI parity; the card's streams own the
    parallelism."""
    global _next_handle
    wp_name = wp_name or "dict"
    config = SessionConfig(device=get_device())
    dict_provider = None
    if wp_name in _DICT_PROVIDERS:
        provider = _DICT_PROVIDERS[wp_name]()
        dict_provider = provider if isinstance(provider, DictWeightsProvider) else None
        if isinstance(provider, RamWeightsProvider) and isinstance(provider.inner, DictWeightsProvider):
            dict_provider = provider.inner
        session = Session(config=config, weights_provider=provider)
    elif wp_name in _LAZY_PROVIDERS:
        session = Session(config=config, weights_provider_name=_LAZY_PROVIDERS[wp_name])
    else:
        raise ValueError(f"unknown weights provider {wp_name!r}")
    with _lock:
        h = _next_handle
        _next_handle += 1
        _handles[h] = _Ctx(session, dict_provider)
    return h


def _ctx(h: int) -> _Ctx:
    c = _handles.get(h)
    if c is None:
        raise ValueError(f"invalid model handle {h}")
    return c


def model_delete(h: int) -> None:
    with _lock:
        c = _handles.pop(h, None)
    if c is not None:
        c.session.close()


def model_read_string(h: int, s: str) -> None:
    _ctx(h).session.read_string(s)


def model_read_file(h: int, fn: str) -> Optional[str]:
    try:
        _ctx(h).session.read_file(fn)
        return None
    except Exception as e:  # error-string variant (exports.cpp:98-109)
        return f"{type(e).__name__}: {e}"


def model_get_weights_names(h: int) -> str:
    return _ctx(h).session.get_weights_names()


def model_add_weights_file(h: int, type_str: str, name: str, data) -> None:
    """Client supplies the weight bytes (WASM flow, exports.cpp:150-167).

    `data` is the raw buffer; dtype from type_str ('float32'/'float16'/...)."""
    c = _ctx(h)
    dt = DType(type_str)
    arr = np.frombuffer(bytes(data), dtype=dt.storage_np).copy()
    if c.dict_provider is None:
        raise RuntimeError("current weights provider does not accept client weights")
    t = torch.from_numpy(arr)
    c.dict_provider.weights[name] = t.view(torch.bfloat16) if dt == DType.bfloat16 else t


def model_add_tensor(h: int, type_str: str, name: str, dims: List[int], data) -> None:
    dt = DType(type_str)
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=dt.storage_np).reshape(dims).copy()
    else:
        arr = np.asarray(data, dtype=dt.storage_np).reshape(dims)
    _ctx(h).session.add_tensor(name, arr)


def model_get_tensor(h: int, name: str):
    """Returns (dims, flat float32 data). Like the reference ABI, only float
    tensors cross this boundary (src/exports.cpp:205-233 returns null
    otherwise): a silent int64 -> fp32 cast would corrupt ids above 2^24."""
    v = _ctx(h).session.get_tensor(name)
    if isinstance(v, torch.Tensor):
        if not v.is_floating_point():
            raise TypeError(f"tensor {name!r} is {v.dtype}, not float (fp32-only ABI surface)")
        v = v.detach().float().cpu().numpy()
    v = np.asarray(v)
    if not np.issubdtype(v.dtype, np.floating):
        raise TypeError(f"tensor {name!r} is {v.dtype}, not float (fp32-only ABI surface)")
    v = v.astype(np.float32)
    return list(v.shape), v.reshape(-1)


def model_get_all_tensor_names(h: int) -> str:
    return "|".join(_ctx(h).session.get_all_tensor_names())


def model_run(h: int) -> None:
    _ctx(h).session.run()


def model_run_2(h: int) -> Optional[str]:
    try:
        _ctx(h).session.run()
        return None
    except Exception as e:
        return f"{type(e).__name__}: {e}"


def model_clear_tensors(h: int) -> None:
    _ctx(h).session.clear_tensors()


def model_set_option(h: int, name: str, value: int) -> None:
    # Session.set_option re-fuses the graph so fusion-gating flags work even
    # after read_string/read_file (the reference applies options at run time)
    _ctx(h).session.set_option(name, bool(value))


def model_add_extra_output(h: int, name: str) -> None:
    _ctx(h).session.add_extra_output(name)

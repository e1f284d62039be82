"""Python bindings for the C ABI (parity with reference src/bindings.py).

Counterpart of ``onnxstream_tpu/api/bindings.py``. Two interchangeable
clients:

  * ``Model(library_path=...)``: ctypes over ``libonnxstream_tpu_torch.so``
    (built at first use when no path is given: ``runtime/native.py
    exports_library``), the same surface as the reference bindings
    (context manager, numpy and pure-list tensor I/O, set_* option methods,
    name mangling). The library embeds CPython: load it into a running
    interpreter only in a fresh process;
  * ``PyModel()``: the same surface calling onnxstream_tpu_torch.api.capi
    in process (no native library needed).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from onnxstream_tpu_torch.dtypes import demangle_name, mangle_name


class OnnxStreamError(Exception):
    pass


class GetTensorReturnLayout(ctypes.Structure):
    _fields_ = [
        ("dims_num", ctypes.c_size_t),
        ("dims", ctypes.POINTER(ctypes.c_size_t)),
        ("data_num", ctypes.c_size_t),
        ("data", ctypes.POINTER(ctypes.c_float)),
    ]


_OPTIONS = [
    "use_fp16_arithmetic",
    "use_bf16_arithmetic",
    "use_uint8_qdq",
    "use_uint8_arithmetic",
    "fuse_ops_in_attention",
    "force_fp16_storage",
    "support_dynamic_shapes",
    "use_ops_cache",
    "use_scaled_dp_attn_op",
    "use_next_op_cache",
    "ops_printf",
    "ops_times_printf",
    "use_nchw_convs",
    "use_flash_attention",
]


class _BaseModel:
    """Shared convenience surface (reference src/bindings.py:62-307)."""

    def add_tensor(self, name: str, data: np.ndarray) -> None:
        raise NotImplementedError

    def get_tensor(self, name: str) -> Tuple[np.ndarray, List[int]]:
        raise NotImplementedError

    # list-based variants (reference bindings.py:186-271)
    def add_tensor_as_list(self, name: str, data: list, dtype: str = "float32") -> None:
        self.add_tensor(name, np.asarray(data, dtype=np.dtype(dtype)))

    def get_tensor_as_list(self, name: str) -> Tuple[list, List[int]]:
        arr, dims = self.get_tensor(name)
        return arr.reshape(-1).tolist(), dims

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    mangle_name = staticmethod(mangle_name)
    demangle_name = staticmethod(demangle_name)


def _add_option_setters(cls):
    for opt in _OPTIONS:
        def setter(self, value: bool, _o=opt):
            self._set_option(_o, value)

        setattr(cls, f"set_{opt}", setter)
    return cls


@_add_option_setters
class PyModel(_BaseModel):
    """In-process client of the 15-function API."""

    def __init__(self, threads_count: int = 0, weights_provider_name: str = "dict"):
        from onnxstream_tpu_torch.api import capi

        self._capi = capi
        self._h = capi.model_new_2(threads_count, weights_provider_name)

    def close(self) -> None:
        if self._h:
            self._capi.model_delete(self._h)
            self._h = 0

    def read_file(self, filename: str) -> None:
        err = self._capi.model_read_file(self._h, filename)
        if err:
            raise OnnxStreamError(err)

    def read_string(self, model_string: str) -> None:
        self._capi.model_read_string(self._h, model_string)

    def get_weights_names(self) -> List[str]:
        s = self._capi.model_get_weights_names(self._h)
        return s.split("|") if s else []

    def add_weights_file(self, type_str: str, name: str, data: np.ndarray) -> None:
        self._capi.model_add_weights_file(self._h, type_str, name, np.asarray(data).tobytes())

    def add_tensor(self, name: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        self._capi.model_add_tensor(self._h, str(data.dtype), name, list(data.shape), data.reshape(-1))

    def get_tensor(self, name: str) -> Tuple[np.ndarray, List[int]]:
        dims, flat = self._capi.model_get_tensor(self._h, name)
        return np.asarray(flat, np.float32).reshape(dims), dims

    def get_all_tensor_names(self) -> List[str]:
        s = self._capi.model_get_all_tensor_names(self._h)
        return s.split("|") if s else []

    def run(self) -> None:
        err = self._capi.model_run_2(self._h)
        if err:
            raise OnnxStreamError(err)

    def clear_tensors(self) -> None:
        self._capi.model_clear_tensors(self._h)

    def add_extra_output(self, name: str) -> None:
        self._capi.model_add_extra_output(self._h, name)

    def _set_option(self, name: str, value: bool) -> None:
        self._capi.model_set_option(self._h, name, int(bool(value)))


@_add_option_setters
class Model(_BaseModel):
    """ctypes client of libonnxstream_tpu_torch.so (reference src/bindings.py:62)."""

    def __init__(self, library_path: Optional[str] = None, threads_count: int = 0,
                 weights_provider_name: str = "dict"):
        if library_path is None:
            from onnxstream_tpu_torch.runtime.native import exports_library

            library_path = str(exports_library())
        self._lib = ctypes.CDLL(library_path)
        self._setup_prototypes()
        self._h = self._lib.model_new_2(threads_count, weights_provider_name.encode())
        if not self._h:
            raise OnnxStreamError("model_new_2 failed")

    def _setup_prototypes(self) -> None:
        L = self._lib
        L.model_new.restype = ctypes.c_void_p
        L.model_new_2.restype = ctypes.c_void_p
        L.model_new_2.argtypes = [ctypes.c_int, ctypes.c_char_p]
        L.model_delete.argtypes = [ctypes.c_void_p]
        L.model_read_string.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        L.model_read_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        L.model_read_file.restype = ctypes.c_void_p
        L.model_get_weights_names.argtypes = [ctypes.c_void_p]
        L.model_get_weights_names.restype = ctypes.c_void_p
        L.model_add_weights_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint]
        L.model_add_weights_file.restype = ctypes.c_void_p
        L.model_add_tensor.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_uint),
        ]
        L.model_add_tensor.restype = ctypes.c_void_p
        L.model_get_tensor.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        L.model_get_tensor.restype = ctypes.c_void_p
        L.model_get_all_tensor_names.argtypes = [ctypes.c_void_p]
        L.model_get_all_tensor_names.restype = ctypes.c_void_p
        L.model_run.argtypes = [ctypes.c_void_p]
        L.model_run_2.argtypes = [ctypes.c_void_p]
        L.model_run_2.restype = ctypes.c_void_p
        L.model_clear_tensors.argtypes = [ctypes.c_void_p]
        L.model_set_option.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
        L.model_add_extra_output.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        L.model_free_buffer.argtypes = [ctypes.c_void_p]

    def _take_string(self, ptr) -> Optional[str]:
        if not ptr:
            return None
        s = ctypes.string_at(ptr).decode()
        self._lib.model_free_buffer(ptr)
        return s

    def close(self) -> None:
        if self._h:
            self._lib.model_delete(self._h)
            self._h = None

    def read_file(self, filename: str) -> None:
        err = self._take_string(self._lib.model_read_file(self._h, filename.encode()))
        if err:
            raise OnnxStreamError(err)

    def read_string(self, model_string: str) -> None:
        self._lib.model_read_string(self._h, model_string.encode())

    def get_weights_names(self) -> List[str]:
        s = self._take_string(self._lib.model_get_weights_names(self._h))
        return s.split("|") if s else []

    def add_weights_file(self, type_str: str, name: str, data: np.ndarray) -> None:
        raw = np.ascontiguousarray(data)
        buf = self._lib.model_add_weights_file(self._h, type_str.encode(), name.encode(), raw.nbytes)
        ctypes.memmove(buf, raw.ctypes.data, raw.nbytes)

    def add_tensor(self, name: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        dims = (ctypes.c_uint * data.ndim)(*data.shape)
        buf = self._lib.model_add_tensor(self._h, str(data.dtype).encode(), name.encode(), data.ndim, dims)
        ctypes.memmove(buf, data.ctypes.data, data.nbytes)

    def get_tensor(self, name: str) -> Tuple[np.ndarray, List[int]]:
        ptr = self._lib.model_get_tensor(self._h, name.encode())
        if not ptr:
            raise OnnxStreamError(f"tensor {name!r} not found or not float32")
        layout = GetTensorReturnLayout.from_address(ptr)
        dims = [layout.dims[i] for i in range(layout.dims_num)]
        data = np.ctypeslib.as_array(layout.data, shape=(layout.data_num,)).copy()
        self._lib.model_free_buffer(ptr)
        return data.reshape(dims), dims

    def get_all_tensor_names(self) -> List[str]:
        s = self._take_string(self._lib.model_get_all_tensor_names(self._h))
        return s.split("|") if s else []

    def run(self) -> None:
        err = self._take_string(self._lib.model_run_2(self._h))
        if err:
            raise OnnxStreamError(err)

    def clear_tensors(self) -> None:
        self._lib.model_clear_tensors(self._h)

    def add_extra_output(self, name: str) -> None:
        self._lib.model_add_extra_output(self._h, name.encode())

    def _set_option(self, name: str, value: bool) -> None:
        self._lib.model_set_option(self._h, name.encode(), int(bool(value)))

"""Weight providers: the streaming I/O layer.

Counterpart of ``onnxstream_tpu/runtime/weights.py``: the same provider
contract as the reference WeightsProvider hierarchy (src/onnxstream.h:266-900)

  * ``on_init(entries)``    announce the full load order before the first run
  * ``on_restart()``        rewind for the next run
  * ``get(name)``           blocking fetch of the next weight
  * ``remove(name)``        drop a cached weight
  * ``update(name, t)``     write a dtype-converted weight back into the cache

but ``get`` returns a host (CPU) ``torch.Tensor``. The executor converts it
to the upload dtype (once: the converted tensor goes back through
``update``), pins it and copies it to the card. ``get_into(name, dtype,
shape, out)`` fills a caller's tensor instead: the streamed executor hands
it a view of its pinned staging buffer, which the native prefetcher
(``NativeDiskPrefetchWeightsProvider``, ``runtime/csrc/prefetch.cpp``)
writes straight into; the other providers fill it by a copy.

``params_from_numpy`` turns the JAX package's numpy parameters
(``GraphBuilder.weights``) into the port's tensors. ``LazyArray``
placeholders (``GraphBuilder(lazy_weights=True)``) stay placeholders: a
``DictWeightsProvider`` materializes one only when the host asks for its
values, which under ``SessionConfig.synthetic_device_weights`` is never the
case for a big weight.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import DType, to_torch


class WeightsProvider:
    """Abstract provider (reference src/onnxstream.h:266-291)."""

    # whether update() keeps the tensor it is given (a cache that hands it
    # out again). The streamed executor converts a weight on the host for
    # such a provider, and hands it the result; for any other it copies the
    # file's bytes to the card and converts them there
    keeps_updates = False

    def on_init(self, entries: Sequence[Tuple[str, DType, Tuple[int, ...]]]) -> None:
        """entries = (name, dtype, shape) in execution (stream) order."""

    def on_restart(self) -> None:
        pass

    def get(self, name: str, dtype: DType, shape: Tuple[int, ...]) -> torch.Tensor:
        raise NotImplementedError

    def remove(self, name: str) -> None:
        pass

    def update(self, name: str, t: torch.Tensor) -> None:
        pass

    def get_into(self, name: str, dtype: DType, shape: Tuple[int, ...], out: torch.Tensor) -> torch.Tensor:
        """``get`` into ``out``, a contiguous host tensor of ``shape`` in the
        storage dtype of ``dtype``; returns ``out``."""
        out.copy_(self.get(name, dtype, shape).reshape(out.shape))
        return out

    def close(self) -> None:
        pass


def _read_bin(path: str, dtype: DType, shape: Tuple[int, ...]) -> torch.Tensor:
    nelem = int(np.prod(shape)) if shape else 1
    arr = np.fromfile(path, dtype=dtype.storage_np, count=nelem)
    if arr.size != nelem:
        raise IOError(f"{path}: expected {nelem} elements of {dtype.value}, got {arr.size}")
    t = torch.from_numpy(arr.reshape(shape))
    return t.view(torch.bfloat16) if dtype == DType.bfloat16 else t


def is_lazy(arr) -> bool:
    """Whether arr is a builder's ``LazyArray`` placeholder (made on demand)."""
    return hasattr(arr, "materialize")


def params_from_numpy(weights: Dict[str, object]) -> Dict[str, object]:
    """numpy parameters of the JAX package (``GraphBuilder.weights``) -> host
    torch tensors with the same bits; ``ml_dtypes.bfloat16`` arrays go
    through a uint16 view. ``LazyArray`` placeholders are carried as they
    are, unmaterialized."""
    return {name: arr if is_lazy(arr) else to_torch(arr) for name, arr in weights.items()}


class CollectNamesWeightsProvider(WeightsProvider):
    """Dry-run provider: records (name, dtype, shape), never loads
    (reference src/onnxstream.h:293-329, src/exports.cpp:111-148)."""

    def __init__(self) -> None:
        self.names: List[Tuple[str, DType, Tuple[int, ...]]] = []

    def on_init(self, entries) -> None:
        self.names = list(entries)

    def get(self, name, dtype, shape):
        raise RuntimeError("CollectNamesWeightsProvider records names only; it cannot load weights")

    def manifest(self) -> str:
        """`type:name|type:name|...`, the format of model_get_weights_names
        (reference src/exports.cpp:130-140)."""
        return "|".join(f"{d.value}:{n}" for n, d, _ in self.names)


class DiskNoCacheWeightsProvider(WeightsProvider):
    """Blocking read of {path}{name} per request; zero residency
    (reference src/onnxstream.h:331-354)."""

    def __init__(self, path_prefix: str) -> None:
        self.prefix = path_prefix

    def get(self, name, dtype, shape):
        return _read_bin(self.prefix + name, dtype, shape)


class DiskPrefetchWeightsProvider(WeightsProvider):
    """Background-thread prefetcher with a bounded in-flight byte budget.

    Same protocol as the reference (src/onnxstream.h:356-664): on_init fixes
    the read order; a worker thread reads ahead until the buffered bytes would
    exceed ``max_bytes`` (always allowing one file past the limit); ``get``
    pops the front entry, blocking until ready; ``on_restart`` rewinds.
    Out-of-order requests fall back to a direct read.
    """

    def __init__(self, path_prefix: str, max_bytes: int = 1 << 28) -> None:
        self.prefix = path_prefix
        self.max_bytes = max_bytes
        self._entries: List[Tuple[str, DType, Tuple[int, ...]]] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ready: "collections.OrderedDict[str, torch.Tensor]" = collections.OrderedDict()
        self._buffered = 0
        self._next_read = 0
        self._next_serve = 0
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def on_init(self, entries) -> None:
        self.close()
        self._entries = list(entries)
        self._ready.clear()
        self._buffered = 0
        self._next_read = 0
        self._next_serve = 0
        self._stop = False
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True, name="ostt-prefetch")
        self._thread.start()

    def on_restart(self) -> None:
        self.on_init(self._entries)

    def _worker(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._stop and (
                        self._next_read >= len(self._entries)
                        or (self._buffered > self.max_bytes and self._ready)
                    ):
                        if self._next_read >= len(self._entries):
                            return
                        self._cv.wait()
                    if self._stop:
                        return
                    name, dtype, shape = self._entries[self._next_read]
                    self._next_read += 1
                t = _read_bin(self.prefix + name, dtype, shape)
                with self._cv:
                    self._ready[name] = t
                    self._buffered += t.numel() * t.element_size()
                    self._cv.notify_all()
        except BaseException as e:  # surfaced on the consumer (onnxstream.h:529-537)
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def get(self, name, dtype, shape):
        with self._cv:
            in_order = (
                self._next_serve < len(self._entries) and self._entries[self._next_serve][0] == name
            )
            if in_order or name in self._ready:
                while name not in self._ready:
                    if self._error is not None:
                        raise self._error
                    self._cv.wait()
                t = self._ready.pop(name)
                self._buffered -= t.numel() * t.element_size()
                if in_order:
                    self._next_serve += 1
                self._cv.notify_all()
                return t
        # out-of-order request (e.g. a weight reused by a later segment)
        return _read_bin(self.prefix + name, dtype, shape)

    def close(self) -> None:
        if self._thread is not None:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            self._thread.join(timeout=5)
            self._thread = None


_PREFETCH_LIB: List[ctypes.CDLL] = []


def _prefetch_lib() -> ctypes.CDLL:
    """The native prefetcher, built at first use (runtime/native.py); a
    failed build raises with the compiler's error."""
    if not _PREFETCH_LIB:
        from onnxstream_tpu_torch.runtime.native import prefetch_library

        lib = ctypes.CDLL(str(prefetch_library()))
        lib.ostpu_prefetch_new.restype = ctypes.c_void_p
        lib.ostpu_prefetch_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ostpu_prefetch_init.restype = None
        lib.ostpu_prefetch_init.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ostpu_prefetch_get.restype = ctypes.c_int
        lib.ostpu_prefetch_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.ostpu_prefetch_restart.restype = None
        lib.ostpu_prefetch_restart.argtypes = [ctypes.c_void_p]
        lib.ostpu_prefetch_delete.restype = None
        lib.ostpu_prefetch_delete.argtypes = [ctypes.c_void_p]
        _PREFETCH_LIB.append(lib)
    return _PREFETCH_LIB[0]


class NativeDiskPrefetchWeightsProvider(WeightsProvider):
    """The DiskPrefetch contract on the C++ worker of ``runtime/csrc/prefetch.cpp``
    (the JAX package's ``csrc/prefetch.cpp``, copied): the reads run on a
    native thread that holds no Python lock, ahead of the executor's
    dispatch, and ``get_into`` copies a weight's bytes straight into the
    caller's buffer. Same protocol as ``DiskPrefetchWeightsProvider``;
    a missing or short file raises ``IOError``."""

    def __init__(self, path_prefix: str, max_bytes: int = 1 << 28) -> None:
        self._lib = _prefetch_lib()
        self.prefix = path_prefix
        self._h = self._lib.ostpu_prefetch_new(path_prefix.encode(), max_bytes)

    def on_init(self, entries) -> None:
        entries = list(entries)
        names = (ctypes.c_char_p * len(entries))(*[e[0].encode() for e in entries])
        sizes = (ctypes.c_uint64 * len(entries))(
            *[int(np.prod(e[2])) * e[1].itemsize for e in entries])
        self._lib.ostpu_prefetch_init(self._h, names, sizes, len(entries))

    def on_restart(self) -> None:
        self._lib.ostpu_prefetch_restart(self._h)

    def get(self, name, dtype, shape):
        return self.get_into(name, dtype, shape, torch.empty(tuple(shape), dtype=dtype.torch))

    def get_into(self, name, dtype, shape, out):
        nbytes = (int(np.prod(shape)) if shape else 1) * dtype.itemsize
        if out.device.type != "cpu" or not out.is_contiguous() or out.numel() * out.element_size() != nbytes:
            raise ValueError(f"{name}: get_into needs a contiguous host tensor of {nbytes} bytes")
        if self._lib.ostpu_prefetch_get(self._h, name.encode(), out.data_ptr(), nbytes) != 0:
            raise IOError(f"native prefetch failed to read {self.prefix + name} ({nbytes} bytes)")
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ostpu_prefetch_delete(self._h)
            self._h = None

    def __del__(self) -> None:
        self.close()


class RamWeightsProvider(WeightsProvider):
    """Decorator: the first run pulls from the inner provider and caches;
    later runs serve from RAM (reference src/onnxstream.h:666-900)."""

    keeps_updates = True

    def __init__(self, inner: WeightsProvider) -> None:
        self.inner = inner
        self._cache: Dict[str, torch.Tensor] = {}
        self._warm = False

    def on_init(self, entries) -> None:
        if not self._warm:
            self.inner.on_init(entries)

    def on_restart(self) -> None:
        if not self._warm:
            self.inner.on_restart()

    def get(self, name, dtype, shape):
        if name in self._cache:
            return self._cache[name]
        t = self.inner.get(name, dtype, shape)
        self._cache[name] = t
        return t

    def remove(self, name) -> None:
        if not self._warm:
            self._cache.pop(name, None)

    def update(self, name, t) -> None:
        self._cache[name] = t

    def mark_warm(self) -> None:
        self._warm = True

    def close(self) -> None:
        self.inner.close()


class DictWeightsProvider(WeightsProvider):
    """In-memory provider: host tensors supplied by the caller (for example
    ``params_from_numpy(GraphBuilder.weights)``). A ``LazyArray`` placeholder
    is materialized when it is first asked for, and kept as a tensor."""

    keeps_updates = True

    def __init__(self, weights: Optional[Dict[str, object]] = None) -> None:
        self.weights: Dict[str, object] = dict(weights or {})

    def get(self, name, dtype, shape):
        t = self.weights[name]
        if is_lazy(t):
            t = self.weights[name] = to_torch(t.materialize())
        if not isinstance(t, torch.Tensor):
            raise TypeError(
                f"{name}: DictWeightsProvider holds torch tensors "
                "(convert numpy parameters with params_from_numpy)")
        nelem = int(np.prod(shape)) if shape else 1
        if t.numel() != nelem:
            raise ValueError(f"{name}: expected {nelem} elements, got {t.numel()}")
        return t.reshape(shape) if tuple(t.shape) != tuple(shape) else t

    def update(self, name, t) -> None:
        self.weights[name] = t

    def remove(self, name) -> None:
        # the dict is the source of truth: a re-plan must find it again
        pass


def make_provider(name: str, path_prefix: str, **kw) -> WeightsProvider:
    """Provider registry matching model_new_2's five names (reference
    src/exports.cpp:62-85). ``prefetch`` is the native prefetcher; where it
    cannot be built, this raises with the compiler's error (the Python
    ``DiskPrefetchWeightsProvider`` is never taken in its place)."""
    if name == "collect":
        return CollectNamesWeightsProvider()
    if name == "nocache":
        return DiskNoCacheWeightsProvider(path_prefix)
    if name == "prefetch":
        return NativeDiskPrefetchWeightsProvider(path_prefix, **kw)
    if name == "ram":
        return RamWeightsProvider(DiskNoCacheWeightsProvider(path_prefix))
    if name == "ram+prefetch":
        return RamWeightsProvider(make_provider("prefetch", path_prefix, **kw))
    raise ValueError(f"unknown weights provider {name!r}")

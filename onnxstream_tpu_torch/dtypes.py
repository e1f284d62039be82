"""Data types and name (de)mangling for the model.txt text IR.

Counterpart of ``onnxstream_tpu/dtypes.py``. The wire dtypes are the
reference's four (uint8 with scale/zero-point, float16, float32, int64) plus
the compute-only extensions (bfloat16, int8, int32, bool). Here every member
maps to a ``torch.dtype``; bfloat16 needs no ``ml_dtypes``. Host numpy arrays
in bfloat16 (``ml_dtypes.bfloat16`` arrays from the JAX package, or raw
``.bin`` files) cross into torch through a 16-bit view.

Name mangling matches the converter and bindings: every non-alphanumeric
char c becomes "_%X_" % ord(c).
"""

from __future__ import annotations

import enum
import re
from typing import Optional

import numpy as np
import torch


class DType(enum.Enum):
    """Wire/compute data types (same members and values as the JAX package)."""

    none = "none"
    uint8 = "uint8"
    float16 = "float16"
    float32 = "float32"
    int64 = "int64"
    bfloat16 = "bfloat16"
    int8 = "int8"
    int32 = "int32"
    bool_ = "bool"

    @property
    def torch(self) -> torch.dtype:
        return _TORCH[self]

    @property
    def storage_np(self) -> np.dtype:
        """numpy dtype of the raw bytes (bfloat16 is stored as uint16)."""
        return _STORAGE_NP[self]

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self]

    @property
    def is_float(self) -> bool:
        return self in (DType.float16, DType.float32, DType.bfloat16)

    @staticmethod
    def from_np(dt) -> "DType":
        name = dtype_name(dt)
        for k in _TORCH:
            if k.value == name:
                return k
        raise ValueError(f"unsupported numpy dtype {dt!r}")


_TORCH = {
    DType.uint8: torch.uint8,
    DType.float16: torch.float16,
    DType.float32: torch.float32,
    DType.int64: torch.int64,
    DType.bfloat16: torch.bfloat16,
    DType.int8: torch.int8,
    DType.int32: torch.int32,
    DType.bool_: torch.bool,
}

_STORAGE_NP = {
    DType.uint8: np.dtype(np.uint8),
    DType.float16: np.dtype(np.float16),
    DType.float32: np.dtype(np.float32),
    DType.int64: np.dtype(np.int64),
    DType.bfloat16: np.dtype(np.uint16),
    DType.int8: np.dtype(np.int8),
    DType.int32: np.dtype(np.int32),
    DType.bool_: np.dtype(np.bool_),
}

_ITEMSIZE = {k: v.itemsize for k, v in _STORAGE_NP.items()}
_ITEMSIZE[DType.none] = 0

_BY_NAME = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def dtype_name(dt) -> str:
    """Canonical name ("float32", "bfloat16", "int64", "bool", ...) of a torch
    dtype, a numpy dtype (``ml_dtypes.bfloat16`` included) or a name."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    if isinstance(dt, str):
        return "bool" if dt == "bool_" else dt
    return str(np.dtype(dt))


def torch_dtype(dt) -> torch.dtype:
    """torch dtype for a torch dtype, numpy dtype or name."""
    if isinstance(dt, torch.dtype):
        return dt
    name = dtype_name(dt)
    if name not in _BY_NAME:
        raise ValueError(f"unsupported dtype {dt!r}")
    return _BY_NAME[name]


def to_torch(arr, device: Optional[torch.device] = None) -> torch.Tensor:
    """Host array (numpy, ``ml_dtypes.bfloat16`` included, or a torch tensor)
    -> torch tensor, moved to ``device`` when given. bfloat16 numpy arrays go
    through a uint16 view, so ``ml_dtypes`` is never imported."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(device)
    a = np.asarray(arr)
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(a.shape, dtype=torch_dtype(a.dtype), device="meta")
    if dtype_name(a.dtype) == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        # a copy keeps torch off read-only numpy buffers (weights, pins)
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t if device is None else t.to(device)


def to_numpy(t) -> np.ndarray:
    """Concrete torch tensor -> numpy. bfloat16 widens to float32 (numpy has
    no bfloat16 without ml_dtypes)."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def mangle_name(name: str) -> str:
    """ONNX tensor name -> model.txt-safe name (reference src/bindings.py:310)."""
    out = []
    for ch in name:
        if ch.isalnum():
            out.append(ch)
        else:
            out.append(f"_{ord(ch):X}_")
    return "".join(out)


_DEMANGLE_RE = re.compile(r"_([0-9A-Fa-f]+)_")


def demangle_name(name: str) -> str:
    """Inverse of mangle_name (reference src/bindings.py:320-329)."""

    def repl(match: re.Match) -> str:
        try:
            return chr(int(match.group(1), 16))
        except (ValueError, TypeError, OverflowError):
            return match.group(0)

    return _DEMANGLE_RE.sub(repl, name)

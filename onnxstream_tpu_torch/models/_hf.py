"""Shared helpers for the HuggingFace checkpoint converters.

Counterpart of ``onnxstream_tpu/models/_hf.py``.
"""

from __future__ import annotations

import numpy as np


def to_f32(t) -> np.ndarray:
    """torch tensor or array-like -> contiguous float32 ndarray."""
    if hasattr(t, "detach"):
        t = t.detach().to("cpu").float().numpy()
    return np.ascontiguousarray(np.asarray(t, np.float32))

"""Karras-style sigma schedule and k-diffusion scalings for SD.

Reproduces the reference's scheduler math exactly:

  * the 1000-entry ``log_sigmas`` table (reference src/sd.cpp:1593, baked as a
    literal there) is recomputed from the SD "scaled_linear" beta schedule:
    betas = linspace(sqrt(0.00085), sqrt(0.012), 1000)^2,
    sigma_t = sqrt((1 - prod(alpha)) / prod(alpha));
  * the step schedule: t = 999 + i * (-999/(steps-1)), linear interp of
    log-sigma, exp, with a trailing 0 (src/sd.cpp:1595-1610);
  * sigma_to_t and the c_in/c_out scalings of CFGDenoiser_CompVisDenoiser
    (src/sd.cpp:1397-1431).

Counterpart of ``onnxstream_tpu/models/sd/scheduler.py``: the same code, carried
here so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def log_sigmas() -> np.ndarray:
    # float64 betas/cumprod, alphas cast to float32, sigma/log in float32 —
    # bit-exact against the table baked into the reference (verified in
    # tests/test_sd_scheduler.py against src/sd.cpp's 1000 literals).
    betas = np.linspace(0.00085**0.5, 0.012**0.5, 1000, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    sigmas = np.sqrt((np.float32(1.0) - alphas_cumprod) / alphas_cumprod)
    return np.log(sigmas).astype(np.float32)


def sigma_schedule(steps: int) -> np.ndarray:
    """sigma[steps+1], last entry 0 (reference src/sd.cpp:1595-1610)."""
    ls = log_sigmas()
    delta = -999.0 / (steps - 1) if steps > 1 else 0.0
    sigma = np.empty(steps + 1, dtype=np.float32)
    for i in range(steps):
        t = 999.0 + i * delta
        low = int(math.floor(t))
        high = int(math.ceil(t))
        w = t - low
        sigma[i] = np.float32(math.exp((1 - w) * float(ls[low]) + w * float(ls[high])))
    sigma[steps] = 0.0
    return sigma


def sigma_to_t(sigma: float) -> float:
    """Continuous timestep for a sigma (reference src/sd.cpp:1403-1424)."""
    ls = log_sigmas()
    log_sigma = math.log(sigma)
    indicator = (log_sigma - ls) >= 0
    cum = np.cumsum(indicator.astype(np.float32))
    low_idx = min(int(np.argmax(cum)), 1000 - 2)
    high_idx = low_idx + 1
    low, high = float(ls[low_idx]), float(ls[high_idx])
    w = (low - log_sigma) / (low - high)
    w = max(0.0, min(1.0, w))
    return (1 - w) * low_idx + w * high_idx


def get_scalings(sigma: float) -> Tuple[float, float]:
    """(c_in, c_out) for the CompVis eps-parameterization (src/sd.cpp:1400-1401)."""
    c_out = -1.0 * sigma
    c_in = 1.0 / math.sqrt(sigma * sigma + 1.0)
    return c_in, c_out

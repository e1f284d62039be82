"""The sampler side of OnnxStream's ``sd``, from its description: the SD
"scaled_linear" noise schedule (1000 betas from sqrt(0.00085) to
sqrt(0.012), squared), k-diffusion's discrete sigma schedule over ``steps``
timesteps from 999 down to 0 with a trailing 0, sigma -> t by interpolation
in log sigma, the CompVis scalings c_in = 1 / sqrt(sigma^2 + 1) and c_out =
-sigma, and the euler / euler_a updates. Noise is OnnxStream's:
``std::mt19937`` seeded with the request seed mod 1000 for the starting
latents, and for euler_a's step i the seed ``rand() % 1000`` after glibc's
``srand(seed + i)``, each filled by libstdc++'s ``normal_distribution<float>``
(Marsaglia's polar method, one 32-bit draw per uniform, the second value of
each pair returned first)."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

TRAIN_STEPS = 1000


def log_sigmas() -> np.ndarray:
    betas = np.linspace(math.sqrt(0.00085), math.sqrt(0.012), TRAIN_STEPS, dtype=np.float64) ** 2
    alphas = np.cumprod(1.0 - betas)
    return np.log(np.sqrt((1.0 - alphas) / alphas))


def sigmas(steps: int) -> np.ndarray:
    """steps + 1 sigmas, the last 0."""
    ls = log_sigmas()
    t = np.linspace(TRAIN_STEPS - 1, 0, steps) if steps > 1 else np.array([TRAIN_STEPS - 1.0])
    out = np.exp(np.interp(t, np.arange(TRAIN_STEPS), ls))
    return np.append(out, 0.0)


def sigma_to_t(sigma: float) -> float:
    ls = log_sigmas()
    return float(np.interp(math.log(sigma), ls, np.arange(TRAIN_STEPS)))


def scalings(sigma: float) -> Tuple[float, float]:
    """(c_in, c_out)."""
    return 1.0 / math.sqrt(sigma * sigma + 1.0), -sigma


def ancestral(s_cur: float, s_next: float) -> Tuple[float, float]:
    """euler_a's (sigma_up, sigma_down) for eta 1."""
    up = min(s_next, math.sqrt(s_next ** 2 * (s_cur ** 2 - s_next ** 2) / s_cur ** 2))
    return up, math.sqrt(max(0.0, s_next ** 2 - up ** 2))


def glibc_rand(seed: int) -> int:
    """The first ``rand()`` after ``srand(seed)`` in glibc (its TYPE_3
    additive-feedback generator)."""
    s = seed & 0xFFFFFFFF or 1
    r: List[int] = [s]
    for i in range(1, 31):
        r.append((16807 * r[i - 1]) % 2147483647)
    r += [r[i - 31] for i in range(31, 34)]
    for i in range(34, 345):
        r.append((r[i - 31] + r[i - 3]) & 0xFFFFFFFF)
    return r[344] >> 1


def mt19937_normal(seed: int, n: int) -> np.ndarray:
    """n float32 values of libstdc++'s normal_distribution<float> over
    std::mt19937(seed)."""
    bits = np.random.MT19937()
    bits._legacy_seeding(seed & 0xFFFFFFFF)  # init_genrand, as std::mt19937's constructor
    out = np.empty(0, np.float32)
    two, one = np.float32(2.0), np.float32(1.0)
    while out.size < n:
        m = (n - out.size) // 2 + 64
        u = bits.random_raw(2 * m).astype(np.float32) / np.float32(4294967296.0)
        u = np.minimum(u, np.nextafter(one, np.float32(0)))
        x, y = two * u[0::2] - one, two * u[1::2] - one
        r2 = x * x + y * y
        keep = (r2 <= one) & (r2 != 0)
        x, y, r2 = x[keep], y[keep], r2[keep]
        mult = np.sqrt(np.float32(-2.0) * np.log(r2) / r2).astype(np.float32)
        pairs = np.empty(2 * x.size, np.float32)
        pairs[0::2], pairs[1::2] = y * mult, x * mult
        out = np.concatenate([out, pairs])
    return out[:n]


def latent_noise(seed: int, channels: int, h: int, w: int) -> np.ndarray:
    return mt19937_normal(seed, channels * h * w).reshape(channels, h, w)


def start_latents(seed: int, channels: int, h: int, w: int, steps: int) -> np.ndarray:
    return latent_noise(seed % 1000, channels, h, w) * np.float32(sigmas(steps)[0])


def step_noise(seed: int, i: int, channels: int, h: int, w: int) -> np.ndarray:
    return latent_noise(glibc_rand(seed + i) % 1000, channels, h, w)

"""The 22 diffusion samplers (reference src/samplers.h:1-1478).

Same sampler set, same math, same noise protocol as the reference (the
ORIGINAL_SAMPLER_ALGORITHMS branches), operating on float32 numpy latents of
shape (4, h, w):

  * multi-stage samplers (heun, dpm2, dpm++2s/2s_a) call the denoiser again
    through ``denoise_fn`` — a plain callback instead of the reference's C++20
    coroutine trick (src/sd.cpp:1031-1161), since batching here is a real
    array dimension, not interleaved control flow;
  * ancestral samplers draw noise via ``std::srand(seed++); rand() % 1000``
    feeding ``randn_4_w_h`` — reproduced bit-exactly by models/sd/rng.py;
  * turbo sigma reshaping (sigma_reshaper / sigma_reshaper_sharp,
    src/samplers.h:96-113) and DDIM/TCD latent prescaling
    (src/samplers.h:27-71) are reproduced verbatim.

Counterpart of ``onnxstream_tpu/models/sd/samplers.py``: the same code, carried
here so the port needs nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np

from onnxstream_tpu_torch.models.sd.rng import GlibcRand, randn_4_w_h

SAMPLERS = [
    "euler_a",
    "euler",
    "heun",
    "dpm2",
    "dpm++2m",
    "dpm++2mv2",
    "dpm++2s",
    "dpm++2s_a",
    "dpm++3msde",
    "dpm++3msde_a",
    "ipndm",
    "ipndm_v",
    "ipndm_vo",
    "taylor3",
    "ddpm",
    "ddpm_a",
    "ddim",
    "ddim_a",
    "tcd",
    "tcd_a",
    "lms",
    "lcm",
]

_HISTORY = {
    "ipndm": 4, "ipndm_v": 4, "ipndm_vo": 4, "lms": 4,
    "taylor3": 3, "dpm++3msde": 3, "dpm++3msde_a": 3,
    "heun": 2,
    "dpm++2s": 1, "dpm++2s_a": 1, "dpm++2m": 1, "dpm++2mv2": 1, "dpm2": 1,
}

DenoiseFn = Callable[[np.ndarray, float], np.ndarray]


class SamplerState:
    """Per-image sampler state (history buffers, seed counter, eta)."""

    def __init__(self, sampler: str, steps: int, seed: int, turbo: bool = False):
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; one of {SAMPLERS}")
        self.sampler = sampler
        self.steps = steps
        self.seed = seed
        self.turbo = turbo
        self.history: List[Optional[np.ndarray]] = [None] * _HISTORY.get(sampler, 0)
        self.history_dt = 0.0
        self.eta = 0.0  # reference src/sd.cpp:1688

    # noise protocol: std::srand(seed++); randn_4_w_h(rand() % 1000, w, h)
    def noise(self, w: int, h: int) -> np.ndarray:
        r = GlibcRand(self.seed)
        self.seed += 1
        return randn_4_w_h(r.rand() % 1000, w, h)


def _reshaper(si1: float, i: int, steps: int, turbo: bool) -> float:
    """Turbo sigma curve (reference src/samplers.h:96-106); identity otherwise."""
    if not turbo:
        return si1
    p = 0.0
    e = math.pow(2.0, -p - 0.5) / steps
    curve = (math.pow((steps - i) / steps, e) + math.pow((i + 1) / steps, e)) / 2
    return si1 * (max(0.0001, curve) if curve else 0.0)


def _reshaper_sharp(si1: float, i: int, steps: int, turbo: bool) -> float:
    """src/samplers.h:108-113."""
    pre = _reshaper(si1, i, steps, turbo)
    if pre == si1:
        return si1
    smooth = 3.0 / (steps - 2.5)
    return si1 + (smooth / abs(smooth)) * (abs(smooth) ** (1.0 / 3)) * (pre - si1)


def prescale_sample(x: np.ndarray, sampler: str, steps: int, i: int, sigma: np.ndarray, turbo: bool) -> np.ndarray:
    """DDIM/TCD latent prescaling before the denoiser (src/samplers.h:27-63)."""
    if sampler not in ("ddim", "ddim_a", "tcd", "tcd_a"):
        return x
    si = float(sigma[i])
    if i == 0:
        return x * np.float32(math.sqrt(si * si + 1) / si)
    scale = math.sqrt(si * si + 1)
    if turbo:
        scale = scale ** (0.9925 - 2.5 / steps / steps)
    return x * np.float32(scale)


def _ancestral_sigmas(s_cur: float, s_next: float) -> tuple:
    up = min(s_next, math.sqrt(s_next * s_next * (s_cur * s_cur - s_next * s_next) / (s_cur * s_cur))) if s_cur else 0.0
    down = math.sqrt(max(0.0, s_next * s_next - up * up))
    return up, down


def sampler_step(
    state: SamplerState,
    x: np.ndarray,
    denoised: np.ndarray,
    sigma: np.ndarray,
    i: int,
    denoise_fn: DenoiseFn,
) -> np.ndarray:
    """One sampler update. x, denoised: (4, h, w) float32. Returns new x.

    ``denoise_fn(x, sigma)`` is only called by the multi-stage samplers.
    """
    x = np.asarray(x, np.float32)
    denoised = np.asarray(denoised, np.float32)
    s = state.sampler
    steps, turbo = state.steps, state.turbo
    hist = state.history
    s_cur = float(sigma[i])
    h_, w_ = x.shape[1], x.shape[2]

    def rsh(v, idx=None):
        return _reshaper(v, i if idx is None else idx, steps, turbo)

    def rsh_sharp(v):
        return _reshaper_sharp(v, i, steps, turbo)

    if s == "euler":
        si1 = rsh(float(sigma[i + 1]))
        return x + (x - denoised) / np.float32(s_cur) * np.float32(si1 - s_cur)

    if s == "euler_a":
        up, down = _ancestral_sigmas(s_cur, float(sigma[i + 1]))
        noise = state.noise(w_, h_)
        return x + ((x - denoised) / np.float32(s_cur)) * np.float32(down - s_cur) + noise * np.float32(up)

    if s == "heun":
        si1 = rsh(float(sigma[i + 1]))
        dt = si1 - s_cur
        d = (x - denoised) / np.float32(s_cur)
        if not si1:
            return x + d * np.float32(dt)
        x2 = x + d * np.float32(dt)
        den2 = denoise_fn(x2, si1)
        d2 = (x2 - den2) / np.float32(si1)
        return x + (d + d2) / 2 * np.float32(dt)

    if s == "dpm2":
        si1 = rsh(float(sigma[i + 1]))
        if not si1:
            return denoised.copy()
        sigma_mid = math.exp(0.5 * (math.log(s_cur) + math.log(si1)))
        dt_1 = sigma_mid - s_cur
        dt_2 = si1 - s_cur
        d = (x - denoised) / np.float32(s_cur)
        x2 = x + d * np.float32(dt_1)
        den2 = denoise_fn(x2, sigma_mid)
        d2 = (x2 - den2) / np.float32(sigma_mid)
        return x + d2 * np.float32(dt_2)

    if s == "dpm++2s":
        si1 = rsh(float(sigma[i + 1]))
        if not si1:
            return denoised.copy()
        a = si1 / s_cur
        b = math.sqrt(a)
        x2 = denoised + np.float32(b) * (x - denoised)
        den2 = denoise_fn(x2, float(sigma[i + 1]))
        return den2 + np.float32(a) * (x2 - den2)

    if s == "dpm++2s_a":
        si1 = float(sigma[i + 1])
        up, down = _ancestral_sigmas(s_cur, si1)
        if not down:
            out = denoised.copy()
        else:
            t = -math.log(s_cur)
            t_next = -math.log(down)
            h = t_next - t
            s_mid = t + 0.5 * h
            k1 = math.exp(-s_mid) / math.exp(-t)
            x2 = np.float32(k1) * x - np.float32(math.expm1(-h * 0.5)) * denoised
            den2 = denoise_fn(x2, si1)
            k2 = math.exp(-t_next) / math.exp(-t)
            out = np.float32(k2) * x - np.float32(math.expm1(-h)) * den2
        if si1 > 0:
            out = out + state.noise(w_, h_) * np.float32(up)
        return out

    if s in ("dpm++2m", "dpm++2mv2"):
        v2 = s == "dpm++2mv2"
        si1 = rsh_sharp(float(sigma[i + 1])) if v2 else rsh(float(sigma[i + 1]))
        old = hist[0]
        if i == 0 or not si1:
            a = si1 / s_cur
            b = math.expm1(math.log(si1) - math.log(s_cur)) if si1 else -1.0
            out = np.float32(a) * x - np.float32(b) * denoised
        else:
            t = -math.log(s_cur)
            t_next = -math.log(si1)
            h = t_next - t
            a = si1 / s_cur
            if v2:
                h_last = t + math.log(float(sigma[i - 1]))
                h_min = min(h_last, h)
                h_max = max(h_last, h)
                r = h_max / h_min
                b = math.expm1(-(h_max + h_min) / 2)
            else:
                h_last = t + math.log(float(sigma[i - 1]))
                r = h_last / h
                b = math.expm1(-h)
            d = np.float32(1 + 1 / (2 * r)) * denoised - np.float32(1 / (2 * r)) * old
            out = np.float32(a) * x - np.float32(b) * d
        hist[0] = denoised.copy()
        return out

    if s in ("dpm++3msde", "dpm++3msde_a"):
        if s == "dpm++3msde_a":
            state.eta = 1.0 if not turbo else 0.5
        eta = state.eta
        if i:
            hist[2] = hist[1]
            hist[1] = hist[0]
        # double-corrected sigmas (reference src/samplers.h:425-432)
        si1 = rsh(float(sigma[i + 1]), i)
        si0 = 1.0 if i == 0 else rsh(float(sigma[i]), i - 1)
        sm1 = 1.0 if i <= 1 else rsh(float(sigma[i - 1]), i - 2)
        si1 = (si1 + rsh(si1, i)) / 2
        si0 = (si0 + (1.0 if i == 0 else rsh(si0, i - 1))) / 2
        sm1 = (sm1 + (1.0 if i <= 1 else rsh(sm1, i - 2))) / 2
        d = denoised
        hist[0] = d.copy()
        if not si1:
            out = d.copy()
        elif i > 1:
            h = math.log(s_cur) - math.log(si1)
            h_1 = math.log(float(sigma[i - 1])) - math.log(si0)
            h_2 = math.log(float(sigma[i - 2])) - math.log(sm1)
            h_eta = h * (eta + 1)
            out = np.float32(math.exp(-h_eta)) * x - np.float32(math.expm1(-h_eta)) * d
            r = h_1 / h
            r2 = h_2 / h
            d1_0 = (d - hist[1]) / np.float32(r)
            d1_1 = (hist[1] - hist[2]) / np.float32(r2)
            d1 = d1_0 + (d1_0 - d1_1) * np.float32(r / (r + r2))
            d2 = (d1_0 - d1_1) / np.float32(r + r2)
            phi_2 = math.expm1(-h_eta) / h_eta + 1
            phi_3 = phi_2 / h_eta - 0.5
            out = out + np.float32(phi_2) * d1 - np.float32(phi_3) * d2
        elif i:
            h = math.log(s_cur) - math.log(si1)
            h_1 = math.log(float(sigma[i - 1])) - math.log(si0)
            h_eta = h * (eta + 1)
            out = np.float32(math.exp(-h_eta)) * x - np.float32(math.expm1(-h_eta)) * d
            r = h_1 / h
            phi_2 = math.expm1(-h_eta) / h_eta + 1
            out = out + np.float32(phi_2) * ((d - hist[1]) / np.float32(r))
        else:
            h = math.log(s_cur) - math.log(si1)
            h_eta = h * (eta + 1)
            out = np.float32(math.exp(-h_eta)) * x - np.float32(math.expm1(-h_eta)) * d
        if eta and si1:
            variance = si1 * math.sqrt(max(0.0, 1 - (si1 / s_cur) ** (2 * eta)))
            out = out + state.noise(w_, h_) * np.float32(variance)
        return out

    if s in ("ipndm", "ipndm_v", "ipndm_vo"):
        si1 = rsh(float(sigma[i + 1]))
        if i:
            hist[3] = hist[2]
            hist[2] = hist[1]
            hist[1] = hist[0]
        d = (x - denoised) / np.float32(s_cur)
        hist[0] = d.copy()
        h_n = si1 - s_cur
        if i == 0:
            return x + np.float32(h_n) * d
        if s == "ipndm":
            if i == 1:
                return x + np.float32(h_n) * (3 * d - hist[1]) / 2
            if i == 2:
                return x + np.float32(h_n) * (23 * d - 16 * hist[1] + 5 * hist[2]) / 12
            return x + np.float32(h_n) * (55 * d - 59 * hist[1] + 37 * hist[2] - 9 * hist[3]) / 24
        h_n_1 = s_cur - float(sigma[i - 1])
        if s == "ipndm_v":
            if i == 1:
                return x + np.float32(h_n) * (np.float32(2 + h_n / h_n_1) * d - np.float32(h_n / h_n_1) * hist[1]) / 2
            if i == 2:
                return x + np.float32(h_n) * (23 * d - 16 * hist[1] + 5 * hist[2]) / 12
            return x + np.float32(h_n) * (55 * d - 59 * hist[1] + 37 * hist[2] - 9 * hist[3]) / 24
        # ipndm_vo (variable-step iPNDM, reference src/samplers.h:763-858)
        if i == 1:
            c1 = (2 + h_n / h_n_1) / 2
            c2 = -(h_n / h_n_1) / 2
            return x + np.float32(h_n) * (np.float32(c1) * d + np.float32(c2) * hist[1])
        h_n_2 = float(sigma[i - 1]) - float(sigma[i - 2])
        if i == 2:
            temp = (1 - h_n / (3 * (h_n + h_n_1)) * (h_n * (h_n + h_n_1)) / (h_n_1 * (h_n_1 + h_n_2))) / 2
            c1 = (2 + h_n / h_n_1) / 2 + temp
            c2 = -(h_n / h_n_1) / 2 - (1 + h_n_1 / h_n_2) * temp
            c3 = temp * h_n_1 / h_n_2
            return x + np.float32(h_n) * (np.float32(c1) * d + np.float32(c2) * hist[1] + np.float32(c3) * hist[2])
        h_n_3 = float(sigma[i - 2]) - float(sigma[i - 3])
        t1 = (1 - h_n / (3 * (h_n + h_n_1)) * (h_n * (h_n + h_n_1)) / (h_n_1 * (h_n_1 + h_n_2))) / 2
        t2 = (
            (1 - h_n / (3 * (h_n + h_n_1))) / 2
            + (1 - h_n / (2 * (h_n + h_n_1))) * h_n / (6 * (h_n + h_n_1 + h_n_2))
        ) * (h_n * (h_n + h_n_1) * (h_n + h_n_1 + h_n_2)) / (h_n_1 * (h_n_1 + h_n_2) * (h_n_1 + h_n_2 + h_n_3))
        c1 = (2 + h_n / h_n_1) / 2 + t1 + t2
        c2 = -(h_n / h_n_1) / 2 - (1 + h_n_1 / h_n_2) * t1 - (
            1 + (h_n_1 / h_n_2) + (h_n_1 * (h_n_1 + h_n_2) / (h_n_2 * (h_n_2 + h_n_3)))
        ) * t2
        c3 = t1 * h_n_1 / h_n_2 + (
            (h_n_1 / h_n_2) + (h_n_1 * (h_n_1 + h_n_2) / (h_n_2 * (h_n_2 + h_n_3))) * (1 + h_n_2 / h_n_3)
        ) * t2
        c4 = -t2 * (h_n_1 * (h_n_1 + h_n_2) / (h_n_2 * (h_n_2 + h_n_3))) * h_n_1 / h_n_2
        return x + np.float32(h_n) * (
            np.float32(c1) * d + np.float32(c2) * hist[1] + np.float32(c3) * hist[2] + np.float32(c4) * hist[3]
        )

    if s == "taylor3":
        si1 = rsh_sharp(float(sigma[i + 1]))
        dt = si1 - s_cur
        if i:
            hist[2] = hist[1]
            hist[1] = hist[0]
        d = (x - denoised) / np.float32(s_cur)
        hist[0] = d.copy()
        if i == 0:
            out = x + np.float32(dt) * d
        else:
            idtp = 1.0 / state.history_dt
            f2 = dt * dt / 2
            d2 = (d - hist[1]) * np.float32(idtp)
            if i == 1:
                out = x + np.float32(dt) * d + np.float32(f2) * d2
            else:
                f3 = dt * dt * dt / 6
                d3 = (d2 - hist[2]) * np.float32(idtp)
                out = x + np.float32(dt) * d + np.float32(f2) * d2 + np.float32(f3) * d3
        # history stores d2 for the next step's d3 computation? The reference
        # stores derivatives d in buffers and recomputes d2/d3 from them.
        state.history_dt = dt
        return out

    if s in ("ddpm", "ddpm_a"):
        eta = 1.0 if s == "ddpm_a" else state.eta
        s2 = s_cur * s_cur
        sn2 = float(sigma[i + 1]) ** 2
        scale_back = math.sqrt(s2 + 1.0)
        dq = math.sqrt(sn2 + 1.0)
        variance = 0.0 if eta <= 0 else eta * math.sqrt(s2 - sn2) / dq * float(sigma[i + 1]) / s_cur
        a = sn2 / s2 * scale_back / dq
        b = (s2 - sn2) / dq / s2
        out = x * np.float32(a) + denoised * np.float32(b)
        if variance > 0:
            out = out + state.noise(w_, h_) * np.float32(variance)
        return out

    if s == "ddim":
        si1 = rsh_sharp(float(sigma[i + 1]))
        sn2 = si1 * si1  # double in the reference
        alpha_prod_t_prev = 1.0 / (sn2 + 1.0)
        a = math.sqrt(1.0 - alpha_prod_t_prev) / s_cur
        b = math.sqrt(alpha_prod_t_prev) - a
        return x * np.float32(a) + denoised * np.float32(b)

    if s == "ddim_a":
        eta = 1.0
        si1 = rsh_sharp(float(sigma[i + 1]))
        alpha_prod_t = 1.0 / (s_cur * s_cur + 1.0)
        alpha_prod_t_prev = 1.0 / (si1 * si1 + 1.0)
        beta_prod_t = 1.0 - alpha_prod_t
        variance = ((1.0 - alpha_prod_t_prev) / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_t_prev)
        std_dev_t = eta * math.sqrt(max(0.0, variance))
        model_output = (x - denoised) / np.float32(s_cur)
        pred_orig = (x * np.float32(math.sqrt(alpha_prod_t)) - model_output * np.float32(math.sqrt(beta_prod_t))) / np.float32(
            math.sqrt(alpha_prod_t)
        )
        direction = model_output * np.float32(math.sqrt(1.0 - alpha_prod_t_prev - variance * eta * eta))
        out = np.float32(math.sqrt(alpha_prod_t_prev)) * pred_orig + direction
        if eta > 0:
            out = out + state.noise(w_, h_) * np.float32(std_dev_t)
        return out

    if s in ("tcd", "tcd_a"):
        eta = 0.5 if s == "tcd_a" else state.eta
        si = s_cur
        si1 = rsh_sharp(float(sigma[i + 1]))
        si4 = si1 * (1.0 - eta)
        si3 = float(sigma[int((steps - i - 1) * eta) + i + 1])
        inner = si3 * (si1 / float(sigma[i + 1])) if float(sigma[i + 1]) else si3
        si2 = math.sqrt(math.sqrt(si3 * inner) * math.sqrt(si4 * math.sqrt(si3 * si4))) if si3 * si4 >= 0 else 0.0
        alpha_n = 1.0 / (si1 * si1 + 1.0)
        alpha_s = 1.0 / (si2 * si2 + 1.0)
        alpha = 1.0 / (si * si + 1.0)
        beta = 1.0 - alpha
        beta_s = 1.0 - alpha_s
        model_output = (x - denoised) / np.float32(si)
        pred_orig = x - np.float32(math.sqrt(beta) / math.sqrt(alpha)) * model_output
        out = np.float32(math.sqrt(alpha_s)) * pred_orig + np.float32(math.sqrt(beta_s)) * model_output
        if eta > 0 and i < steps - 1:
            a = math.sqrt(alpha_n / alpha_s)
            b = math.sqrt(max(0.0, 1.0 - alpha_n / alpha_s))
            out = np.float32(a) * out + np.float32(b) * state.noise(w_, h_)
        return out

    if s == "lms":
        if i:
            hist[3] = hist[2]
            hist[2] = hist[1]
            hist[1] = hist[0]
        order = min(i + 1, 4)
        coeffs = [_lms_coeff(order, i, j, sigma, steps, turbo) for j in range(order)]
        d = (x - denoised) / np.float32(s_cur)
        hist[0] = d.copy()
        out = x + d * np.float32(coeffs[0])
        for j in range(1, order):
            out = out + hist[j] * np.float32(coeffs[j])
        return out

    if s == "lcm":
        sigma_next = float(sigma[i + 1])
        if sigma_next <= 0:
            return denoised.copy()
        return denoised + np.float32(sigma_next) * state.noise(w_, h_)

    raise AssertionError(s)


def _lms_coeff(order: int, m: int, j: int, sigma: np.ndarray, steps: int, turbo: bool) -> float:
    """Integral of the Lagrange basis polynomial over [sigma_m, sigma_{m+1}]
    — the reference mixes seven numeric integrators (src/samplers.h LMS);
    we integrate the degree<=3 polynomial exactly instead (the reference's
    integrator mix converges to this value)."""
    import numpy.polynomial.polynomial as P

    s0 = float(sigma[m])
    s1 = _reshaper(float(sigma[m + 1]), m, steps, turbo)
    # product over k != j of (tau - sigma[m-k]) / (sigma[m-j] - sigma[m-k])
    num = np.array([1.0])
    denom = 1.0
    for k in range(order):
        if k == j:
            continue
        num = P.polymul(num, np.array([-float(sigma[m - k]), 1.0]))
        denom *= float(sigma[m - j]) - float(sigma[m - k])
    integ = P.polyint(num)
    val = (P.polyval(s1, integ) - P.polyval(s0, integ)) / denom
    return float(val)

"""Bit-exact reimplementations of the C++ RNGs the reference samplers use.

Latents equality with the reference (its golden-latents cross-machine check,
reference src/sd.cpp:2325-2328 / SURVEY.md section 4) requires reproducing:

  * glibc ``rand()`` after ``srand(seed)`` — the additive-feedback TYPE_3
    generator (used as ``std::srand(seed++); rand() % 1000`` to pick noise
    seeds, reference src/samplers.h ancestral samplers);
  * ``std::mt19937`` — standardized, straightforward;
  * libstdc++ ``std::normal_distribution<float>`` — Marsaglia polar method
    with a one-value cache, canonicals from one 32-bit draw each
    (reference src/sd.cpp:1366-1385 ``randn_4_w_h``).

All three are verified against a g++-compiled oracle in
tests/test_sd_rng.py.

Counterpart of ``onnxstream_tpu/models/sd/rng.py``: the same code, carried
here so the port needs nothing of the JAX package. ``randn_4_w_h`` itself
calls libstdc++'s generators (``models/sd/csrc/randn.cpp``, built with g++
at first use by ``runtime/native.py``): the Python polar method makes one
ctypes ``logf`` call a value, which made the seeded noise the largest host
cost of an image's device loop; the classes here give the same bits
(tests/test_torch_sd_scan.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import List

import numpy as np

_U32 = 0xFFFFFFFF

# glibc logf — numpy's float32 log differs from libm's by 1 ulp on some inputs,
# which is enough to break bit-exact parity with the C++ reference samplers.
try:
    _libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    _libm.logf.restype = ctypes.c_float
    _libm.logf.argtypes = [ctypes.c_float]

    def _logf(x: np.float32) -> np.float32:
        return np.float32(_libm.logf(ctypes.c_float(float(x))))

except Exception:  # pragma: no cover - fall back to numpy (1-ulp tolerance)

    def _logf(x: np.float32) -> np.float32:
        return np.float32(np.log(np.float32(x)))


class GlibcRand:
    """glibc rand(): TYPE_3 additive feedback (r_new = r[-31] + r[-3] >> 1)."""

    def __init__(self, seed: int):
        seed = seed & _U32
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647, via the Schrage trick signs
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & _U32
        self._r = r
        self._idx = 344

    def rand(self) -> int:
        r = self._r
        r.append((r[-31] + r[-3]) & _U32)
        return r[-1] >> 1


class MT19937:
    """std::mt19937 (32-bit Mersenne Twister, standard parameters)."""

    def __init__(self, seed: int):
        mt = np.empty(624, dtype=np.uint64)
        mt[0] = seed & _U32
        for i in range(1, 624):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & _U32
        self.mt = mt
        self.idx = 624

    def _generate(self) -> None:
        # Vectorized twist. mt[(i+397)%624] reads ALREADY-UPDATED entries for
        # i >= 227 (and i=623's y-term reads updated mt[0]), so the update
        # runs in dependency-ordered chunks: [0,227) sees only old state;
        # [227,454) needs new[0:227]; [454,623) needs new[227:396]; i=623
        # needs new[0] and new[396]. Bit-exact vs the scalar loop (the
        # compiled-oracle tests cover full-period blocks).
        mt = self.mt
        old = mt.copy()
        upper = np.uint64(0x80000000)
        lower = np.uint64(0x7FFFFFFF)
        magic = np.uint64(0x9908B0DF)
        one = np.uint64(1)

        def twist(y, x397):
            nxt = x397 ^ (y >> one)
            return np.where((y & one).astype(bool), nxt ^ magic, nxt)

        y = (old[0:227] & upper) | (old[1:228] & lower)
        mt[0:227] = twist(y, old[397:624])
        y = (old[227:454] & upper) | (old[228:455] & lower)
        mt[227:454] = twist(y, mt[0:227])
        y = (old[454:623] & upper) | (old[455:624] & lower)
        mt[454:623] = twist(y, mt[227:396])
        y = (old[623] & upper) | (mt[0] & lower)
        mt[623] = twist(np.uint64(y).reshape(1), mt[396].reshape(1))[0]
        self.idx = 0

    def next_block(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        got = 0
        while got < n:
            if self.idx >= 624:
                self._generate()
            take = min(624 - self.idx, n - got)
            y = self.mt[self.idx : self.idx + take].copy()
            y ^= y >> np.uint64(11)
            y ^= (y << np.uint64(7)) & np.uint64(0x9D2C5680)
            y ^= (y << np.uint64(15)) & np.uint64(0xEFC60000)
            y ^= y >> np.uint64(18)
            out[got : got + take] = y.astype(np.uint32)
            self.idx += take
            got += take
        return out

    def __call__(self) -> int:
        return int(self.next_block(1)[0])


class NormalDistributionFloat:
    """libstdc++ std::normal_distribution<float> over an mt19937.

    Marsaglia polar method; each canonical uses ONE 32-bit draw:
    u = float(long double(x) / 2^32) (generate_canonical<float,24,mt19937>).
    Saves x*mult, returns y*mult first.
    """

    def __init__(self, gen: MT19937):
        self.gen = gen
        self._saved: float | None = None
        # FIFO of 32-bit draws taken from `gen` in blocks but not yet
        # consumed by the polar loop: keeps the consumed-draw sequence
        # IDENTICAL to the scalar C++ loop across fill()/__call__ mixes even
        # though we over-draw for vectorization.
        self._ubuf = np.empty(0, dtype=np.uint32)

    _ONE = np.float32(1.0)
    _TWO = np.float32(2.0)
    _NEG2 = np.float32(-2.0)
    _R = np.float32(4294967296.0)

    def _take_u32(self, n: int) -> np.ndarray:
        if self._ubuf.size >= n:
            out, self._ubuf = self._ubuf[:n], self._ubuf[n:]
            return out
        if self._ubuf.size:
            out = np.concatenate([self._ubuf, self.gen.next_block(n - self._ubuf.size)])
            self._ubuf = np.empty(0, dtype=np.uint32)
            return out
        return self.gen.next_block(n)

    def _canonical(self) -> np.float32:
        # generate_canonical<float,24,mt19937>: float(x) / float(2^32)
        return np.float32(np.float32(self._take_u32(1)[0]) / self._R)

    def __call__(self) -> np.float32:
        if self._saved is not None:
            v, self._saved = self._saved, None
            return v
        while True:
            x = np.float32(self._TWO * self._canonical() - self._ONE)
            y = np.float32(self._TWO * self._canonical() - self._ONE)
            r2 = np.float32(x * x + y * y)
            if not (r2 > self._ONE or r2 == np.float32(0.0)):
                break
        mult = np.float32(np.sqrt(np.float32(self._NEG2 * _logf(r2) / r2)))
        self._saved = np.float32(x * mult)
        return np.float32(y * mult)

    def fill(self, n: int) -> np.ndarray:
        """Vectorized fill, bit-identical to n scalar __call__s.

        The polar loop consumes canonicals strictly in aligned pairs (both
        rejection and acceptance take exactly two), so the accepted pairs of
        the draw stream — in order — are exactly what the scalar loop
        accepts. Everything except logf is IEEE elementwise arithmetic
        (identical vectorized); logf stays the per-element libm call
        (see _logf: numpy's float32 log is 1 ulp off on some inputs).
        Over-drawn pairs beyond the n-th output are pushed back to _ubuf so
        the stream position stays exact."""
        out = np.empty(n, dtype=np.float32)
        k = 0
        if self._saved is not None and n > 0:
            out[0] = self._saved
            self._saved = None
            k = 1
        while k < n:
            need_pairs = (n - k + 1) // 2
            m = need_pairs + (need_pairs >> 2) + 16  # ~pi/4 acceptance
            u32 = self._take_u32(2 * m)
            u = u32.astype(np.float32) / self._R
            x = self._TWO * u[0::2] - self._ONE
            y = self._TWO * u[1::2] - self._ONE
            r2 = x * x + y * y
            acc = ~((r2 > self._ONE) | (r2 == np.float32(0.0)))
            idx = np.nonzero(acc)[0]
            if idx.size >= need_pairs:
                last = int(idx[need_pairs - 1])
                # draws after the pair that completes the fill were never
                # consumed by the scalar loop: return them to the buffer
                self._ubuf = np.concatenate([u32[2 * (last + 1):], self._ubuf])
                idx = idx[:need_pairs]
            xa, ya, r2a = x[idx], y[idx], r2[idx]
            logs = np.empty_like(r2a)
            for i in range(logs.size):
                logs[i] = _logf(r2a[i])
            mult = np.sqrt(self._NEG2 * logs / r2a)
            pairs = np.empty(2 * idx.size, dtype=np.float32)
            pairs[0::2] = ya * mult
            pairs[1::2] = xa * mult
            take = min(pairs.size, n - k)
            out[k : k + take] = pairs[:take]
            k += take
            if take < pairs.size:
                self._saved = np.float32(pairs[take])
        return out


_RANDN = None


def randn_4_w_h(seed: int, w: int, h: int) -> np.ndarray:
    """Reference randn_4_w_h (src/sd.cpp:1366-1385): mt19937(seed) filling a
    (4, h, w) float32 normal tensor in channel-major order, by libstdc++
    (``NormalDistributionFloat(MT19937(seed)).fill(4 * w * h)``'s bits)."""
    global _RANDN
    if _RANDN is None:
        from onnxstream_tpu_torch.runtime.native import randn_library

        lib = ctypes.CDLL(str(randn_library()))
        lib.ostt_randn.restype = None
        lib.ostt_randn.argtypes = [ctypes.c_uint32, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        _RANDN = lib.ostt_randn
    out = np.empty(4 * w * h, np.float32)
    _RANDN(seed & _U32, out.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(4, h, w)

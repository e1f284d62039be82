"""The yardstick of shares of the card's peak: NVIDIA H100 SXM data-sheet
rates (dense, without sparsity, at the 700 W limit), and the operations and
bytes of an attention call counted from its shapes."""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


@dataclasses.dataclass(frozen=True)
class AttentionSite:
    """One attention call: batch b, heads h, m queries over n keys, head dim
    d, ``calls`` calls a request, operands of ``itemsize`` bytes."""

    b: int
    h: int
    m: int
    n: int
    d: int
    calls: int = 1
    itemsize: int = 2

    @property
    def ops(self) -> float:
        """Two products (q k^T and p v), two operations a multiply-add."""
        return 4.0 * self.b * self.h * self.m * self.n * self.d

    @property
    def bytes(self) -> float:
        """q and the output once each (m rows), k and v once each (n rows)."""
        return float(self.itemsize * self.b * self.h * self.d * (2 * self.m + 2 * self.n))


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for bf16 work: operations over the
    peak rate or bytes over the memory rate, whichever is larger."""
    return max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)

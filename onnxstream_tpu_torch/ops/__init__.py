"""Operator registry and evaluation context.

Counterpart of ``onnxstream_tpu/ops/__init__.py``. Each op implementation is
a function ``impl(ctx, op, ins) -> [outputs]`` where ``ins`` holds ``None``
for absent optional inputs, numpy arrays for statically known values, and
torch tensors for device values. The same bodies serve three callers:

  * the planner's shape inference, on ``meta`` tensors (no data);
  * host folding (``OpImpl.host``), on CPU tensors made from numpy;
  * the executor, on tensors on ``SessionConfig.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import to_numpy, to_torch


class StaticRequired(Exception):
    """Raised by Ctx.static when an op needs input i as a host value.

    The planner catches this, loads the corresponding weight eagerly (pinning
    it host-side) and retries the op.
    """

    def __init__(self, index: int, what: str = ""):
        super().__init__(f"input {index} must be statically known ({what})")
        self.index = index
        self.what = what


@dataclasses.dataclass
class OpImpl:
    fn: Callable
    host: bool = False  # foldable on host when all inputs are static
    # put in by the sharding pass (parallel/spmd.py), never read from a
    # model.txt: left out of registered_ops()
    internal: bool = False


_REGISTRY: Dict[str, OpImpl] = {}


def register(op_type: str, host: bool = False, internal: bool = False):
    def deco(fn):
        _REGISTRY[op_type] = OpImpl(fn=fn, host=host, internal=internal)
        return fn

    return deco


def get_impl(op_type: str) -> OpImpl:
    impl = _REGISTRY.get(op_type)
    if impl is None:
        raise NotImplementedError(f"operator {op_type!r} is not implemented in onnxstream_tpu_torch")
    return impl


def registered_ops() -> List[str]:
    """The op types a model.txt may hold."""
    return sorted(k for k, v in _REGISTRY.items() if not v.internal)


class Ctx:
    """Per-evaluation context handed to op impls."""

    def __init__(self, mode: str, config=None, op_name: str = "",
                 device: Optional[torch.device] = None, consts: Optional[Dict[int, list]] = None):
        self.mode = mode  # "host" | "device"
        self.config = config
        self.op_name = op_name
        # where numpy operands of a device op are placed ("meta" while planning)
        self.device = torch.device("cpu") if device is None else torch.device(device)
        # id(plan constant) -> [array, device copy or None]: the executor's
        # cache, so a constant crosses to the device once and not per run
        self.consts = consts

    def tensor(self, x) -> torch.Tensor:
        """An operand as a tensor on the op's device: tensors as they are,
        static numpy operands copied over (once per executor for plan
        constants; an uncached host-to-device copy waits for the stream)."""
        if isinstance(x, torch.Tensor):
            return x
        # the entry holds its array, so no other object can share that id
        entry = self.consts.get(id(x)) if self.consts is not None else None
        if entry is None:
            return to_torch(x, self.device)
        if entry[1] is None:
            entry[1] = to_torch(x, self.device)
        return entry[1]

    def derived(self, a: np.ndarray) -> torch.Tensor:
        """A small array an op computed on the host from shapes and
        attributes (a Resize index), on the op's device: copied once per
        executor and value, so a run inside a device loop waits for no copy."""
        if self.consts is None:
            return to_torch(a, self.device)
        key = (a.dtype.str, a.shape, a.tobytes())  # plan constants are keyed by id, an int
        entry = self.consts.get(key)
        if entry is None:
            entry = self.consts[key] = [a, to_torch(a, self.device)]
        return entry[1]

    def static(self, ins, i: int, what: str = "") -> Optional[np.ndarray]:
        """Return input i as a concrete numpy array, or raise StaticRequired
        (a ``meta`` tensor has no value, as a JAX tracer has none)."""
        v = ins[i] if i < len(ins) else None
        if v is None:
            return None
        if isinstance(v, np.ndarray):
            return v
        if isinstance(v, (int, float, list, tuple)):
            return np.asarray(v)
        if isinstance(v, torch.Tensor) and v.device.type != "meta":
            return to_numpy(v)
        raise StaticRequired(i, what or self.op_name)


# Importing the op modules installs all builtin ops into the registry.
from onnxstream_tpu_torch.ops import standard as _standard  # noqa: E402,F401
from onnxstream_tpu_torch.ops import attention as _attention  # noqa: E402,F401
from onnxstream_tpu_torch.ops import collective as _collective  # noqa: E402,F401

"""The collective the sharding pass puts into a graph: ``all_gather``.

On a NCCL group the gather runs on the card (``all_gather_into_tensor``). On
a gloo group it runs on CPU tensors; a CUDA tensor (two gloo ranks sharing
one card, which NCCL refuses) is staged through pinned host memory and back.
The branch follows ``dist.get_backend(group)``.

Every call is counted per mesh dim (``STATS``): calls, the bytes of the
gathered outputs and the host seconds the calls took (each call returns
after its data is in place, so on gloo that is the collective's wall time;
on NCCL it is the enqueue).
"""

from __future__ import annotations

import time
from typing import Dict

import torch
import torch.distributed as dist


class CommStats:
    """Per mesh dim: calls, gathered bytes and host seconds."""

    def __init__(self) -> None:
        self.by_dim: Dict[str, Dict[str, float]] = {}

    def add(self, dim: str, nbytes: int, seconds: float) -> None:
        s = self.by_dim.setdefault(dim, {"calls": 0, "bytes": 0, "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += nbytes
        s["seconds"] += seconds

    def reset(self) -> None:
        self.by_dim.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.by_dim.items()}


STATS = CommStats()


def all_gather(x: torch.Tensor, axis: int, group, dim: str = "tp") -> torch.Tensor:
    """The group's shards of x concatenated along ``axis`` in rank order."""
    t0 = time.perf_counter()
    parts = dist.get_world_size(group)
    axis = axis % x.ndim
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        # gathered along axis 0 in rank order; another axis takes one copy
        shape = list(x.shape)
        shape[0] *= parts
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        if axis:
            out = torch.cat(out.chunk(parts, 0), axis)
    else:
        # gloo moves bytes: the shards travel as uint8 views (any dtype) in
        # host memory; a CUDA tensor is staged through pinned buffers (the
        # copy out waits for the device)
        host = x.view(torch.uint8)
        if x.device.type != "cpu":
            host = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True).copy_(host)
        pieces = [torch.empty_like(host) for _ in range(parts)]
        dist.all_gather(pieces, host, group=group)
        if x.device.type == "cpu":
            out = torch.cat(pieces, axis).view(x.dtype)
        else:
            shape = list(host.shape)
            shape[axis] *= parts
            staged = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            out = torch.cat(pieces, axis, out=staged).view(x.dtype).to(x.device, non_blocking=True)
    STATS.add(dim, out.numel() * out.element_size(), time.perf_counter() - t0)
    return out

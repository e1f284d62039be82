"""The collective the sharding pass puts into a graph, ``all_gather``, and
the two a gradient needs: ``reduce_scatter`` (the gather's backward) and
``all_reduce`` (a replicated weight's gradient, summed over the ranks that
hold it).

On a NCCL group they run on the card (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``). On a gloo group they run on CPU
tensors; a CUDA tensor (two gloo ranks sharing one card, which NCCL
refuses) is staged through pinned host memory and back. Gloo has no
reduce-scatter: it is an all-reduce of the whole tensor, of which the rank
keeps its block. The branch follows ``dist.get_backend(group)``.

Every call is counted per mesh dim (``STATS``): calls, the bytes of the
outputs (a gather's gathered tensor, a reduce's reduced one) and the host
seconds the calls took (each call returns after its data is in place, so on
gloo that is the collective's wall time; on NCCL it is the enqueue). Gathers
count under the dim's name, the reductions under "<dim>.reduce_scatter" and
"<dim>.all_reduce".
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


def _host_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over a gloo group, in a new tensor on x's device: a CUDA
    tensor is staged through pinned host memory; a 16-bit float is summed
    in float32."""
    host = x.detach().float() if x.dtype in (torch.float16, torch.bfloat16) else x.detach()
    if host.device.type != "cpu":
        host = torch.empty(host.shape, dtype=host.dtype, pin_memory=True).copy_(host)
    else:
        host = host.clone()
    dist.all_reduce(host, group=group)
    return host.to(x.device, x.dtype, non_blocking=True)


def all_reduce(x: torch.Tensor, group, dim: str = "tp") -> torch.Tensor:
    """The sum of x over the group, in a new tensor, on every rank."""
    t0 = time.perf_counter()
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
    else:
        out = _host_all_reduce(x, group)
    STATS.add(f"{dim}.all_reduce", out.numel() * out.element_size(), time.perf_counter() - t0)
    return out


def reduce_scatter(x: torch.Tensor, axis: int, group, dim: str = "tp") -> torch.Tensor:
    """This rank's block along ``axis`` of the sum of x over the group: the
    gradient of ``all_gather`` along the same axis."""
    t0 = time.perf_counter()
    parts = dist.get_world_size(group)
    rank = dist.get_rank(group)
    axis = axis % x.ndim
    if dist.get_backend(group) == "nccl":
        # the blocks in rank order along axis 0
        src = (x if axis == 0 else torch.cat(x.chunk(parts, axis), 0)).contiguous()
        shape = list(src.shape)
        shape[0] //= parts
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, group=group)  # the shape of one block
    else:
        n = x.shape[axis] // parts
        out = _host_all_reduce(x.contiguous(), group).narrow(axis, rank * n, n).contiguous()
    STATS.add(f"{dim}.reduce_scatter", out.numel() * out.element_size(), time.perf_counter() - t0)
    return out

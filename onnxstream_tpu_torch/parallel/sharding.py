"""Sharding rules over a ``torch.distributed`` device mesh.

Counterpart of ``onnxstream_tpu/parallel/sharding.py``, with the same rules:

  * **dp**: the batch axis of activations (data parallel);
  * **tp**: weights shard on their output axis, 2-D (din, dout) weights as
    ``Shard(1)``, conv OIHW kernels as ``Shard(0)``, 1-D vectors as
    ``Shard(0)``, each where divisible and large enough;
  * **sp** (optional third axis): axis 1 of 3-D and wider activations.

JAX is single-controller and XLA's SPMD partitioner puts the collectives in.
PyTorch shards a model with one process a device over a process group
(``torchrun``, or ``parallel.launch.spawn``): every rank runs the graph on its
own shards, and the plan-time pass of ``parallel/spmd.py`` puts in the
collectives. So ``make_mesh`` needs an initialized process group whose world
is the mesh, and the placements returned here are ``torch.distributed.tensor``
``Shard(axis)`` / ``Replicate()``, one per mesh dim.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

_TP_ORDER = (8, 4, 2, 1)  # favor tensor parallelism within a host, data parallel on top


def _require_world(n: int) -> None:
    """The mesh is the whole process group: raise unless one of n ranks is
    initialized. Nothing here starts a group or falls back to a CPU mesh."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh: no torch.distributed process group; start {n} ranks with a launcher "
            f"(torchrun --nproc-per-node={n} ..., or onnxstream_tpu_torch.parallel.launch.spawn) "
            f"and call torch.distributed.init_process_group in each")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"make_mesh: requested {n} devices, but the process group has {world} ranks; "
            f"launch {n} ranks (torchrun --nproc-per-node={n}, or launch.spawn(fn, {n}, ...))")


def _factor(n: int, dp: Optional[int], tp: Optional[int], sp: int) -> Tuple[int, int]:
    """(dp, tp) of an n-rank mesh with sp ranks on the sequence axis: the JAX
    package's factorization and its errors."""
    if sp > 1:
        rest, rem = divmod(n, sp)
        if rem:
            raise ValueError(f"make_mesh: sp={sp} does not divide n_devices={n}")
        if tp is None and dp is not None:
            tp, rem = divmod(rest, dp)
            if rem:
                raise ValueError(f"make_mesh: dp={dp} does not divide n_devices/sp={rest}")
        elif tp is None:
            tp = next(c for c in _TP_ORDER if rest % c == 0)
        dp = dp if dp is not None else rest // tp
        if dp * tp * sp != n:
            raise ValueError(f"make_mesh: dp*tp*sp = {dp}*{tp}*{sp} != n_devices = {n}")
        return dp, tp
    if dp is None and tp is None:
        tp = next(c for c in _TP_ORDER if n % c == 0)
        dp = n // tp
    elif dp is None:
        dp, rem = divmod(n, tp)
        if rem:
            raise ValueError(f"make_mesh: tp={tp} does not divide n_devices={n}")
    elif tp is None:
        tp, rem = divmod(n, dp)
        if rem:
            raise ValueError(f"make_mesh: dp={dp} does not divide n_devices={n}")
    if dp * tp != n:
        raise ValueError(f"make_mesh: dp*tp = {dp}*{tp} != n_devices = {n}")
    return dp, tp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: Optional[int] = None,
              sp: int = 1) -> DeviceMesh:
    """A dp x tp mesh over the process group's ranks, or dp x tp x sp with a
    sequence-parallel axis; ``mesh_dim_names`` ("dp", "tp"[, "sp"]). The
    ranks are laid out row-major, so a rank's tp neighbours are consecutive
    ranks. n_devices defaults to the world size. The mesh's device type is
    "cuda" on a NCCL group and "cpu" on gloo, whatever device the ranks
    compute on (two gloo ranks may share one card)."""
    n = n_devices or (dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1)
    dp, tp = _factor(n, dp, tp, sp)
    _require_world(n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if sp > 1:
        return init_device_mesh(device_type, (dp, tp, sp), mesh_dim_names=("dp", "tp", "sp"))
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def mesh_sizes(mesh: DeviceMesh) -> dict:
    """Mesh dim name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def shard_weight_spec(shape: Sequence[int], tp: int):
    """Placement of one weight along the tp dim: ``Shard(1)`` for a 2-D
    weight whose output axis divides by tp and holds at least 8 columns a
    rank, ``Shard(0)`` for a 4-D conv kernel likewise on its output channels
    and for a 1-D vector of at least 128 a rank, else ``Replicate()``."""
    shape = tuple(shape)
    if len(shape) == 2 and shape[1] % tp == 0 and shape[1] >= tp * 8:
        return Shard(1)
    if len(shape) == 4 and shape[0] % tp == 0 and shape[0] >= tp * 8:
        return Shard(0)
    if len(shape) == 1 and shape[0] % tp == 0 and shape[0] >= tp * 128:
        return Shard(0)
    return Replicate()


def _placements(mesh: DeviceMesh, by_dim: dict) -> List:
    return [by_dim.get(name, Replicate()) for name in mesh.mesh_dim_names]


def shard_weights(mesh: DeviceMesh, shapes: Sequence[Sequence[int]]) -> List[List]:
    """Per weight, its placements (one per mesh dim): ``shard_weight_spec``
    on tp, replicated over dp and sp."""
    tp = mesh_sizes(mesh).get("tp", 1)
    return [_placements(mesh, {"tp": shard_weight_spec(s, tp)}) for s in shapes]


def kv_head_sharding(mesh: DeviceMesh, shape: Sequence[int]) -> List:
    """The bucketed LLM KV cache (B, kv_heads, P, head_dim): the head axis over
    tp, so each rank holds the K / V of exactly the heads whose q / k / v
    projection columns it owns (contiguous head blocks). The in-graph
    ScatterND cache write then lands rank-locally and GQA's head grouping
    never crosses ranks. Replicated when kv_heads % tp != 0."""
    tp = mesh_sizes(mesh).get("tp", 1)
    if len(shape) == 4 and tp > 1 and shape[1] % tp == 0:
        return _placements(mesh, {"tp": Shard(1)})
    return _placements(mesh, {})


def activation_sharding(mesh: DeviceMesh, shape: Sequence[int]) -> List:
    """Data parallelism on the batch axis and optional sequence parallelism:
    axis 0 over dp and axis 1 (sequence / spatial) over sp, each when
    divisible (sp also needs at least 8 a rank)."""
    sizes = mesh_sizes(mesh)
    dp, sp = sizes["dp"], sizes.get("sp", 1)
    by_dim = {}
    if len(shape) >= 1 and shape[0] > 0 and shape[0] % dp == 0 and dp > 1:
        by_dim["dp"] = Shard(0)
    if len(shape) >= 3 and sp > 1 and shape[1] % sp == 0 and shape[1] >= sp * 8:
        by_dim["sp"] = Shard(1)
    return _placements(mesh, by_dim)


def make_train_step(executor, output_name: str, mesh: DeviceMesh, learning_rate: float = 1e-4):
    """The sharded training step (JAX: AdamW over TP-sharded weights and a
    DP-sharded batch) is not ported yet: it needs autograd through the flash
    kernels, whose backward the JAX package lacks too."""
    raise NotImplementedError(
        "make_train_step: the sharded train step is not ported yet (ROADMAP.md Queue 1 item 11: "
        "make_train_step, AdamW with autograd through kernels 1 and 2)")

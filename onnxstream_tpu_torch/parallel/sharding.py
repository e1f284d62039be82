"""Sharding rules over a ``torch.distributed`` device mesh.

Counterpart of ``onnxstream_tpu/parallel/sharding.py``, with the same rules:

  * **dp**: the batch axis of activations (data parallel);
  * **tp**: weights shard on their output axis, 2-D (din, dout) weights as
    ``Shard(1)``, conv OIHW kernels as ``Shard(0)``, 1-D vectors as
    ``Shard(0)``, each where divisible and large enough;
  * **sp** (optional third axis): axis 1 of 3-D and wider activations.

``make_train_step`` is the sharded AdamW step (see its docstring for how the
ranks' gradients add up).

JAX is single-controller and XLA's SPMD partitioner puts the collectives in.
PyTorch shards a model with one process a device over a process group
(``torchrun``, or ``parallel.launch.spawn``): every rank runs the graph on its
own shards, and the plan-time pass of ``parallel/spmd.py`` puts in the
collectives. So ``make_mesh`` needs an initialized process group whose world
is the mesh, and the placements returned here are ``torch.distributed.tensor``
``Shard(axis)`` / ``Replicate()``, one per mesh dim.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
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


# kernel routes a train step refuses: the option that turns each off. No
# hand-written kernel has a backward (nor has any Pallas kernel in the JAX
# package): their outputs carry no grad_fn, and a step through one would
# train with its gradient cut off, without an error
_KERNEL_OPS = {"ostpu.gn_silu": "fuse_groupnorm", "ostpu.gn_silu_conv": "fuse_gn_conv",
               "ostpu.conv3x3_im2col": "use_pallas_smallconv"}
_KERNEL_LAYOUTS = {"t9oc": "fuse_gn_conv", "t9co": "use_pallas_smallconv",
                   "tnk": "use_w8a8_dyn_matmul / use_uint8_arithmetic", "ohwi": "use_nhwc_layout / use_uint8_arithmetic"}
_KERNEL_ROUTES = {"w8_matmul": "use_w8_matmul", "w8a8_dyn_matmul": "use_w8a8_dyn_matmul",
                  "qmatmul": "use_uint8_arithmetic", "qconv": "use_uint8_arithmetic"}


def kernel_routes(executor) -> List[str]:
    """What of the executor's plan runs a hand-written kernel, each with the
    option that turns it off: attention under ``use_flash_attention`` (its
    sites take the flash kernels by their size at run time, so every
    ``ostpu.sdpa`` counts), the GroupNorm fusions, the small-conv rewrite,
    the 8-bit routes, the upload layouts made for kernels, and weights
    stored as integers, which no float leaf can stand in for."""
    found = []
    ops = {op.op_type for op in executor.graph.ops}
    if executor.config.use_flash_attention and "ostpu.sdpa" in ops:
        found.append("ostpu.sdpa (use_flash_attention)")
    found += [f"{t} ({opt})" for t, opt in _KERNEL_OPS.items() if t in ops]
    found += [f"{r} ({_KERNEL_ROUTES[r]})" for r in sorted(set(executor.quant_routes.values()))]
    found += [f"the {t} upload layout ({opt})" for t, opt in _KERNEL_LAYOUTS.items()
              if any(w.transform == t for w in executor.plan.arg_weights)]
    # an 8-bit weight dequantized on read (a 4-D conv kernel, a MatMul weight
    # with use_w8_matmul off, an integer weight of the model file) takes no
    # kernel, but its float32 leaf would be cast to the integer dtype: its
    # values truncated and its gradient cut off
    ints = [w.name for w in executor.plan.arg_weights if not w.upload_dtype.is_floating_point]
    if ints:
        found.append(f"integer storage of {', '.join(ints[:3])}{f' and {len(ints) - 3} more' if len(ints) > 3 else ''}"
                     " (force_uint8_storage_set / int8_weights)")
    return found


def _local_slices(mesh, shape: Sequence[int], pmap: dict) -> Tuple[Tuple[int, int, int], ...]:
    """This rank's ((axis, start, stop), ...) of a tensor placed as pmap
    ({axis: mesh dim})."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = []
    for axis, d in sorted(pmap.items()):
        n = shape[axis] // sizes[d]
        out.append((axis, coord[d] * n, (coord[d] + 1) * n))
    return tuple(out)


def make_train_step(executor, output_name: str, mesh: Optional[DeviceMesh], learning_rate: float = 1e-4):
    """One AdamW training step over a single-segment executor (JAX
    ``make_train_step``): loss = MSE(model(weights, acts)[output_name],
    target) over the whole batch. Returns ``(step, init, placements)``.

    ``executor`` is planned under ``SessionConfig(mesh=mesh)`` (a rank's
    plan: ``Session._executor()`` on every rank), or without a mesh for
    ``mesh=None`` (one device). ``placements``: per weight of
    ``executor.plan.arg_weights``, one DTensor placement per mesh dim, the
    slices the sharding pass gave it (tp for the products' weights).
    ``init(weights)`` takes the whole weights (numpy arrays or tensors, a
    list in ``plan.arg_weights`` order or a dict by name) and returns this
    rank's float32 leaf slices on the executor's device and a
    ``torch.optim.AdamW`` over them with optax.adamw's defaults (b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4 on every weight): the optimizer state
    lives on the rank's slices, sharded like the weights.
    ``step(weights, opt, acts, target)`` returns ``(weights, opt, loss)``:
    acts and target whole (or this rank's share), the weights updated in
    place, each one's ``.grad`` its gradient on this rank's slice, ``loss``
    the global MSE, the same on every rank.

    How the gradient is made correct over the ranks. Each rank's loss is its
    share of the global one: it holds the output's elements of its slice
    (before the output is gathered), each repeated on every rank of the mesh
    dims the output is not sharded on, so it sums its squared errors and
    divides by the global element count and by that repetition; the rank
    losses sum to the global loss over the world. Its backward runs through
    the pass's collectives: a gather's backward is a reduce-scatter (every
    rank's gradient of the gathered tensor summed, cut to this rank's
    block) and a local slice's pads with zeros, which is the chain rule over
    the union of the ranks' graphs (Megatron's f / g pair, for any mix of
    the pass's gathers and slices). A weight held whole by several ranks
    then has a share of its gradient on each: it is summed over the mesh
    dims the weight is not sharded on (always dp and sp, and tp where its
    placement is ``Replicate()``).

    Refused (``ValueError``): a plan of several segments, as JAX asserts,
    and any plan that routes an op to a hand-written kernel
    (``kernel_routes``: flash attention, the GroupNorm fusions, small-conv,
    the 8-bit routes, the kernels' upload layouts) or stores a weight as
    integers (``force_uint8_storage_set`` also where the weight is
    dequantized on read), naming the option to turn off. No kernel of either package has a backward, and JAX's dry run
    never reaches its Pallas kernels (its attention takes them on a TPU
    only); a kernel's output here carries no grad_fn, so a step through one
    would train with gradients cut off and raise nothing."""
    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.runtime.executor import _take_shard, reference_precision

    if len(executor.segments) != 1:
        raise ValueError(f"make_train_step: training uses single-segment plans, this one has "
                         f"{len(executor.segments)} (hbm_budget_bytes=0)")
    routes = kernel_routes(executor)
    if routes:
        raise ValueError("make_train_step: the plan runs hand-written kernels, which have no backward: "
                         + "; ".join(routes) + ". Turn those options off")
    info = executor.mesh_info
    if (mesh is None) != (info is None):
        raise ValueError("make_train_step: plan the executor under SessionConfig(mesh=mesh) (or neither)")
    args = executor.plan.arg_weights
    device = executor.device
    names = list(mesh.mesh_dim_names) if mesh is not None else []
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    wplace = [dict(info.weight_placements.get(w.name, {})) if info else {} for w in args]
    placements = [[Shard(next(a for a, d in pm.items() if d == name)) if name in pm.values() else Replicate()
                   for name in names] for pm in wplace]
    # a weight's gradient is summed over the mesh dims it is held whole on
    reduce_over = [tuple(d for d in names if sizes[d] > 1 and d not in pm.values()) for pm in wplace]
    out_pm = dict(info.placements.get(output_name, {})) if info else {}
    out_shape = (tuple(info.global_avals[output_name].shape) if info
                 else tuple(executor.plan.avals[output_name].shape))
    repeat = math.prod(sizes[d] for d in names if d not in out_pm.values())
    denom = float(math.prod(out_shape) * repeat)
    fn = executor.segment_fn(0, also=(output_name,) if info else ())

    def init(weights):
        if isinstance(weights, dict):
            weights = [weights[w.name] for w in args]
        if len(weights) != len(args):
            raise ValueError(f"init: the plan has {len(args)} weights, got {len(weights)}")
        params = []
        for w, v in zip(args, weights):
            t = torch.as_tensor(np.asarray(v, np.float32) if not isinstance(v, torch.Tensor) else v)
            if w.shard and tuple(t.shape) != tuple(w.shape):
                t = _take_shard(t, w.shard)
            params.append(t.to(device, torch.float32).clone().requires_grad_(True))
        opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        return params, opt

    def _reduce_grads(params) -> None:
        buckets = {}
        for p, dims in zip(params, reduce_over):
            if dims and p.grad is not None:
                buckets.setdefault(dims, []).append(p)
        for dims, ps in buckets.items():  # the same order on every rank
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            for d in dims:
                flat = comm.all_reduce(flat, mesh.get_group(d), d)
            for p, g in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad.copy_(g.view_as(p.grad))

    def step(weights, opt, acts, target):
        opt.zero_grad(set_to_none=True)
        t = torch.as_tensor(np.asarray(target, np.float32) if not isinstance(target, torch.Tensor) else target)
        if out_pm and tuple(t.shape) == out_shape:
            t = _take_shard(t, _local_slices(mesh, out_shape, out_pm))
        t = t.to(device, torch.float32)
        with reference_precision():
            out = fn([p.to(w.upload_dtype) for p, w in zip(weights, args)], acts)[output_name]
            loss = (out.float() - t).square().sum() / denom
            loss.backward()
        if mesh is not None:
            _reduce_grads(weights)
            loss = comm.all_reduce(loss.detach(), dist.group.WORLD, "world")
        opt.step()
        return weights, opt, loss.detach()

    return step, init, placements

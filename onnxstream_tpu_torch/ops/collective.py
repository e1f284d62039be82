"""The ops the sharding pass (``parallel/spmd.py``) puts into a rank's graph.

``ostpu.all_gather`` concatenates the shards of its operand along ``axis``
over the mesh dim ``dim`` (``parts`` ranks) through ``parallel/comm.py``;
``ostpu.shard_slice`` keeps this rank's [start, stop) of a replicated
operand along ``axis`` (a local copy, no traffic). While the planner works on
``meta`` tensors the gather only scales the axis. Both carry rank-specific
attributes and are no model.txt op: ``registered_ops()`` leaves them out.

Both are differentiable (the train step of ``parallel/sharding.py``): the
gather's backward is a reduce-scatter, the sum of every rank's gradient of
the gathered tensor cut to this rank's block; the slice's pads its gradient
with zeros (``narrow``'s own backward, no traffic). Outside autograd the
gather is the plain call.
"""

from __future__ import annotations

import torch

from onnxstream_tpu_torch.ops import Ctx, register
from onnxstream_tpu_torch.parallel import comm


class _Gather(torch.autograd.Function):
    """``comm.all_gather`` forward, ``comm.reduce_scatter`` backward."""

    @staticmethod
    def forward(ctx, x, axis, group, dim):
        ctx.axis, ctx.group, ctx.dim = axis, group, dim
        return comm.all_gather(x, axis, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter(grad, ctx.axis, ctx.group, ctx.dim), None, None, None


@register("ostpu.all_gather", internal=True)
def _all_gather(ctx: Ctx, op, ins):
    x = ctx.tensor(ins[0])
    axis, parts = op.attr_int("axis"), op.attr_int("parts")
    if x.device.type == "meta":
        shape = list(x.shape)
        shape[axis] *= parts
        return [x.new_empty(shape)]
    dim = op.attr("dim")
    group = ctx.config.mesh.get_group(dim)
    if torch.is_grad_enabled() and x.requires_grad:
        return [_Gather.apply(x, axis, group, dim)]
    return [comm.all_gather(x, axis, group, dim)]


@register("ostpu.shard_slice", internal=True)
def _shard_slice(ctx: Ctx, op, ins):
    x = ctx.tensor(ins[0])
    start = op.attr_int("start")
    return [x.narrow(op.attr_int("axis"), start, op.attr_int("stop") - start).contiguous()]

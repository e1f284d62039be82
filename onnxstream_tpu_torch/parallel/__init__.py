"""Multi-device serving over ``torch.distributed``: the dp x tp (x sp) mesh
and its placement rules (``sharding``), the collectives (``comm``), the
plan-time sharding pass (``spmd``), the rank launcher (``launch``) and the
multi-rank dry run (``dryrun``). Counterpart of ``onnxstream_tpu/parallel``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LocalShard:
    """This rank's shard of a tensor placed on a mesh, pushed as a graph
    input (``Session.add_tensor``): the local tensor and the global shape.
    The LLM pipeline feeds its head-sharded KV cache back so; the global
    shape keys the shape bucket and the plan."""

    tensor: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

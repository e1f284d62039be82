"""Entry points: the flagship model's forward as a function, and the dry run.

Counterpart of ``__graft_entry__.py``:

    entry()            -> (fn, (weights, acts)): the single-segment SD1.5 UNet
                          (860 M params) in bfloat16 through the planner and
                          executor; fn(weights, acts) -> {"out_sample": tensor}
    dryrun_multichip(n) -> the train step and the sharded paths on n ranks
                          (``parallel/dryrun.py``)

``fn`` is ``Executor.segment_fn(0)``: weights are the plan's weights
(``plan.arg_weights`` order) on the device in their upload dtypes, acts the
graph inputs. Attention takes the flash kernel (kernel 1) at the UNet's
sites, as a ``Session.run`` of the same graph does. Like every entry point
of the port it runs on the first CUDA card unless the caller names a
device (``device="cpu"``).

    fn, (weights, acts) = entry("sd15")
    out = fn(weights, acts)["out_sample"]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from onnxstream_tpu_torch.parallel.dryrun import dryrun_multichip
from onnxstream_tpu_torch.runtime.config import SessionConfig, default_device
from onnxstream_tpu_torch.runtime.session import Session
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

__all__ = ["build_session", "entry", "session_entry", "dryrun_multichip"]


def build_session(flagship: str = "sd15", device: Optional[torch.device] = None,
                  graph=None) -> Tuple[Session, Dict[str, np.ndarray]]:
    """The UNet (``"sd15"`` or ``"tiny"``, seed 0, batch 1) in a bfloat16
    Session with the fused attention and the flash kernel, and its inputs
    (JAX ``_build_session``: the same weights and inputs). ``graph``: the
    same model's ``build_unet`` result, built already; ``chip_smoke.py``
    passes the SD1.5 graph it has built to save building it again."""
    from onnxstream_tpu_torch.models.sd.unet import SD15, TINY, build_unet

    cfg = {"sd15": SD15, "tiny": TINY}[flagship]
    batch = 1
    g = build_unet(cfg, batch=batch) if graph is None else graph
    config = SessionConfig(compute_dtype="bfloat16", fuse_ops_in_attention=True, use_flash_attention=True,
                           device=default_device() if device is None else torch.device(device))
    s = Session(config=config, weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    s.read_string(g.to_text())
    size = cfg.sample_size
    inputs = {
        "sample": np.random.RandomState(0).rand(batch, cfg.in_channels, size, size).astype(np.float32),
        "timestep": np.array([500.0], np.float32),
        "encoder_hidden_states": np.random.RandomState(1).rand(
            batch, cfg.context_len, cfg.cross_attention_dim).astype(np.float32),
    }
    return s, inputs


def session_entry(s: Session, inputs: Dict[str, np.ndarray]) -> Tuple[Callable, Tuple[List[torch.Tensor], Dict[str, Any]]]:
    """``(fn, (weights, acts))`` of a single-segment session's graph: the
    plan's weights uploaded as a run would hold them."""
    for k, v in inputs.items():
        s.add_tensor(k, v)
    executor = s._executor()
    if len(executor.segments) != 1:
        raise ValueError(f"entry: a single-segment plan is needed, this one has {len(executor.segments)}")
    weights = [executor._upload(w) for w in executor.plan.arg_weights]
    return executor.segment_fn(0), (weights, {k: np.asarray(v) for k, v in inputs.items()})


def entry(flagship: str = "sd15", device: Optional[torch.device] = None):
    """The UNet forward as ``fn(weights, acts) -> {"out_sample": tensor}``
    and its example arguments, bf16, on ``device`` (default: the first
    CUDA card)."""
    return session_entry(*build_session(flagship, device=device))

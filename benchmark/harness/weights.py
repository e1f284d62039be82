"""The benchmark's weights, made on the card from the run's seed in the
type they are served in, and handed to the program and to the reference as
the same tensors.

One ``torch.randn`` over all of a model's parameters on a ``torch.Generator``
of the card, each parameter's slice then scaled in place by its kind: a
matrix or convolution kernel by 1 / sqrt(fan in), an embedding to 0.02, a
bias to 0.02 and a norm's gain to 1 + 0.05 z. The whole buffer then comes to
the host once, into pinned memory, from where the program uploads it (its
weights providers serve host tensors) and the reference reads it after the
window. The card's copy is freed before the window."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shape = Tuple[int, ...]


def is_parameter(name: str) -> bool:
    """Learned parameters by the weight file's naming: kernels
    (``.weight_nchw``), matrices, embeddings and norm gains (``.weight``),
    biases (``.bias``). Everything else (shapes, scalars, split sizes, the
    causal mask, frequency tables) is a constant of the graph."""
    return name.endswith((".weight_nchw.bin", ".weight.bin", ".bias.bin"))


def init_std(name: str, shape: Shape) -> Tuple[float, float]:
    """(std, mean) of a parameter."""
    if "embedding" in name or name.endswith(".bias.bin"):
        return 0.02, 0.0
    if name.endswith(".weight.bin") and (len(shape) == 1 or (len(shape) == 3 and shape[1:] == (1, 1))):
        return 0.05, 1.0  # a norm's gain
    fan_in = math.prod(shape[1:]) if name.endswith(".weight_nchw.bin") else shape[0]
    return 1.0 / math.sqrt(fan_in), 0.0


def generate(specs: Dict[str, Dict[str, Shape]], seed: int, device: torch.device,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """model -> name -> host tensor (pinned where the device is a card), the
    same for the same seed."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, (model, spec) in enumerate(sorted(specs.items())):
        total = sum(math.prod(s) for s in spec.values())
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 1000003 + k) % (1 << 63))
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        views, off = {}, 0
        for name, shape in sorted(spec.items()):
            n = math.prod(shape)
            std, mean = init_std(name, shape)
            piece = buf[off:off + n]
            piece.mul_(std)
            if mean:
                piece.add_(mean)
            views[name] = (off, n, shape)
            off += n
        host = torch.empty(total, dtype=dtype, pin_memory=device.type == "cuda")
        host.copy_(buf)
        del buf
        out[model] = {name: host[o:o + n].view(shape) for name, (o, n, shape) in views.items()}
    return out

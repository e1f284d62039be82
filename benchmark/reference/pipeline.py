"""Text-to-image as OnnxStream's ``sd`` does it, in plain float32 but where
the precision ``P`` rounds (``ops.py``): the
prompt's 77 CLIP tokens (BOS, the prompt's words, EOS to the end), the text
encoders (SD1.5: CLIP-L's final state; SDXL: the second-to-last states of
CLIP-L and bigG side by side, bigG's pooled state at the first EOS, as the
published ``CLIPTextModelWithProjection`` takes it), the sampler's loop over
the UNet with classifier-free guidance (uncond + scale * (cond - uncond);
a turbo request runs the cond branch alone), and the VAE decoder on the
latents over the scaling factor, mapped to uint8 as ``(x + 1) * 127.5``
clipped and truncated.

The configuration is the benchmark's configuration file: ``text_encoders``
(each a published text-encoder config), ``unet``, ``vae`` and
``latent_size``. A request gives ``prompt``, ``negative_prompt``,
``seed``, ``steps``, ``sampler``, ``cfg_scale`` and ``turbo``."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from benchmark.reference import clip, sampler, unet, vae
from benchmark.reference.ops import FLOAT32, Precision, Weights

BOS, EOS, CONTEXT = 49406, 49407, 77


def tokens(prompt: str, vocab: Mapping[str, int]) -> np.ndarray:
    """(1, 77) int64: BOS, the id of each of the prompt's words that the
    vocabulary holds (75 at most), then EOS to the end."""
    ids = [vocab[w] for w in prompt.lower().split() if w in vocab][:CONTEXT - 2]
    return np.array([[BOS] + ids + [EOS] * (CONTEXT - 1 - len(ids))], np.int64)


def first_eos(ids: np.ndarray) -> int:
    """Where the published text encoder pools: ``input_ids.argmax(-1)``, the
    first place of EOS, the vocabulary's largest id."""
    return int(np.argmax(ids[0]))


def encode(weights: Dict[str, Weights], cfg: dict, prompt: str, vocab: Mapping[str, int], device,
           P: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """The UNet's conditioning for one prompt: ``context`` (1, 77, d) and,
    with two encoders, ``pooled`` (1, p)."""
    ids = tokens(prompt, vocab)
    tok = torch.as_tensor(ids, device=device)
    encoders: List[dict] = cfg["text_encoders"]
    if len(encoders) == 1:
        return {"context": clip.encode(weights["text_encoder"], encoders[0], tok, P)["last"]}
    first = clip.encode(weights["text_encoder"], encoders[0], tok, P)
    second = clip.encode(weights["text_encoder_2"], encoders[1], tok, P, pool_at=first_eos(ids))
    return {"context": torch.cat([first["penultimate"], second["penultimate"]], dim=-1),
            "pooled": second["pooled"]}


def text_to_image(weights: Dict[str, Weights], cfg: dict, request: dict, vocab: Mapping[str, int], device,
                  P: Precision = FLOAT32) -> Dict[str, np.ndarray]:
    """One request -> ``latents`` (4, h, w) float32 and ``image`` (8h, 8w, 3)
    uint8."""
    ucfg = cfg["unet"]
    lat = int(cfg["latent_size"])
    steps, seed = int(request["steps"]), int(request["seed"])
    cond = encode(weights, cfg, request["prompt"], vocab, device, P)
    uncond = None if request.get("turbo") else encode(weights, cfg, request["negative_prompt"], vocab, device, P)
    time_ids: Optional[torch.Tensor] = None
    if ucfg.get("addition_embed_type") == "text_time":
        size = int(cfg.get("time_ids_size", 8 * lat))
        time_ids = torch.tensor([[size, size, 0, 0, size, size]], dtype=torch.float32, device=device)
    sig = sampler.sigmas(steps)
    chans = int(ucfg["in_channels"])
    x = torch.as_tensor(sampler.start_latents(seed, chans, lat, lat, steps), device=device)[None]
    scale = float(request["cfg_scale"])

    def denoised(branch: Dict[str, torch.Tensor], x_in: torch.Tensor, t: float, c_out: float) -> torch.Tensor:
        e = unet.eps(weights["unet"], ucfg, x_in, t, branch["context"], branch.get("pooled"), time_ids, P)
        return e * c_out + x

    for i in range(steps):
        s = float(sig[i])
        c_in, c_out = sampler.scalings(s)
        t = sampler.sigma_to_t(s)
        den = denoised(cond, x * c_in, t, c_out)
        if uncond is not None:
            den_u = denoised(uncond, x * c_in, t, c_out)
            den = den_u + scale * (den - den_u)
        if request["sampler"] == "euler_a":
            up, down = sampler.ancestral(s, float(sig[i + 1]))
            noise = torch.as_tensor(sampler.step_noise(seed, i, chans, lat, lat), device=device)[None]
            x = x + (x - den) / s * (down - s) + noise * up
        elif request["sampler"] == "euler":
            x = x + (x - den) / s * (float(sig[i + 1]) - s)
        else:
            raise ValueError(f"the reference runs euler and euler_a, not {request['sampler']!r}")
    return {"latents": x[0].cpu().numpy(), "image": decode(weights, cfg, x[0], P)}


def decode(weights: Dict[str, Weights], cfg: dict, latents, P: Precision = FLOAT32) -> np.ndarray:
    """(4, h, w) latents -> the (8h, 8w, 3) uint8 image: the decoder on the
    latents over the scaling factor, ``(x + 1) * 127.5`` clipped and
    truncated."""
    z = torch.as_tensor(latents, dtype=torch.float32, device=weights["vae_decoder"].device)[None]
    img = vae.decode(weights["vae_decoder"], cfg["vae"], z / float(cfg["vae"]["scaling_factor"]), P)[0]
    return ((img.permute(1, 2, 0) + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()

"""The comparison that decides ``correct``: each sampled request's served
latents and image against the plain reference, as numbers held to the
cell's limits (``limits/<workload>.json``).

  * ``latent_rel``: ||latents - reference||_2 / ||reference||_2 in float32,
    the reference run from the request's prompt and seed (the encoders,
    every step's UNet, the guidance and the sampler);
  * ``image_mae``: the mean absolute difference, in uint8 levels, between
    the served image and the reference decoder's image of the served latents
    (the decode stage, judged on the latents it was given, as a served
    model's logits are judged on its own tokens).

A cell's number is the largest over its sampled requests."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def gaps(served: dict, ref: dict, decoded: np.ndarray) -> Dict[str, float]:
    """``ref``: the reference's answer to the request; ``decoded``: the
    reference decoder's image of ``served["latents"]``."""
    lp, lr = np.asarray(served["latents"], np.float64), np.asarray(ref["latents"], np.float64)
    ip, ir = np.asarray(served["image"], np.float64), np.asarray(decoded, np.float64)
    if lp.shape != lr.shape or ip.shape != ir.shape:
        return {"latent_rel": float("inf"), "image_mae": float("inf")}
    rel = np.linalg.norm(lp - lr) / max(np.linalg.norm(lr), 1e-30)
    return {"latent_rel": float(rel) if np.isfinite(rel) else float("inf"),
            "image_mae": float(np.abs(ip - ir).mean())}


def judge(readings: List[Dict[str, float]], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """name -> {"value": the largest reading, "limit": its limit}; a number
    with no reading reads infinite."""
    return {name: {"value": max((r[name] for r in readings), default=float("inf")), "limit": float(lim)}
            for name, lim in limits.items()}


def passed(numbers: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())

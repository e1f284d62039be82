"""The calibrated W8A8 VAE decoder against the bf16 one, at full width, on the CPU.

Decodes the same latent through the SD VAE decoder (``VAE_SD``: 512 channels,
random weights from seed 2, as ``from_synthetic`` builds it) in bf16 and
through its calibrated W8A8 form (calibrate on the latent -> ``quantize_graph_
weights`` -> ``use_uint8_arithmetic``), in the JAX package and in the
PyTorch port, both on the CPU, and prints the gap between the two images of
each package in levels of 255. Only the spatial size is cut (``--sample``
latent pixels); the widths are the model's.

The gap of the JAX package is the reference for the port's: where both are
of one size, it comes from per-tensor uint8 quantization of these random
weights, not from the port's W8A8 route. The port's and the JAX package's
W8A8 images are compared too.

Two latents: a standard-normal one (the scale of a trained UNet's output)
and the same times ``--wide`` (the scale of a random UNet's output).

Usage: python tools/vae_w8a8_gap.py [--sample 8] [--wide 30] [--seed 0]
Prints one JSON line last.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

VAE_SCALE = 0.18215


def to_image(y) -> np.ndarray:
    """(1, 3, H, W) decoder output -> (H, W, 3) uint8, as both pipelines map it."""
    if isinstance(y, torch.Tensor):
        y = y.float().numpy()
    x = (np.asarray(y, np.float32)[0].transpose(1, 2, 0) + 1.0) * 127.5
    return np.clip(x, 0, 255).astype(np.uint8)


def gap(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean": float(d.mean()), "max": int(d.max())}


def jax_side(sample: int, latents):
    from onnxstream_tpu.convert.quantize import quantize_graph_weights
    from onnxstream_tpu.models.sd.vae import VAE_SD, build_vae_decoder
    from onnxstream_tpu.runtime.config import SessionConfig
    from onnxstream_tpu.runtime.session import Session
    from onnxstream_tpu.runtime.weights import DictWeightsProvider

    g = build_vae_decoder(dataclasses.replace(VAE_SD, sample=sample), seed=2)
    text, weights = g.to_text(), g.weights
    qtext, qweights = quantize_graph_weights(text, weights)

    def run(txt, w, z, eager=False, **cfg):
        s = Session(config=SessionConfig(compute_dtype="bfloat16", fuse_ops_in_attention=True, **cfg),
                    weights_provider=DictWeightsProvider(dict(w)))
        s.read_string(txt)
        s.add_tensor("latent", z)
        out = s.run(eager=eager)
        return s, to_image(next(v for v in out.values() if v.ndim == 4))

    res = []
    for z in latents:
        _, img = run(text, weights, z)
        s, _ = run(text, weights, z, eager=True, range_data_calibrate=True)
        ranges = dict(s._executor().range_data.data)
        _, img_q = run(qtext, qweights, z, use_uint8_arithmetic=True, range_data=ranges)
        res.append((img, img_q))
    return res


def port_side(sample: int, latents):
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.models.sd.pipeline import qu8_decoder
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    cpu = torch.device("cpu")
    g = build_vae_decoder(dataclasses.replace(VAE_SD, sample=sample), seed=2)
    text, weights = g.to_text(), g.weights

    def run(s, z, eager=False):
        s.clear_tensors()
        s.add_tensor("latent", torch.from_numpy(z))
        out = s.run(eager=eager)
        return to_image(next(v for v in out.values() if v.ndim == 4))

    def float_session(**cfg):
        s = Session(SessionConfig(compute_dtype="bfloat16", fuse_ops_in_attention=True, device=cpu, **cfg),
                    weights_provider=DictWeightsProvider(params_from_numpy(weights)))
        s.read_string(text)
        return s

    res = []
    for z in latents:
        img = run(float_session(), z)
        cal = float_session(range_data_calibrate=True)
        run(cal, z, eager=True)
        ranges = dict(cal._executor().range_data.data)
        img_q = run(qu8_decoder(text, weights, ranges, "bfloat16", cpu), z)
        res.append((img, img_q))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sample", type=int, default=8, help="latent height and width")
    ap.add_argument("--wide", type=float, default=30.0, help="scale of the second latent")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    assert jax.default_backend() == "cpu"
    z0 = np.random.default_rng(args.seed).standard_normal((1, 4, args.sample, args.sample)).astype(np.float32)
    names = ["standard_normal", f"standard_normal_x{args.wide:g}"]
    # the decoder's input is the latent divided by the VAE scale, as the pipelines feed it
    latents = [z0 / np.float32(VAE_SCALE), z0 * np.float32(args.wide) / np.float32(VAE_SCALE)]
    t0 = time.perf_counter()
    jres = jax_side(args.sample, latents)
    t1 = time.perf_counter()
    pres = port_side(args.sample, latents)
    t2 = time.perf_counter()
    out = {"sample": args.sample, "image": 8 * args.sample, "jax_s": round(t1 - t0, 1), "port_s": round(t2 - t1, 1)}
    for name, (jf, jq), (pf, pq) in zip(names, jres, pres):
        out[name] = {"jax_w8a8_vs_bf16": gap(jq, jf), "port_w8a8_vs_bf16": gap(pq, pf),
                     "port_vs_jax_w8a8": gap(pq, jq), "port_vs_jax_bf16": gap(pf, jf)}
        print(f"{name}: W8A8 vs bf16 image, JAX {out[name]['jax_w8a8_vs_bf16']}, port "
              f"{out[name]['port_w8a8_vs_bf16']}; port vs JAX: W8A8 {out[name]['port_vs_jax_w8a8']}, "
              f"bf16 {out[name]['port_vs_jax_bf16']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()

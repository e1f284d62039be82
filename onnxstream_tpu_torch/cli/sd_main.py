"""`sd` CLI of the port — Stable Diffusion 1.5, SDXL and SDXL Turbo image generation.

Counterpart of ``onnxstream_tpu/cli/sd_main.py`` (reference
src/sd.cpp:2691-3329): prompt / neg-prompt / steps / seed / sampler / res,
the model folder, ``--xl`` / ``--turbo``, latents save / decode, previews,
tiled or full decode, N images, embedded parameters, ops tracing, and
``--decoder-calibrate`` (writes ``range_data.txt`` from the decode, the input
of a ``vae_decoder_qu8`` folder). ``--device`` is ``cuda`` (the default: the
first card, an error without one) or ``cpu``. ``--download`` fetches the
catalog model into ``--models-path`` first, as the JAX CLI does
(``utils/download.py``).

    python -m onnxstream_tpu_torch.cli.sd_main --synthetic tiny --device cpu --steps 2 -o out.png
    python -m onnxstream_tpu_torch.cli.sd_main --synthetic tiny --device cpu --xl --steps 2 -o xl.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sd", description=__doc__)
    p.add_argument("--models-path", "-m", default="", help="folder with converted models (reference layout)")
    p.add_argument("--prompt", default="a photo of an astronaut riding a horse on mars")
    p.add_argument("--neg-prompt", default="")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--sampler", default="euler_a")
    p.add_argument("--res", default="512x512")
    p.add_argument("--output", "-o", default="result.png")
    p.add_argument("--num", type=int, default=1, help="number of images")
    p.add_argument("--xl", action="store_true", help="SDXL")
    p.add_argument("--turbo", action="store_true", help="SDXL Turbo (no CFG)")
    p.add_argument("--cfg-scale", type=float, default=7.0)
    p.add_argument("--save-latents", default="")
    p.add_argument("--decode-latents", default="")
    p.add_argument("--preview-steps", action="store_true",
                   help="save a low-res latent-RGB projection per step")
    p.add_argument("--decode-steps", action="store_true",
                   help="full VAE decode per step (reference sd.cpp:1745-1768)")
    p.add_argument("--not-tiled", action="store_true",
                   help="full (non-tiled) VAE decode; tiled is the default, "
                        "matching the reference sd executable (sd.cpp m_tiled)")
    p.add_argument("--tiled", action="store_true", help="force tiled VAE decode (already the default)")
    p.add_argument("--embed-parameters", action="store_true")
    p.add_argument("--ops-printf", action="store_true")
    p.add_argument("--ops-times", action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16", "float16"])
    p.add_argument("--ram", action="store_true", help="weights resident (the default; no effect)")
    p.add_argument("--hbm-budget-mb", type=int, default=0, help="stream weights within this device budget")
    p.add_argument("--synthetic", choices=["tiny", "sd15"], default="", help="run random-weight models")
    p.add_argument("--download", action="store_true",
                   help="fetch the model from HF into --models-path if missing (reference sd.cpp:3101-3199)")
    p.add_argument("--decoder-calibrate", action="store_true",
                   help="record the decoder's activation ranges into range_data.txt")
    p.add_argument("--host-loop", action="store_true",
                   help="force the per-step host diffusion loop (default: the device loop for euler samplers)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the first NVIDIA card (an error without one); cpu only when asked")
    return p


def _suffixed(path: str, suffix: str) -> str:
    """result.png + _0 -> result_0.png."""
    root, ext = os.path.splitext(path)
    return f"{root}{suffix}{ext or '.png'}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline, save_image, upscale8x
    from onnxstream_tpu_torch.runtime.config import default_device

    device = default_device() if args.device == "cuda" else torch.device("cpu")
    w, h = (int(v) for v in args.res.split("x"))
    seed = args.seed if args.seed >= 0 else int(time.time()) % 100000
    tiled = args.tiled or not args.not_tiled

    if args.synthetic:
        pipe = StableDiffusionPipeline.from_synthetic(tiny=args.synthetic == "tiny", compute_dtype=args.compute_dtype,
                                                      device=device, xl=args.xl, turbo=args.turbo)
    elif args.models_path:
        if args.download:
            from onnxstream_tpu_torch.utils.download import download_model

            name = ("stable-diffusion-xl-turbo-1.0" if args.turbo
                    else "stable-diffusion-xl-base-1.0" if args.xl
                    else "stable-diffusion-1.5")
            download_model(name, args.models_path)
        pipe = StableDiffusionPipeline.from_dir(args.models_path, xl=args.xl, turbo=args.turbo,
                                                compute_dtype=args.compute_dtype, res=(w, h),
                                                hbm_budget_bytes=args.hbm_budget_mb << 20, device=device)
    else:
        print("error: provide --models-path or --synthetic", file=sys.stderr)
        return 2

    if args.ops_printf:
        pipe.unet.config.ops_printf = True
    if args.ops_times:
        pipe.unet.config.ops_times_printf = True
    if args.decoder_calibrate:
        pipe.calibrate_decoder(True)

    if args.decode_latents:
        lat = StableDiffusionPipeline.load_latents(args.decode_latents, pipe.lath, pipe.latw)
        save_image(pipe.decode(lat, tiled=tiled), args.output)
        print(f"decoded {args.decode_latents} -> {args.output}")
    else:
        for n in range(args.num):
            t0 = time.time()
            # euler-family runs without previews take the device loop
            on_device = (args.sampler in ("euler", "euler_a") and not args.preview_steps
                         and not args.decode_steps and not args.host_loop)
            kw = dict(steps=args.steps, seed=seed + n, sampler=args.sampler, cfg_scale=args.cfg_scale,
                      decode=not args.save_latents, tiled_decode=tiled)
            if on_device:
                res = pipe.generate_on_device(args.prompt, args.neg_prompt, **kw)
            else:
                res = pipe.generate(args.prompt, args.neg_prompt, preview_steps=args.preview_steps,
                                    decode_steps=args.decode_steps, **kw)
            out = args.output if args.num == 1 else _suffixed(args.output, f"_{n}")
            if args.save_latents:
                StableDiffusionPipeline.save_latents(args.save_latents, res.latents)
                print(f"saved latents -> {args.save_latents}")
            elif res.image is not None:
                params = (
                    f"{args.prompt}\nNegative prompt: {args.neg_prompt}\n"
                    f"Steps: {args.steps}, Sampler: {args.sampler}, CFG scale: {args.cfg_scale}, "
                    f"Seed: {seed + n}, Size: {w}x{h}"
                ) if args.embed_parameters else None
                save_image(res.image, out, parameters=params)
                print(f"image {n + 1}/{args.num} -> {out}  ({time.time() - t0:.1f}s)")
            for i, pv in enumerate(res.previews):
                save_image(upscale8x(pv), _suffixed(out, f"_preview_{i}"))
            for i, im in enumerate(res.step_images):
                save_image(im, _suffixed(out, f"_{i}"))

    if args.decoder_calibrate:
        path = "range_data.txt"
        ranges = pipe.calibration_ranges()
        if not ranges.data:
            print("error: --decoder-calibrate recorded nothing (no decode ran)", file=sys.stderr)
            return 2
        ranges.write(path)
        print(f"calibration ranges -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

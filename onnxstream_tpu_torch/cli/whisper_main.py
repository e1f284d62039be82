"""`whisper` CLI of the port — speech-to-text.

Counterpart of ``onnxstream_tpu/cli/whisper_main.py`` with the same flags, and
``--device`` (``cuda``, the default: the first card, or ``cpu``). Raw 16-bit
16 kHz audio -> log-mel -> encoder -> greedy decoder with token suppression
(reference examples/Whisper_wasm/index.html). `--synthetic` runs the tiny
random-weight config; `--models-path` loads converted encoder_fp32/ +
decoder_fp32/ model.txt directories.

    python -m onnxstream_tpu_torch.cli.whisper_main --synthetic --audio jfk.raw --device cpu
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="whisper", description=__doc__)
    p.add_argument("--audio", required=True,
                   help="16-bit little-endian 16 kHz mono raw file (e.g. the reference's jfk.raw)")
    p.add_argument("--models-path", "-m", default="")
    p.add_argument("--synthetic", action="store_true", help="tiny random-weight models")
    p.add_argument("--max-tokens", type=int, default=0)
    p.add_argument("--language-token", type=int, default=-1)
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the first NVIDIA card (an error without one); cpu only when asked")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from onnxstream_tpu_torch.models.whisper import WHISPER_BASE, WhisperPipeline
    from onnxstream_tpu_torch.models.whisper.mel import read_16bit_raw_audio
    from onnxstream_tpu_torch.runtime.config import default_device

    device = default_device() if args.device == "cuda" else torch.device("cpu")
    if args.synthetic:
        pipe = WhisperPipeline.from_synthetic(compute_dtype=args.compute_dtype, device=device)
    elif args.models_path:
        pipe = WhisperPipeline.from_dir(args.models_path, WHISPER_BASE,
                                        compute_dtype=args.compute_dtype, device=device)
    else:
        print("error: provide --models-path or --synthetic", file=sys.stderr)
        return 2

    audio = read_16bit_raw_audio(args.audio)
    toks = pipe.transcribe(
        audio,
        max_tokens=args.max_tokens or None,
        language_token=args.language_token if args.language_token >= 0 else None,
    )
    print("tokens:", toks)
    if pipe.id_to_token:
        print("text:", pipe.decode_text(toks))
    return 0


if __name__ == "__main__":
    sys.exit(main())

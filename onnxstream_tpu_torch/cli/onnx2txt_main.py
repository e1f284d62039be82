"""`onnx2txt` CLI of the port: ONNX -> model.txt + .bin conversion.

Counterpart of ``onnxstream_tpu/cli/onnx2txt_main.py`` with the same flags:
the command-line re-host of the reference converter notebook (reference
onnx2txt/onnx2txt.ipynb, papermill parameters ONNX_FILENAME / DEST_FOLDER /
CONVERT_TO_FP16 / QUANTIZE_UINT8). Shape inference runs the port's ops on
the CPU and on ``meta`` tensors; no device is needed.

    python -m onnxstream_tpu_torch.cli.onnx2txt_main model.onnx out_dir [--fp16]
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="onnx2txt", description=__doc__)
    p.add_argument("onnx_file")
    p.add_argument("dest_folder")
    p.add_argument("--fp16", action="store_true", help="convert fp32 weights to fp16")
    p.add_argument("--quantize-uint8", action="store_true", help="percentile uint8 weight quantization")
    p.add_argument("--no-mangle", action="store_true", help="keep original tensor names")
    p.add_argument("--input-shape", action="append", default=[],
                   metavar="NAME=1,3,224,224", help="pin a dynamic graph input shape (repeatable)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from onnxstream_tpu_torch.convert.onnx2txt import convert

    shapes = {}
    for spec in args.input_shape:
        name, _, dims = spec.partition("=")
        shapes[name] = tuple(int(d) for d in dims.split(","))
    text = convert(args.onnx_file, args.dest_folder, fp16=args.fp16,
                   quantize=args.quantize_uint8, mangle=not args.no_mangle,
                   input_shapes=shapes or None)
    print(f"{len(text.splitlines())} ops -> {args.dest_folder}/model.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())

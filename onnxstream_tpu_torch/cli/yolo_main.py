"""`yolo` CLI of the port — YOLOv8n object detection on an image file.

Counterpart of ``onnxstream_tpu/cli/yolo_main.py`` with the same flags, and
``--device`` (``cuda``, the default: the first card, or ``cpu``). Image ->
640x640 RGBA -> injected pre-ops -> YOLOv8n -> injected post-ops -> NMS ->
labeled boxes (reference examples/YOLOv8n_wasm/index.html).

    python -m onnxstream_tpu_torch.cli.yolo_main --model yolov8n_fp32/model.txt --image in.png --device cuda
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yolo", description=__doc__)
    p.add_argument("--model", "-m", required=True, help="path to yolov8n model.txt (weights .bin beside it)")
    p.add_argument("--image", "-i", required=True)
    p.add_argument("--output", "-o", default="", help="save a copy with boxes drawn")
    p.add_argument("--iou-threshold", type=float, default=0.45)
    p.add_argument("--score-threshold", type=float, default=0.25)
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the first NVIDIA card (an error without one); cpu only when asked")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch
    from PIL import Image

    from onnxstream_tpu_torch.models.yolo import COCO_LABELS, YoloPipeline
    from onnxstream_tpu_torch.runtime.config import default_device

    device = default_device() if args.device == "cuda" else torch.device("cpu")
    pipe = YoloPipeline.from_model_txt(args.model, compute_dtype=args.compute_dtype, device=device)
    im = Image.open(args.image).convert("RGBA").resize((pipe.size, pipe.size))
    dets = pipe.detect(np.asarray(im, np.float32),
                       iou_threshold=args.iou_threshold,
                       score_threshold=args.score_threshold)
    for box, score, cls in dets:
        y1, x1, y2, x2 = (float(v) for v in box)
        label = COCO_LABELS[cls] if 0 <= cls < len(COCO_LABELS) else str(cls)
        print(f"{label:>16s}  {score:.3f}  [{x1:6.1f}, {y1:6.1f}, {x2:6.1f}, {y2:6.1f}]")
    if not dets.indices:
        print("no detections")
    if args.output:
        from PIL import ImageDraw

        draw_im = im.convert("RGB")
        d = ImageDraw.Draw(draw_im)
        for box, score, cls in dets:
            y1, x1, y2, x2 = (float(v) for v in box)
            d.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=2)
            d.text((x1 + 2, max(y1 - 10, 0)), COCO_LABELS[cls] if cls < len(COCO_LABELS) else str(cls))
        draw_im.save(args.output)
        print(f"saved -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

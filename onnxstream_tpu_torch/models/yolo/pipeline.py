"""YOLOv8n object detection pipeline.

Counterpart of the reference browser example (reference
examples/YOLOv8n_wasm/index.html). The pre/post processing ops are injected
AS TEXT around the converted model.txt — the text IR is an authoring surface
(index.html:413-421) — and the detection postprocess reproduces runModel
(index.html:547-614): xywh -> [y1,x1,y2,x2], per-anchor class argmax, then
the TF.js NonMaxSuppressionV3 algorithm (NonMaxSuppression.js:1-243).

Counterpart of ``onnxstream_tpu/models/yolo/pipeline.py``: the same text ops,
labels and host NMS, on the port's Session with an explicit ``device`` (None
means the first CUDA card and raises without one; the CPU only when asked).
The (8400, 84) detections cross to the host once, for the NMS.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

import torch

from onnxstream_tpu_torch.runtime.config import SessionConfig, default_device
from onnxstream_tpu_torch.runtime.session import Session

# reference index.html:413-421 — identical op lines
YOLO_PRE_OPS = (
    "pre_0:Slice*input:images_raw();slice_start();slice_end();slice_axis()*output:slice_output()\n"
    "pre_1:Transpose*input:slice_output()*output:trans_output()*perm:0,3,1,2\n"
    "pre_2:Div*input:trans_output();div_value()*output:images()\n"
)
YOLO_POST_OPS = (
    "post_0:Transpose*input:output0()*output:trans2_output()*perm:0,2,1\n"
    "post_1:Split*input:trans2_output();split_arg()*output:output0_0();output0_1()*axis:2"
)

COCO_LABELS = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck",
    "boat", "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass", "cup",
    "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


def _iou(boxes: np.ndarray, i: int, j: int) -> float:
    """[y1,x1,y2,x2] IoU (reference NonMaxSuppression.js intersectionOverUnion)."""
    ymin_i, xmin_i, ymax_i, xmax_i = boxes[i]
    ymin_j, xmin_j, ymax_j, xmax_j = boxes[j]
    area_i = (ymax_i - ymin_i) * (xmax_i - xmin_i)
    area_j = (ymax_j - ymin_j) * (xmax_j - xmin_j)
    if area_i <= 0 or area_j <= 0:
        return 0.0
    ymin = max(ymin_i, ymin_j)
    xmin = max(xmin_i, xmin_j)
    ymax = min(ymax_i, ymax_j)
    xmax = min(xmax_i, xmax_j)
    inter = max(ymax - ymin, 0.0) * max(xmax - xmin, 0.0)
    return inter / (area_i + area_j - inter)


def non_max_suppression(
    boxes: np.ndarray,
    scores: np.ndarray,
    max_output_size: int = 500,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
) -> List[int]:
    """Hard NMS, TF.js nonMaxSuppressionV3Impl semantics (softNmsSigma=0):
    candidates above score_threshold, popped by descending score, rejected if
    IoU with any already-selected box >= iou_threshold."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32).reshape(-1)
    order = np.argsort(-scores, kind="stable")
    order = [int(i) for i in order if scores[i] > score_threshold]
    selected: List[int] = []
    for i in order:
        if len(selected) >= max_output_size:
            break
        if any(_iou(boxes, i, j) >= iou_threshold for j in selected):
            continue
        selected.append(i)
    return selected


@dataclasses.dataclass
class Detections:
    boxes: np.ndarray  # (n, 4) [y1, x1, y2, x2] in input pixels
    scores: np.ndarray  # (n,)
    classes: np.ndarray  # (n,) int
    indices: List[int]  # NMS-selected rows

    def __iter__(self):
        for i in self.indices:
            yield self.boxes[i], float(self.scores[i]), int(self.classes[i])


class YoloPipeline:
    """images_raw (1,640,640,4) RGBA float -> Detections."""

    def __init__(self, session: Session, size: int = 640):
        self.session = session
        self.size = size

    @classmethod
    def from_model_txt(cls, path: str, compute_dtype: str = "float32",
                       provider: str = "ram+prefetch", size: int = 640,
                       device: Optional[torch.device] = None) -> "YoloPipeline":
        model_txt = open(path).read()
        device = default_device() if device is None else torch.device(device)
        s = Session(config=SessionConfig(compute_dtype=compute_dtype, device=device),
                    weights_provider_name=provider)
        s.read_string(YOLO_PRE_OPS + model_txt + "\n" + YOLO_POST_OPS,
                      weights_dir=os.path.dirname(os.path.abspath(path)))
        return cls(s, size=size)

    def detect(self, rgba: np.ndarray, iou_threshold: float = 0.45,
               score_threshold: float = 0.25, max_output_size: int = 500) -> Detections:
        """rgba: (size, size, 3|4) uint8 or float in [0, 255]."""
        sz = self.size
        rgba = np.asarray(rgba, np.float32)
        if rgba.shape[-1] == 3:  # pad an alpha channel; pre-op slices it off
            rgba = np.concatenate([rgba, np.full(rgba.shape[:-1] + (1,), 255, np.float32)], -1)
        s = self.session
        s.clear_tensors()
        s.add_tensor("images_raw", rgba.reshape(1, sz, sz, 4))
        # the pre/post op arguments arrive as tensors, exactly like the
        # browser client pushes them (index.html:559-564)
        s.add_tensor("slice_start", np.array([0], np.int64))
        s.add_tensor("slice_end", np.array([3], np.int64))
        s.add_tensor("slice_axis", np.array([3], np.int64))
        s.add_tensor("div_value", np.array([255.0], np.float32))
        s.add_tensor("split_arg", np.array([4, 80], np.int64))
        out = s.run()
        b = np.asarray(out["output0_0"], np.float32)[0]  # (8400, 4) xywh
        sc = np.asarray(out["output0_1"], np.float32)[0]  # (8400, 80)

        x, y, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        x1, y1 = x - w / 2, y - h / 2
        boxes = np.stack([y1, x1, y1 + h, x1 + w], axis=1)
        classes = sc.argmax(axis=1).astype(np.int32)
        scores = sc.max(axis=1)
        idx = non_max_suppression(boxes, scores, max_output_size, iou_threshold, score_threshold)
        return Detections(boxes=boxes, scores=scores, classes=classes, indices=idx)

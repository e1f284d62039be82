from onnxstream_tpu_torch.models.yolo.pipeline import (  # noqa: F401
    COCO_LABELS,
    YOLO_POST_OPS,
    YOLO_PRE_OPS,
    YoloPipeline,
    non_max_suppression,
)

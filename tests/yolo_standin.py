"""A stand-in for a converted YOLOv8n graph: the model's I/O contract only.

It is NOT YOLOv8n. The converted ``yolov8n_fp32`` folder is not in this
repository, so the detection pipeline (the injected pre / post text ops, the
model, the host NMS) is driven around this graph instead: ``images`` (1, 3,
S, S) -> ``output0`` (1, 84, A), with A = (S/8)^2 + (S/16)^2 + (S/32)^2
anchors (8400 at S = 640), as YOLOv8n's three detection strides give. Per
stride: a patchifying Conv (kernel = stride), SiLU, a 5 x 5 MaxPool (SPPF's
pool), a 1 x 1 Conv to 84 rows; the rows of all strides concatenated,
Sigmoid, then scaled: x, y to [0, S], w, h to [0, S/8], the 80 class scores
left in [0, 1] with a negative bias, so that a few dozen anchors pass a 0.25
score threshold. Random weights from a seed. Imports no JAX: the tests and
``chip_smoke.py`` use it.
"""

import os

import numpy as np

from onnxstream_tpu_torch.convert.builder import GraphBuilder

STRIDES = (8, 16, 32)
FEATURES = 16
CLASS_BIAS = -9.5


def anchors(size: int) -> int:
    return sum((size // s) ** 2 for s in STRIDES)


def build_standin(size: int = 640, seed: int = 0) -> GraphBuilder:
    g = GraphBuilder(seed=seed)
    rng = np.random.default_rng(seed)
    x = g.input("images", (1, 3, size, size))
    rows = []
    for s in STRIDES:
        h = size // s
        w1 = rng.standard_normal((FEATURES, 3, s, s), dtype=np.float32) / np.float32(np.sqrt(3 * s * s))
        y = g.emit("Conv", [x, g.weight(f"stem{s}.weight", w1 * 4),
                            g.weight(f"stem{s}.bias", rng.standard_normal(FEATURES, dtype=np.float32))],
                   [(1, FEATURES, h, h)],
                   {"dilations": "1,1", "group": 1, "kernel_shape": f"{s},{s}", "pads": "0,0,0,0",
                    "strides": f"{s},{s}"}, name=f"stem{s}")
        y = g.silu(y)
        y = g.emit("MaxPool", [y], [(1, FEATURES, h, h)],
                   {"kernel_shape": "5,5", "strides": "1,1", "pads": "2,2,2,2"}, name=f"pool{s}")
        bias = np.zeros(84, np.float32)
        bias[4:] = CLASS_BIAS
        w2 = rng.standard_normal((84, FEATURES, 1, 1), dtype=np.float32) / np.float32(np.sqrt(FEATURES))
        y = g.emit("Conv", [y, g.weight(f"head{s}.weight", w2), g.weight(f"head{s}.bias", bias)],
                   [(1, 84, h, h)],
                   {"dilations": "1,1", "group": 1, "kernel_shape": "1,1", "pads": "0,0,0,0", "strides": "1,1"},
                   name=f"head{s}")
        rows.append(g.reshape(y, (1, 84, h * h), name=f"flat{s}"))
    y = g.sigmoid(g.concat(rows, axis=2, name="rows"))
    scale = np.ones((84, 1), np.float32)
    scale[:2] = size
    scale[2:4] = size / 8
    y = g.mul(y, g.weight("scale", scale), name="boxes")
    g.emit("Identity", [y], [y.shape], name="out", out_names=["output0"])
    return g


def write_standin(directory: str, size: int = 640, seed: int = 0) -> str:
    """model.txt and its .bin weights in `directory`; returns model.txt's path."""
    build_standin(size, seed).save(directory)
    return os.path.join(directory, "model.txt")


def standin_image(size: int, seed: int = 0) -> np.ndarray:
    """A (size, size, 4) RGBA image in [0, 255] from a seed: smooth blobs over
    noise, so that neighbouring anchors see related pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = rng.random((size, size, 4), dtype=np.float32) * 64
    for _ in range(6):
        cy, cx, r = rng.random(3, dtype=np.float32) * np.float32([1, 1, 0.2]) + np.float32([0, 0, 0.05])
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        img += blob * rng.random(4, dtype=np.float32) * 190
    img[..., 3] = 255
    return np.clip(img, 0, 255)

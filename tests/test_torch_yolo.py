"""The port's YOLO detection pipeline against the JAX package, on the CPU.

The host NMS equal to JAX's on the edge cases of tests/test_yolo.py and on
seeded random boxes; ``YoloPipeline.detect`` on a stand-in head folder
(tests/yolo_standin.py: YOLOv8n's I/O contract, not YOLOv8n) with boxes within
1e-4 and equal NMS indices; the CLI printing what the JAX CLI prints.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from onnxstream_tpu.cli.yolo_main import main as jax_cli
from onnxstream_tpu.models.yolo import pipeline as jax_yolo
from onnxstream_tpu_torch.cli.yolo_main import main as port_cli
from onnxstream_tpu_torch.models.yolo import pipeline as port_yolo
from yolo_standin import anchors, standin_image, write_standin

CPU = torch.device("cpu")


def test_text_ops_and_labels_match_jax():
    assert port_yolo.YOLO_PRE_OPS == jax_yolo.YOLO_PRE_OPS
    assert port_yolo.YOLO_POST_OPS == jax_yolo.YOLO_POST_OPS
    assert port_yolo.COCO_LABELS == jax_yolo.COCO_LABELS and len(port_yolo.COCO_LABELS) == 80


# (boxes, scores, kwargs) of tests/test_yolo.py's NMS cases
EDGE_CASES = {
    "basic_suppression": ([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], [0.9, 0.8, 0.7],
                          dict(iou_threshold=0.45, score_threshold=0.25)),
    "score_threshold": ([[0, 0, 10, 10], [50, 50, 60, 60]], [0.9, 0.1], dict(score_threshold=0.25)),
    "descending_and_cap": ([[i * 100, 0, i * 100 + 10, 10] for i in range(5)], [0.3, 0.9, 0.5, 0.8, 0.7],
                           dict(max_output_size=3)),
    "iou_exactly_at_threshold": ([[0, 0, 10, 10], [0, 5, 10, 15]], [0.9, 0.8], dict(iou_threshold=1 / 3)),
    "iou_just_under_threshold": ([[0, 0, 10, 10], [0, 5, 10, 15]], [0.9, 0.8], dict(iou_threshold=0.34)),
    "empty_boxes": ([[0, 0, 0, 10], [0, 0, 0, 10]], [0.9, 0.8], dict()),
    "ties_keep_index_order": ([[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 10, 10]], [0.5, 0.5, 0.5], dict()),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_nms_edge_cases_match_jax(case):
    boxes, scores, kw = EDGE_CASES[case]
    boxes, scores = np.asarray(boxes, np.float32), np.asarray(scores, np.float32)
    assert port_yolo.non_max_suppression(boxes, scores, **kw) == jax_yolo.non_max_suppression(boxes, scores, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_nms_random_boxes_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    yx = rng.random((n, 2), dtype=np.float32) * 600
    hw = rng.random((n, 2), dtype=np.float32) * 80 + 1
    boxes = np.concatenate([yx, yx + hw], axis=1)
    scores = rng.random(n, dtype=np.float32)
    for kw in (dict(), dict(iou_threshold=0.2, score_threshold=0.5, max_output_size=20)):
        want = jax_yolo.non_max_suppression(boxes, scores, **kw)
        assert port_yolo.non_max_suppression(boxes, scores, **kw) == want and want
    i, j = 3, 7
    assert port_yolo._iou(boxes, i, j) == jax_yolo._iou(boxes, i, j)


@pytest.fixture(scope="module")
def standin_folder(tmp_path_factory):
    """A stand-in head at 128 x 128 (336 anchors) written as a converted model
    folder: model.txt and its .bin weights."""
    d = tmp_path_factory.mktemp("standin128")
    return write_standin(str(d), size=128, seed=3)


@pytest.mark.parametrize("channels", [4, 3])
def test_detect_matches_jax(standin_folder, channels):
    jp = jax_yolo.YoloPipeline.from_model_txt(standin_folder, size=128)
    pp = port_yolo.YoloPipeline.from_model_txt(standin_folder, size=128, device=CPU)
    img = standin_image(128, seed=1)[..., :channels]
    for kw in (dict(), dict(score_threshold=0.05, iou_threshold=0.3, max_output_size=40)):
        want, got = jp.detect(img, **kw), pp.detect(img, **kw)
        assert got.boxes.shape == (anchors(128), 4) and got.classes.dtype == want.classes.dtype
        np.testing.assert_allclose(got.boxes, want.boxes, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.classes, want.classes)
        assert got.indices == want.indices and got.indices
        assert [c for _, _, c in got] == [c for _, _, c in want]


def test_detect_without_a_device_needs_the_card(standin_folder):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_yolo.YoloPipeline.from_model_txt(standin_folder, size=128)


def test_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    """At the pipeline's 640 x 640 (the CLI's size) on a stand-in folder: the
    same labelled boxes, and an image with them drawn."""
    model = write_standin(str(tmp_path / "standin640"), size=640, seed=0)
    img = tmp_path / "in.png"
    Image.fromarray((standin_image(320, seed=2)[..., :3]).astype(np.uint8)).save(str(img))
    argv = ["--model", model, "--image", str(img)]
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    out = tmp_path / "out.png"
    assert port_cli(argv + ["--device", "cpu", "--output", str(out)]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[:-1] == want.splitlines() and len(want.splitlines()) > 1
    assert out.exists() and Image.open(str(out)).size == (640, 640)

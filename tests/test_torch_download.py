"""The port's downloader (utils/download.py) on file:// sources, no network.

The four cases of tests/test_download.py, each also held to the JAX
package's copy: the same manifest, the same catalog, the same files fetched.
"""

import os

import numpy as np

from onnxstream_tpu.utils import download as jax_download
from onnxstream_tpu_torch.utils.download import MODEL_CATALOG, download_model, weights_manifest


def _make_source(src):
    os.makedirs(src, exist_ok=True)
    model = (
        "m:Mul*input:x(2,2);w_nchw.bin(float32:1,2,1,1)*output:y(2,2)\n"
        "a:Add*input:y(2,2);b.bin(float32:2)*output:z(2,2)\n"
    )
    open(os.path.join(src, "model.txt"), "w").write(model)
    np.arange(2, dtype=np.float32).tofile(os.path.join(src, "w_nchw.bin"))
    np.arange(2, dtype=np.float32).tofile(os.path.join(src, "w_nhwc.bin"))
    np.arange(2, dtype=np.float32).tofile(os.path.join(src, "b.bin"))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_weights_manifest_nchw_rewrite(tmp_path):
    src = str(tmp_path / "src")
    _make_source(src)
    names = weights_manifest(os.path.join(src, "model.txt"))
    assert "w_nhwc.bin" in names and "w_nchw.bin" in names and "b.bin" in names
    assert names == jax_download.weights_manifest(os.path.join(src, "model.txt"))


def test_download_from_file_url(tmp_path):
    src = str(tmp_path / "src")
    dst = str(tmp_path / "dst")
    _make_source(src)
    download_model(f"file://{src}/", dst, files=["model.txt"], progress=False)
    for f in ("model.txt", "w_nchw.bin", "w_nhwc.bin", "b.bin"):
        assert os.path.exists(os.path.join(dst, f)), f
        assert open(os.path.join(dst, f), "rb").read() == open(os.path.join(src, f), "rb").read()
    jdst = str(tmp_path / "jax_dst")
    jax_download.download_model(f"file://{src}/", jdst, files=["model.txt"], progress=False)
    assert _tree(dst) == _tree(jdst)


def test_download_skips_existing(tmp_path):
    src = str(tmp_path / "src")
    dst = str(tmp_path / "dst")
    _make_source(src)
    download_model(f"file://{src}/", dst, files=["model.txt"], progress=False)
    marker = os.path.join(dst, "b.bin")
    open(marker, "wb").write(b"\x01\x02\x03\x04\x05\x06\x07\x08")
    download_model(f"file://{src}/", dst, files=["model.txt"], progress=False)
    assert open(marker, "rb").read() == b"\x01\x02\x03\x04\x05\x06\x07\x08"


def test_catalog_matches_reference_layout():
    # reference src/sd.cpp:3036-3092, the JAX package's catalog
    assert MODEL_CATALOG == jax_download.MODEL_CATALOG
    sd = MODEL_CATALOG["stable-diffusion-1.5"]
    assert "unet_fp16/model.txt" in sd["files"]
    xl = MODEL_CATALOG["stable-diffusion-xl-base-1.0"]
    assert "sdxl_unet_fp16/model.txt" in xl["files"]
    turbo = MODEL_CATALOG["stable-diffusion-xl-turbo-1.0"]
    assert "sdxl_unet_anyshape_fp16/model.txt" in turbo["files"]


def test_weights_in_subfolders_are_fetched(tmp_path):
    """A weight name that holds a folder (the builder's `a/b.bin`, as the
    port's GraphBuilder.save writes it) lands in that folder; the JAX copy
    leaves the folder to the caller."""
    src = tmp_path / "src"
    (src / "blk").mkdir(parents=True)
    (src / "model.txt").write_text("a:Add*input:x(2);blk/b.bin(float32:2)*output:z(2)\n")
    np.arange(2, dtype=np.float32).tofile(str(src / "blk" / "b.bin"))
    dst = str(tmp_path / "dst")
    download_model(f"file://{src}/", dst, files=["model.txt"], progress=False)
    assert _tree(dst) == ["blk/b.bin", "model.txt"]

"""The port's JAX-free copies of the graph builder and parameter conversion.

The card has no JAX, so the port carries its own GraphBuilder and SD UNet
graph; they must produce what the JAX package's produce. Parameters cross
from the JAX package as numpy arrays (ml_dtypes.bfloat16 included) and must
arrive bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from onnxstream_tpu.convert.builder import GraphBuilder as JaxBuilder
from onnxstream_tpu.models.sd.unet import TINY as JAX_TINY
from onnxstream_tpu.models.sd.unet import build_unet as jax_build_unet
from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet, param_count
from onnxstream_tpu_torch.dtypes import DType
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_unet_tiny_matches_jax_builder():
    assert dataclasses.asdict(TINY) == dataclasses.asdict(JAX_TINY)
    g, jg = build_unet(TINY, seed=3), jax_build_unet(JAX_TINY, seed=3)
    assert g.to_text() == jg.to_text()
    assert list(g.weights) == list(jg.weights)
    for name, arr in jg.weights.items():
        assert g.weights[name].dtype == arr.dtype
        np.testing.assert_array_equal(g.weights[name], arr)
    assert param_count(g) == sum(a.size for a in jg.weights.values())


@pytest.mark.parametrize("which", ["clip", "vae"])
def test_clip_and_vae_builders_match_jax(which):
    """The copied CLIP and VAE builders: the same text and the same arrays
    as the JAX builders for the same seed (TINY), and the same text at full
    width (CLIP-L, VAE_SD; weights left lazy)."""
    from onnxstream_tpu.models.sd import clip as jax_clip
    from onnxstream_tpu.models.sd import vae as jax_vae
    from onnxstream_tpu_torch.models.sd import clip, vae

    if which == "clip":
        pairs = [(clip.CLIP_TINY, jax_clip.CLIP_TINY), (clip.CLIP_L, jax_clip.CLIP_L)]
        build, jax_build = clip.build_text_encoder, jax_clip.build_text_encoder
    else:
        pairs = [(vae.VAE_TINY, jax_vae.VAE_TINY), (vae.VAE_SD, jax_vae.VAE_SD)]
        build, jax_build = vae.build_vae_decoder, jax_vae.build_vae_decoder
    for (cfg, jcfg), lazy in zip(pairs, (False, True)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        g, jg = build(cfg, seed=3, lazy_weights=lazy), jax_build(jcfg, seed=3, lazy_weights=lazy)
        assert g.to_text() == jg.to_text()
        assert list(g.weights) == list(jg.weights)
        if not lazy:
            for name, arr in jg.weights.items():
                assert g.weights[name].dtype == arr.dtype
                np.testing.assert_array_equal(g.weights[name], arr)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, ml_dtypes.bfloat16, np.int64])
def test_params_from_numpy_is_bit_exact(dtype):
    a = (np.random.default_rng(0).standard_normal((3, 5)) * 100).astype(dtype)
    t = params_from_numpy({"w": a})["w"]
    assert tuple(t.shape) == a.shape and t.dtype == {
        np.float32: torch.float32, np.float16: torch.float16,
        ml_dtypes.bfloat16: torch.bfloat16, np.int64: torch.int64}[dtype]
    bits = torch.int16 if t.element_size() == 2 else t.dtype
    np.testing.assert_array_equal(t.view(bits).numpy().view(np.uint8), a.view(np.uint8))


def test_params_from_numpy_materializes_lazy_weights():
    """A LazyArray placeholder crosses unmaterialized (a big weight may be
    synthesized on the device instead); the provider materializes it when
    the host asks for the weight, with the builder's bits."""
    jb = JaxBuilder(seed=1, lazy_weights=True)
    jb.gen_weight("w", lambda: jb.randn(4, 6), shape=(4, 6))
    lazy = jb.weights["w.bin"]
    assert not isinstance(lazy, np.ndarray)
    p = params_from_numpy(jb.weights)["w.bin"]
    assert p is lazy and lazy._arr is None
    t = DictWeightsProvider({"w.bin": p}).get("w.bin", DType.float32, (4, 6))
    np.testing.assert_array_equal(t.numpy(), lazy.materialize())


def test_import_pulls_in_neither_jax_nor_ml_dtypes():
    """In a fresh interpreter (this test process has JAX loaded already)."""
    code = (
        "import sys, onnxstream_tpu_torch\n"
        "import onnxstream_tpu_torch.models.sd.unet, onnxstream_tpu_torch.kernels.flash_attention\n"
        "import onnxstream_tpu_torch.models.llm.pipeline, onnxstream_tpu_torch.cli.llm_main\n"
        "import onnxstream_tpu_torch.models.llm.hf, onnxstream_tpu_torch.kernels.qmatmul\n"
        "import onnxstream_tpu_torch.runtime.quantization, onnxstream_tpu_torch.convert.quantize\n"
        "import onnxstream_tpu_torch.models.sd.pipeline, onnxstream_tpu_torch.cli.sd_main\n"
        "import onnxstream_tpu_torch.kernels.qconv, onnxstream_tpu_torch.models.sd.clip\n"
        "import onnxstream_tpu_torch.models.sd.vae, onnxstream_tpu_torch.models.sd.samplers\n"
        "import onnxstream_tpu_torch.models.whisper, onnxstream_tpu_torch.models.whisper.hf\n"
        "import onnxstream_tpu_torch.models.yolo, onnxstream_tpu_torch.cli.whisper_main\n"
        "import onnxstream_tpu_torch.cli.yolo_main\n"
        "import onnxstream_tpu_torch.api.capi, onnxstream_tpu_torch.api.bindings\n"
        "import onnxstream_tpu_torch.cli.serve_main, onnxstream_tpu_torch.cli.compare_main\n"
        "import onnxstream_tpu_torch.runtime.weights, onnxstream_tpu_torch.runtime.native\n"
        "import onnxstream_tpu_torch.runtime.layout, onnxstream_tpu_torch.convert.onnx2txt\n"
        "import onnxstream_tpu_torch.convert.onnxproto, onnxstream_tpu_torch.cli.onnx2txt_main\n"
        "import onnxstream_tpu_torch.utils.download, onnxstream_tpu_torch.models.sd.hf\n"
        "import onnxstream_tpu_torch.parallel, onnxstream_tpu_torch.parallel.sharding\n"
        "import onnxstream_tpu_torch.parallel.spmd, onnxstream_tpu_torch.parallel.launch\n"
        "import onnxstream_tpu_torch.parallel.dryrun, onnxstream_tpu_torch.parallel.comm\n"
        "import onnxstream_tpu_torch.entry, onnxstream_tpu_torch.ops.collective\n"
        "bad = [m for m in ('jax', 'ml_dtypes', 'onnxstream_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_save_writes_subfolders_and_float16(tmp_path):
    """GraphBuilder.save: names holding '/' land in subfolders, and with
    float16 the float32 weights are written (and declared in model.txt) as
    float16, the reference's unet_fp16 layout; other dtypes stay."""
    from onnxstream_tpu_torch.ir import parse_model_txt

    g = build_unet(TINY, seed=3)
    g.save(str(tmp_path), float16=True)
    text = (tmp_path / "model.txt").read_text()
    want = parse_model_txt(g.to_text())
    got = parse_model_txt(text)
    assert any("/" in n for n in g.weights) and len(got.ops) == len(want.ops)
    for name, spec in want.weights.items():
        arr = np.asarray(g.weights[name])
        half = arr.dtype == np.float32
        assert got.weights[name].dtype == (DType.float16 if half else spec.dtype)
        assert got.weights[name].shape == spec.shape
        saved = np.fromfile(str(tmp_path / name), dtype=np.float16 if half else arr.dtype)
        np.testing.assert_array_equal(saved, (arr.astype(np.float16) if half else arr).reshape(-1))

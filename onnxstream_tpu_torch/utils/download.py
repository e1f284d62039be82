"""Model auto-download: manifest-driven parallel fetch.

Counterpart of ``onnxstream_tpu/utils/download.py``, which re-implements the
reference's HF downloader (reference src/sd.cpp:3030-3199,
src/llm.cpp:137-200): known model names map to HuggingFace repos; model.txt
files are fetched first, then each graph's weight files are listed from the
parsed model.txt (with the `_nchw.bin` -> also-fetch-`_nhwc.bin` rewrite),
and everything downloads via batched `curl --parallel` with one verbose
retry. `url_base` may also be a file:// or http://localhost source, which
the tests use. Unlike the JAX copy, a weight file whose name holds a folder
(the builder's `a/b.bin` names) gets that folder made first.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

from onnxstream_tpu_torch.ir import parse_model_txt

# reference model catalogs (src/sd.cpp:3036-3092, src/llm.cpp:151-156)
MODEL_CATALOG: Dict[str, Dict[str, object]] = {
    "stable-diffusion-1.5": {
        "url": "https://huggingface.co/vitoplantamura/stable-diffusion-1.5-onnxstream/resolve/main/",
        "files": [
            "tokenizer/vocab.txt",
            "tokenizer/merges.txt",
            "text_encoder_fp32/model.txt",
            "unet_fp16/model.txt",
            "vae_decoder_fp16/model.txt",
            "vae_decoder_qu8/model.txt",
            "vae_decoder_qu8/range_data.txt",
        ],
    },
    "stable-diffusion-xl-base-1.0": {
        "url": "https://huggingface.co/vitoplantamura/stable-diffusion-xl-base-1.0-onnxstream/resolve/main/",
        "files": [
            "sdxl_tokenizer/vocab.txt",
            "sdxl_tokenizer/merges.txt",
            "sdxl_text_encoder_1_fp32/model.txt",
            "sdxl_text_encoder_2_fp32/model.txt",
            "sdxl_unet_fp16/model.txt",
            "sdxl_vae_decoder_32x32_fp16/model.txt",
            "sdxl_vae_decoder_fp16/model.txt",
        ],
    },
    "stable-diffusion-xl-turbo-1.0": {
        "url": "https://huggingface.co/vitoplantamura/stable-diffusion-xl-turbo-1.0-anyshape-onnxstream/resolve/main/",
        "files": [
            "sdxl_tokenizer/vocab.txt",
            "sdxl_tokenizer/merges.txt",
            "sdxl_text_encoder_1_fp32/model.txt",
            "sdxl_text_encoder_2_fp32/model.txt",
            "sdxl_unet_anyshape_fp16/model.txt",
            "sdxl_vae_decoder_anyshape_fp16/model.txt",
        ],
    },
    "TinyLlama-1.1B-Chat-v0.3-fp16": {
        "url": "https://huggingface.co/vitoplantamura/onnxstream-llms/resolve/main/TinyLlama-1.1B-Chat-v0.3-fp16/",
        "files": ["vocab.txt", "model.txt"],
    },
    "Mistral-7B-Instruct-v0.2-fp16": {
        "url": "https://huggingface.co/vitoplantamura/onnxstream-llms/resolve/main/Mistral-7B-Instruct-v0.2-fp16/",
        "files": ["vocab.txt", "model.txt"],
    },
}


def _curl_batch(pairs: Sequence[Tuple[str, str]]) -> None:
    """Download (url, dest) pairs with one parallel curl invocation; silent
    first, verbose retry on failure (reference download_file, sd.cpp:3129-3146)."""
    if not pairs:
        return
    cmd = ["curl", "--location", "--fail", "--show-error", "--parallel"]
    for url, dest in pairs:
        cmd += ["-o", dest, url]
    r = subprocess.run(cmd + ["--silent"], capture_output=True)
    if r.returncode != 0:
        print(f"Download error, retrying: {' '.join(cmd)}")
        r = subprocess.run(cmd)
        if r.returncode != 0:
            raise IOError(f"download failed ({len(pairs)} files)")


def _fetch(pairs: Sequence[Tuple[str, str]], parallel: int) -> None:
    # download to `<dest>.part` and rename on success: a curl batch killed
    # mid-transfer must not leave a truncated file that the exists() check
    # would treat as complete forever
    pairs = [(u, d) for u, d in pairs if not os.path.exists(d)]
    local = [(u, d) for u, d in pairs if u.startswith("file://")]
    remote = [(u, d) for u, d in pairs if not u.startswith("file://")]
    for _u, d in pairs:
        os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
    for u, d in local:
        shutil.copyfile(u[len("file://"):], d)
    for i in range(0, len(remote), parallel):
        batch = remote[i : i + parallel]
        _curl_batch([(u, d + ".part") for u, d in batch])
        for _u, d in batch:
            os.replace(d + ".part", d)


def weights_manifest(model_txt_path: str) -> List[str]:
    """Dry-run a model.txt and list its weight files, rewriting `_nchw.bin`
    to also require `_nhwc.bin` (reference sd.cpp:3156-3183)."""
    with open(model_txt_path) as f:
        g = parse_model_txt(f.read(), allow_dynamic=True)
    names: List[str] = []
    for t in g.weights.values():
        fn = t.name
        if fn.endswith("_nchw.bin"):
            names.append(fn[: -len("_nchw.bin")] + "_nhwc.bin")
        names.append(fn)
    return names


def download_model(
    name_or_url: str,
    dest_dir: str,
    files: Optional[Sequence[str]] = None,
    parallel: int = 16,
    progress: bool = True,
) -> str:
    """Download a model (catalog name or explicit url base) into dest_dir.
    Returns dest_dir. Files already present are skipped."""
    if name_or_url in MODEL_CATALOG:
        entry = MODEL_CATALOG[name_or_url]
        url_base = str(entry["url"])
        files = list(entry["files"]) if files is None else list(files)
    else:
        url_base = name_or_url if name_or_url.endswith("/") else name_or_url + "/"
        if files is None:
            files = ["model.txt"]

    os.makedirs(dest_dir, exist_ok=True)
    for f in files:
        d = os.path.dirname(os.path.join(dest_dir, f))
        if d:
            os.makedirs(d, exist_ok=True)
    _fetch([(url_base + f, os.path.join(dest_dir, f)) for f in files], parallel)

    # second stage: per-model.txt weight manifests
    bins: List[Tuple[str, str]] = []
    for f in files:
        if not f.endswith("model.txt"):
            continue
        sub = os.path.dirname(f)
        for w in weights_manifest(os.path.join(dest_dir, f)):
            rel = os.path.join(sub, w) if sub else w
            bins.append((url_base + rel, os.path.join(dest_dir, rel)))
    total = len(bins)
    for i in range(0, total, parallel):
        if progress and total:
            print(f"\rDownloading weights: {min(i + parallel, total)}/{total}...", end="", flush=True)
        _fetch(bins[i : i + parallel], parallel)
    if progress and total:
        print(" done!")
    return dest_dir

"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card, its power limit, the CUDA and nvcc
     versions and the precision flags in effect;
  2. build: compile the flash-attention kernel from the checkout's source;
  3. kernel vs twin: the CUDA kernel against its plain PyTorch twin at the two
     SD1.5 site shapes and at GQA / causal edge cases, fp32 (TF32 off) and bf16,
     and the kernel's and twin's times at the SD1.5 shapes;
  4. slice: the SD1.5 UNet at full width (random weights from seed 0) in bf16
     through the port's Session answers three requests; each must be finite,
     (1, 4, 64, 64), and launch the flash kernel exactly 10 times; the first
     request is rerun with the flash kernel off and must agree; the TINY UNet
     in fp32 on the card must agree with the same graph run on the CPU.

The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SD15_SITES = [(4096, 40), (1024, 80)]  # (tokens, head dim) of the flash sites, 8 heads, 5 each


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
    name = card()
    print(f"card: {name}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")
    from onnxstream_tpu_torch.kernels import build

    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("nvcc:", nv.stdout.strip().splitlines()[-1])
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    print(f"precision flags in effect: matmul.allow_tf32={m.allow_tf32} cudnn.allow_tf32={c.allow_tf32} "
          f"matmul.allow_bf16_reduced_precision_reduction={m.allow_bf16_reduced_precision_reduction} "
          "(Session.run pins all three to False for its duration)")
    return name


def phase_build():
    from onnxstream_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build("flash_attention")
    print(f"build: flash_attention in {time.perf_counter() - t0:.1f} s -> {path}")
    print("\n".join(l for l in (path.parent / "build.log").read_text().splitlines()
                    if "registers" in l or "spill" in l))


def phase_kernel(name: str) -> dict:
    from onnxstream_tpu_torch.kernels.flash_attention import (
        flash_attention_packed, flash_attention_packed_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (label, b, m, n, heads, kv_heads, d, causal)
    cases = [
        ("sd15_d40", 1, 4096, 4096, 8, 8, 40, False),
        ("sd15_d80", 1, 1024, 1024, 8, 8, 80, False),
        ("gqa_causal", 2, 300, 700, 8, 2, 64, True),
        ("causal_m_gt_n", 1, 80, 24, 4, 4, 32, True),
        ("d160_fma_path", 1, 256, 512, 8, 8, 160, False),  # head dims > 128: CUDA-core variant
    ]
    worst_bf16 = 0.0
    for label, b, m, n, h, hkv, d, causal in cases:
        q32 = torch.randn(b, m, h * d, device="cuda", generator=gen)
        k32 = torch.randn(b, n, hkv * d, device="cuda", generator=gen)
        v32 = torch.randn(b, n, hkv * d, device="cuda", generator=gen)
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            out = flash_attention_packed(q, k, v, h, causal=causal)
            torch.cuda.synchronize()
            ref = flash_attention_packed_reference(q, k, v, h, causal=causal)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            print(f"kernel vs twin {label} {str(dt)[6:]}: max|diff| {err:.3e} (rtol=atol={tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash kernel disagrees with its twin on {label} {dt}")
            if label.startswith("sd15") and dt == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
            if m > n and causal:
                zero_rows = out[:, : m - n]
                if zero_rows.abs().max().item() != 0.0:
                    raise SystemExit(f"{label}: rows with no valid key are not exactly 0")
    times = {}
    for m, d in SD15_SITES:
        q = torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16)
        k = torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16)
        v = torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16)
        t_k = cuda_ms(lambda: flash_attention_packed(q, k, v, 8))
        t_p = cuda_ms(lambda: flash_attention_packed_reference(q, k, v, 8))
        times[f"{m}x{d}"] = (t_k, t_p)
        print(f"time bf16 (1, {m}, {8 * d}) h8 d{d}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms  [{name}]")
    per_step = [sum(5 * t[i] for t in times.values()) for i in (0, 1)]
    return {"max_abs_err": worst_bf16, "ms": per_step[0], "plain_ms": per_step[1],
            "ms_by_shape": {k: {"ms": v[0], "plain_ms": v[1]} for k, v in times.items()}}


def _session(g, compute_dtype: str, device: str):
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    cfg = SessionConfig(compute_dtype=compute_dtype, device=torch.device(device),
                        fuse_attention_heads=True)
    s = Session(cfg, weights_provider=DictWeightsProvider(params_from_numpy(g.weights)))
    s.read_string(g.to_text())
    return s


def _requests(cfg, seed: int):
    rng = np.random.default_rng(seed)
    hw = cfg.sample_size
    ctx = rng.standard_normal((1, cfg.context_len, cfg.cross_attention_dim)).astype(np.float32)
    return [
        {"sample": rng.standard_normal((1, cfg.in_channels, hw, hw)).astype(np.float32),
         "timestep": np.array([t], np.float32), "encoder_hidden_states": ctx}
        for t in (999.0, 500.0, 1.0)
    ]


def profile_steps(s, name: str, steps: int = 2) -> None:
    """Device time per step by kernel, and the device's busy share of the
    wall time, from a torch.profiler window over warm steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            s.run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        # kernel and copy events carry the device time; the CPU ops that
        # launched them would count it a second time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / steps, e.count // steps, e.key))
    dev_ms = sum(r[0] for r in rows)
    if not rows:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile over {steps} warm steps [{name}]: wall {wall_ms:.2f} ms/step (profiler on), "
          f"device busy {dev_ms:.2f} ms/step = {100 * dev_ms / wall_ms:.1f}% of wall")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:8.3f} ms/step  {n:5d}x  {key[:90]}")


def phase_slice(name: str) -> int:
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed
    from onnxstream_tpu_torch.models.sd.unet import SD15, TINY, build_unet, param_count

    # small input first: the op library on the card against the CPU
    gt = build_unet(TINY)
    req = _requests(TINY, 1)[1]
    outs = []
    for dev in ("cuda:0", "cpu"):
        s = _session(gt, "float32", dev)
        for k, v in req.items():
            s.add_tensor(k, v)
        outs.append(s.run()["out_sample"])
    dev_err = float(np.abs(outs[0] - outs[1]).max())
    bound = 1e-4 * float(np.abs(outs[1]).max())
    print(f"TINY UNet fp32 card vs CPU: max|diff| {dev_err:.3e} (bound {bound:.3e})")
    if not dev_err <= bound:
        raise SystemExit("TINY UNet on the card disagrees with the CPU run")

    t0 = time.perf_counter()
    g = build_unet(SD15, seed=0)
    print(f"SD15 UNet: {param_count(g) / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s = _session(g, "bfloat16", "cuda:0")
    n_sdpa = sum(op.op_type == "ostpu.sdpa" for op in s.graph.ops)
    print(f"fused graph: {len(s.graph.ops)} ops, {n_sdpa} ostpu.sdpa sites")
    reqs = _requests(SD15, 0)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_packed.launches = 0
    results = []
    for i, req in enumerate(reqs):
        for k, v in req.items():
            s.add_tensor(k, v)
        t1 = time.perf_counter()
        out = s.run()["out_sample"]
        ms = (time.perf_counter() - t1) * 1e3
        results.append(out)
        want = 10 * (i + 1)
        print(f"request {i} (t={req['timestep'][0]:g}): {out.shape} finite={np.isfinite(out).all()} "
              f"max|out|={np.abs(out).max():.4f} {ms:.1f} ms, flash launches so far "
              f"{flash_attention_packed.launches}")
        if out.shape != (1, 4, 64, 64) or not np.isfinite(out).all():
            raise SystemExit(f"request {i}: bad output")
        if flash_attention_packed.launches != want:
            raise SystemExit(f"request {i}: {flash_attention_packed.launches} flash launches, want {want}")
    launches = flash_attention_packed.launches
    print(f"first request incl. plan + weight upload: {(time.perf_counter() - t0):.1f} s since session build")
    stats = s.hbm_stats()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        s.run()
        times.append((time.perf_counter() - t1) * 1e3)
    print(f"SD15 UNet step bf16, warm: median {np.median(times):.2f} ms over 5 runs "
          f"(min {min(times):.2f}) [{name}]")
    print(f"peak device memory {stats['peak_bytes_in_use'] / 2**20:.1f} MB, weights "
          f"{stats['weight_bytes'] / 2**20:.1f} MB [{name}]")
    profile_steps(s, name)
    if len(results) != 3 or np.allclose(results[0], results[1]):
        raise SystemExit("requests did not give distinct outputs")

    s.set_option("use_flash_attention", False)
    for k, v in reqs[0].items():
        s.add_tensor(k, v)
    plain = s.run()["out_sample"]
    diff = float(np.abs(plain - results[0]).max())
    ref = float(np.abs(results[0]).max())
    print(f"flash on vs off, request 0: max|diff| {diff:.4e}, max|out| {ref:.4f}, "
          f"ratio {diff / ref:.4e} (bound 5e-2)")
    if not diff <= 5e-2 * ref:
        raise SystemExit("flash-on and flash-off outputs disagree")
    t_off = []
    for _ in range(3):
        t1 = time.perf_counter()
        s.run()
        t_off.append((time.perf_counter() - t1) * 1e3)
    print(f"SD15 UNet step bf16 with flash off: median {np.median(t_off):.2f} ms over 3 runs [{name}]")
    return launches


def main() -> int:
    sys.path.insert(0, REPO)
    name = phase_device()
    phase_build()
    kernel = phase_kernel(name)
    launches = phase_slice(name)
    print(f"card: {name}")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_packed",
        "route": "cuda",
        "source": "onnxstream_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "onnxstream_tpu/kernels/flash_attention.py:260",
        "launches": launches,
        **kernel,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

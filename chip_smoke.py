"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card, its power limit, the CUDA and nvcc
     versions and the precision flags in effect;
  2. build: compile every kernel source of the checkout (flash_attention.cu,
     qmatmul.cu, qlinear.cu, gn_conv.cu, matmul.cu), one nvcc each, all
     started together;
  3. kernel vs twin: every wrapper of a CUDA kernel against its plain PyTorch
     twin, fp32 (TF32 off) and bf16:
       - flash_attention_packed at the two SD1.5 UNet site shapes, the VAE
         mid-block site (1 head, d = 512, 4096 tokens) and at GQA / causal /
         d = 512 edge cases; flash_attention at the three TinyLlama prefill
         sites (1024 x 1024, 128 x 1024, 512 x 512) and at every mask group,
         k_transposed, GQA, causal M > N (exactly 0) and D = 128 / 256;
       - w8a8_dyn_matmul at every TinyLlama MatMul shape (M 1 / 128 / 512 /
         1024) and w8_matmul at ragged shapes, per-tensor and per-channel;
       - qmatmul and qconv (the calibrated W8A8 kernels) at ragged shapes,
         both weight layouts, strides / dilations / pads, float32, bf16 and
         requantized uint8 outputs, bit for bit;
       - gn_silu, gn_silu_conv and matmul (with conv3x3_im2col) at the JAX
         suite's ragged cases (C/G = 5 and 10, H W = 35, 5 x 7 borders, no
         bias, O != C, batch 2) in float32 / bfloat16 / float16, and at the
         sites of the GroupNorm and small-conv routes;
     with each kernel's time beside its twin's, its bound and one PyTorch
     call computing the same function where there is one
     (scaled_dot_product_attention, torch._int_mm, a bf16 matmul,
     F.group_norm + F.silu [+ F.conv2d], torch.addmm);
  4. SD slice: the SD1.5 UNet at full width (random weights from seed 0) in
     bf16 through the port's Session answers three requests; each must be
     finite, (1, 4, 64, 64), and launch the packed kernel exactly 10 times;
     the first request is rerun with the flash kernel off and must agree; the
     TINY UNet in fp32 on the card must agree with the same graph run on the
     CPU;
  4b. SD slice under the optional routes, bf16, batch 1: the TINY UNet in
     fp32 under config A (fuse_gn_conv + fuse_groupnorm) and config B
     (use_pallas_smallconv + fuse_groupnorm) on the card against the CPU;
     the SD15 UNet at full width answers the three requests under A and
     under B, each output within 5e-2 * max|out| of the default config's, the
     launch counts equal to the fused graph's op counts (B: 61 gn_silu and
     34 matmul launches per run), each kernel's first launch of a request
     held against its twin on the graph's operands; the VAE_SD decoder
     decodes one 64 x 64 latent to 512 x 512 under fuse_groupnorm (30 gn_silu
     launches) and under config A, each image within one level on average of
     the default decode; device busy and wall time of a UNet run (also under
     fuse_groupnorm alone) and a decode under every config, in turns; one run's kernel calls replayed against the twins
     and the library calls;
  5. SD slice, uint8 weights: the same UNet through the port's
     quantize_graph_weights (per-tensor uint8[scale,zp], the converter's
     exclusions): TINY in fp32 on the card against the CPU, then SD1.5 in
     bf16 answers the three requests with w8_matmul on every MatMul whose
     weight is 2-D uint8 and 10 packed flash launches each, the first
     w8_matmul launch of each held against the twin on the graph's operands;
     w8_matmul against its twin at every shape the graph gave it;
  6. SD image path: the TINY SD1.5 pipeline in fp32 on the card against the
     CPU (device-loop latents within 1e-4 * max, calibrated W8A8 image
     within one level), then the SD1.5 text-to-image path at full width
     (CLIP-L, the SD15 UNet, VAE_SD; random weights from seed 0) in bf16
     answers three requests: euler_a and euler through the device loop
     (10 steps), dpm++2m through the host loop (6 steps), each with 10
     packed flash launches per UNet run, the first held against the twin;
     the decoder is calibrated on the first request's latents (range_data.txt
     written and read back) and the calibrated W8A8 decoder decodes all
     three: 39 qmatmul launches each (4 MatMuls + 35 convs through qconv)
     and one flash launch at d = 512, the first launch of each kernel held
     against its twin on the graph's operands; the bf16 decoder decodes the
     first whole and tiled; images are (512, 512, 3) uint8, finite before
     the cast; W8A8 against bf16 image within W8A8_IMAGE_BOUND; CLIP, UNet,
     loop, decode and calibration times, peak memory, device profiles of
     both decoders, and one decode's kernel calls checked bit for bit and
     replayed against the twins and cuDNN / matmul on dequantized operands;
  7. LLM slice: LLAMA_TINY in fp32 on the card against the CPU (tokens equal,
     logits within 1e-4 * max), then TinyLlama 1.1B at full width (random
     weights from seed 0) in bf16 through LlamaPipeline answers three chat
     requests (a 700-token prompt, a 100-token follow-up, a 300-token prompt
     after reset; 32 greedy tokens each, decoded on the device), each with
     exactly 22 head-major kernel launches (one per layer for its one gated
     run; L = 1 decode runs launch none), and the first launch of each is
     held against the twin on the operands the graph passed it (bf16,
     rtol = atol = 2e-2); flash on and off agree on the
     prompt's last logits; on-device decode equals the host loop; prefill and
     decode times, peak memory and weight bytes are printed;
  8. LLM slice, int8 weights: LLAMA_TINY int8 in fp32 on the card against the
     CPU (tokens equal, logits within 1e-3 * max), then TinyLlama with
     int8_weights=True on the same host weights answers the same three
     requests with w8a8_dyn_matmul on all 155 weight MatMuls of every graph
     run and 22 flash_attention launches per request, the first
     w8a8_dyn_matmul launch of each held against the twin on the graph's
     operands; int8 against bf16 last logits (nrms < 0.15 on TinyLlama cut
     to the 2 layers the bound was set on; printed at full depth, beside both
     against the float32 model); on-device decode
     equals the host loop; host syncs do not grow with the tokens; prefill,
     decode, device busy time, peak memory, device weight bytes and the host
     quantization time are printed.

Each path's launch counts are set to 0 just before it and read just after;
launches made to compare a kernel with its twin come after the read. The
second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
SD15_SITES = [(4096, 40), (1024, 80)]  # (tokens, head dim) of the flash sites, 8 heads, 5 each
KERNEL_SOURCES = {"flash_attention": "flash_attention_packed, flash_attention",
                  "qmatmul": "w8a8_dyn_matmul, w8_matmul",
                  "qlinear": "qmatmul, qconv",
                  "gn_conv": "gn_silu, gn_silu_conv",
                  "matmul": "matmul"}
VAE_SITE = (4096, 512)  # (tokens, head dim) of the SD VAE mid-block attention at 512 x 512, 1 head
# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _device_rows(prof, steps: int):
    """(ms per step, launches per step, name) of every kernel and copy in a
    profile: device events only, since the CPU ops that launched them would
    count their time a second time."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / steps, e.count // steps, e.key))
    return rows


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one call of fn: the summed durations of the kernels
    and copies it launches, from torch.profiler over `iters` calls. Host gaps
    between launches are left out, so a small kernel is not timed at the
    rate at which the host can enqueue it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # The first launches of a window can be missed while the tracer starts
    # (windows came back a few launches short, or empty): one warm-up step of
    # the profiler's schedule is traced and dropped. An empty window is taken
    # again; five empty ones fail the run, since no other clock here gives
    # device time
    for _ in range(5):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=iters, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
            for _ in range(iters + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        ms = sum(r[0] for r in _device_rows(prof, iters))
        if ms > 0:
            return ms
        print("device_ms: the profiler window holds no device events; profiling again")
    raise SystemExit("device_ms: five profiler windows held no device events")


def bound(nbytes: float, ops: float, peak: str) -> dict:
    """The least time the card could take for the work: the bytes it must
    move over the memory rate, or its operations over the peak rate of
    their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


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
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = dict(zip(KERNEL_SOURCES, pool.map(build.build, KERNEL_SOURCES)))
    print(f"build: {len(paths)} sources in parallel in {time.perf_counter() - t0:.1f} s")
    for src, path in paths.items():
        print(f"  {src}.cu ({KERNEL_SOURCES[src]}) -> {path}")
        print("\n".join(l for l in (path.parent / "build.log").read_text().splitlines()
                        if "registers" in l or "spill" in l))


def _sdpa_packed(q, k, v, heads):
    """scaled_dot_product_attention on the packed (B, L, H*D) layout, as views."""
    b, d = q.shape[0], q.shape[-1] // heads
    split = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
    return F.scaled_dot_product_attention(split(q), split(k), split(v))


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
        ("vae_d512", 1, 4096, 4096, 1, 1, 512, False),  # the VAE mid-block: wide mma / FMA d = 512
        ("d512_ragged", 2, 77, 300, 1, 1, 512, False),
        ("d512_causal_m_gt_n", 1, 100, 40, 2, 1, 512, True),
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
    times, nbytes, ops = {}, 0, 0
    for m, d in SD15_SITES:
        q = torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16)
        k = torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16)
        v = torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16)
        t_k = device_ms(lambda: flash_attention_packed(q, k, v, 8))
        t_p = device_ms(lambda: flash_attention_packed_reference(q, k, v, 8))
        t_l = device_ms(lambda: _sdpa_packed(q, k, v, 8))
        # per step: 5 sites of each shape; q, k, v read and o written once,
        # QK^T and PV at 2 operations per multiply-add
        site = bound(4 * _nbytes(q), 4 * m * m * 8 * d, "bf16")
        nbytes += 5 * 4 * _nbytes(q)
        ops += 5 * 4 * m * m * 8 * d
        times[f"{m}x{d}"] = (t_k, t_p, t_l)
        print(f"time bf16 (1, {m}, {8 * d}) h8 d{d}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms, "
              f"scaled_dot_product_attention {t_l:.4f} ms, bound {site['bound_ms']:.4f} ms "
              f"({site['bound_by']})  [{name}]")
    per_step = [sum(5 * t[i] for t in times.values()) for i in (0, 1, 2)]
    # the VAE mid-block site: one launch per full decode, d = 512
    m, d = VAE_SITE
    q, k, v = (torch.randn(1, m, d, device="cuda", generator=gen, dtype=torch.bfloat16) for _ in range(3))
    vae = (device_ms(lambda: flash_attention_packed(q, k, v, 1)),
           device_ms(lambda: flash_attention_packed_reference(q, k, v, 1)),
           device_ms(lambda: _sdpa_packed(q, k, v, 1)))
    site = bound(4 * _nbytes(q), 4 * m * m * d, "bf16")
    print(f"time bf16 (1, {m}, {d}) h1 d{d} (VAE mid-block): kernel {vae[0]:.4f} ms, twin {vae[1]:.4f} ms, "
          f"scaled_dot_product_attention {vae[2]:.4f} ms, bound {site['bound_ms']:.4f} ms ({site['bound_by']})  [{name}]")
    by_shape = {k: {"ms": v[0], "plain_ms": v[1], "library_ms": v[2]} for k, v in times.items()}
    by_shape[f"{m}x{d}_h1"] = {"ms": vae[0], "plain_ms": vae[1], "library_ms": vae[2], **site}
    return {"max_abs_err": worst_bf16, "ms": per_step[0], "plain_ms": per_step[1],
            **bound(nbytes, ops, "bf16"), "library_ms": per_step[2], "ms_by_shape": by_shape}


def _session(text: str, weights, compute_dtype: str, device: str, **options):
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    cfg = SessionConfig(compute_dtype=compute_dtype, device=torch.device(device),
                        fuse_attention_heads=True, **options)
    s = Session(cfg, weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
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


def profile_steps(step, name: str, label: str, steps: int = 2) -> None:
    """Device time per step by kernel, and the device's busy share of the
    wall time, from a torch.profiler window over warm steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = _device_rows(prof, steps)
    dev_ms = sum(r[0] for r in rows)
    if not rows:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile of {label} over {steps} warm steps [{name}]: wall {wall_ms:.2f} ms/step (profiler on), "
          f"device busy {dev_ms:.2f} ms/step = {100 * dev_ms / wall_ms:.1f}% of wall")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:8.3f} ms/step  {n:5d}x  {key[:90]}")


def _tiny_unet_card_vs_cpu(label: str, text: str, weights, req, **options) -> None:
    outs = []
    for dev in ("cuda:0", "cpu"):
        s = _session(text, weights, "float32", dev, **options)
        for k, v in req.items():
            s.add_tensor(k, v)
        outs.append(s.run()["out_sample"])
    dev_err = float(np.abs(outs[0] - outs[1]).max())
    bound_ = 1e-4 * float(np.abs(outs[1]).max())
    print(f"{label} fp32 card vs CPU: max|diff| {dev_err:.3e} (bound {bound_:.3e})")
    if not dev_err <= bound_:
        raise SystemExit(f"{label} on the card disagrees with the CPU run")


def phase_slice(name: str) -> dict:
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed
    from onnxstream_tpu_torch.models.sd.unet import SD15, TINY, build_unet, param_count

    # small input first: the op library on the card against the CPU
    gt = build_unet(TINY)
    _tiny_unet_card_vs_cpu("TINY UNet", gt.to_text(), gt.weights, _requests(TINY, 1)[1])

    t0 = time.perf_counter()
    g = build_unet(SD15, seed=0)
    print(f"SD15 UNet: {param_count(g) / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s = _session(g.to_text(), g.weights, "bfloat16", "cuda:0")
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
    profile_steps(s.run, name, "SD15 step")
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
    return {"launches": launches, "graph": g, "out0": results[0], "outs": results}


TINYLLAMA_SITE = (1024, 64)  # prefill bucket and head dim of the head-major sites: 32 heads, 22 per run


def _hm_inputs(gen, b, h, hkv, m, n, d, mask_kind, kt, mask_dtype):
    """Head-major float32 inputs on the card; the additive mask holds the
    llama graph's values (0 / -1e9) with key 0 always visible and row 1
    masked entirely by the finite -1e9 (its output is the mean of V)."""
    q = torch.randn(b, h, m, d, device="cuda", generator=gen)
    k = torch.randn(b, hkv, n, d, device="cuda", generator=gen)
    v = torch.randn(b, hkv, n, d, device="cuda", generator=gen)
    mask = None
    if mask_kind == "causal":
        keep = torch.ones(m, n, device="cuda", dtype=torch.bool).tril(n - m)
        mask = torch.where(keep, 0.0, -1e9)[None, None]
    elif mask_kind is not None:
        shape = {"mn": (m, n), "bmn": (b, m, n), "11mn": (1, 1, m, n), "b1mn": (b, 1, m, n),
                 "bhmn": (b, h, m, n), "1hmn": (1, h, m, n)}[mask_kind]
        keep = torch.rand(shape, device="cuda", generator=gen) > 0.3
        keep[..., 0] = True
        keep[..., 1, :] = False
        mask = torch.where(keep, 0.0, -1e9)
    if mask is not None and mask_dtype is not None:
        mask = mask.to(mask_dtype)
    if kt:
        k = k.transpose(-1, -2).contiguous()
    return q, k, v, mask


def phase_kernel_head_major(name: str) -> dict:
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    L, D = TINYLLAMA_SITE
    # (label, b, h, hkv, m, n, d, mask, causal, k_transposed, mask dtype: None = q's)
    cases = [
        ("tinyllama_prefill", 1, 32, 32, L, L, D, "causal", False, False, None),
        ("tinyllama_continuation", 1, 32, 32, 128, L, D, "causal", False, False, None),
        ("tinyllama_prefill_512", 1, 32, 32, 512, 512, D, "causal", False, False, None),
        ("mask_mn", 1, 4, 4, 200, 600, 64, "mn", False, False, None),
        ("mask_bmn", 2, 4, 4, 200, 600, 64, "bmn", False, False, None),
        ("mask_11mn_f32_mask", 1, 4, 4, 200, 600, 64, "11mn", False, False, torch.float32),
        ("mask_b1mn", 2, 4, 4, 200, 600, 64, "b1mn", False, False, None),
        ("mask_bhmn", 2, 4, 4, 200, 600, 64, "bhmn", False, False, None),
        ("mask_1hmn_f16_mask", 2, 4, 4, 200, 600, 64, "1hmn", False, False, torch.float16),
        ("k_transposed", 1, 8, 8, 256, 700, 64, "11mn", False, True, None),
        ("gqa_b2", 2, 8, 2, 300, 700, 64, "b1mn", False, False, None),
        ("causal_m_gt_n", 1, 4, 4, 80, 24, 32, None, True, False, None),
        ("causal_and_mask", 1, 4, 4, 256, 256, 64, "11mn", True, False, None),
        ("d128", 1, 8, 8, 256, 512, 128, "mn", False, False, None),
        ("d256", 1, 4, 4, 128, 512, 256, "mn", False, False, None),
    ]
    site_err = 0.0
    for label, b, h, hkv, m, n, d, mk, causal, kt, mdt in cases:
        q32, k32, v32, mask32 = _hm_inputs(gen, b, h, hkv, m, n, d, mk, kt, mdt)
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            mask = None if mask32 is None else mask32.to(mdt or dt)
            out = flash_attention(q, k, v, mask=mask, k_transposed=kt, causal=causal)
            torch.cuda.synchronize()
            ref = flash_attention_reference(q, k, v, mask=mask, k_transposed=kt, causal=causal)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            print(f"head-major kernel vs twin {label} {str(dt)[6:]}: max|diff| {err:.3e} "
                  f"(rtol=atol={tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"head-major flash kernel disagrees with its twin on {label} {dt}")
            if label == "tinyllama_prefill" and dt == torch.bfloat16:
                site_err = err
            if causal and m > n and out[:, :, : m - n].abs().max().item() != 0.0:
                raise SystemExit(f"{label}: rows with no valid key are not exactly 0")
    q, k, v, mask = (None if t is None else t.to(torch.bfloat16)
                     for t in _hm_inputs(gen, 1, 32, 32, L, L, D, "causal", False, None))
    t_k = device_ms(lambda: flash_attention(q, k, v, mask=mask))
    t_p = device_ms(lambda: flash_attention_reference(q, k, v, mask=mask))
    t_l = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    b = bound(_nbytes(q, k, v, q, mask), 4 * 32 * L * L * D, "bf16")
    print(f"time bf16 (1, 32, {L}, {D}) with a (1, 1, {L}, {L}) bf16 mask: kernel {t_k:.4f} ms, "
          f"twin {t_p:.4f} ms, scaled_dot_product_attention {t_l:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})  [{name}]")
    return {"max_abs_err": site_err, "ms": t_k, "plain_ms": t_p, **b, "library_ms": t_l}


# ------------------------------------------------------ the quantized matmuls
# (K, N) of the TinyLlama weight MatMuls: q / o, k / v, gate / up, down, LM head
LLAMA_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32003)]


def _dyn_case(gen, m, k, n, dt, per_channel):
    a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    w = torch.randint(-127, 128, (k, n), device="cuda", generator=gen, dtype=torch.int8)
    ws = torch.rand(n, device="cuda", generator=gen) * 0.02 + 1e-3 if per_channel else 0.013
    return a, w, ws


def _w8_case(gen, m, k, n, dt, per_channel):
    a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    w = torch.randint(0, 256, (k, n), device="cuda", generator=gen, dtype=torch.uint8)
    if per_channel:
        sw = torch.rand(n, device="cuda", generator=gen) * 0.02 + 1e-3
        zw = torch.randint(0, 256, (n,), device="cuda", generator=gen).float()
        return a, w, sw, zw
    return a, w, 0.013, 117.0


def _agree(out, ref, f32_rel: float, tol16: float):
    """(ok, max|diff|): float32 within f32_rel of max|twin|; 16-bit outputs
    elementwise within rtol = atol = tol16."""
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.float32:
        return err <= f32_rel * ref.abs().max().item(), err
    return torch.allclose(out.float(), ref.float(), rtol=tol16, atol=tol16), err


def check_qkernel(label, kernel, twin, make, shapes, f32_rel: float, tol16: float) -> None:
    """A quantized-matmul kernel against its twin at every (M, K, N), f32 and
    bf16 activations, per-tensor and per-channel scales, random operands."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in shapes:
        for dt in (torch.float32, torch.bfloat16):
            for per_channel in (False, True):
                args = make(gen, m, k, n, dt, per_channel)
                out = kernel(*args)
                torch.cuda.synchronize()
                ok, err = _agree(out, twin(*args), f32_rel, tol16)
                print(f"{label} vs twin ({m}, {k}) x ({k}, {n}) {str(dt)[6:]} "
                      f"{'per-channel' if per_channel else 'per-tensor'}: max|diff| {err:.3e} "
                      f"(f32 rel {f32_rel:g}, bf16 rtol=atol={tol16:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{label} disagrees with its twin at ({m}, {k}, {n}) {dt}")


def _quantize_rows(a: torch.Tensor) -> torch.Tensor:
    """A's per-row symmetric s8 form, as w8a8_dyn_matmul computes it."""
    x = a.reshape(-1, a.shape[-1]).float()
    sa = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    return torch.round(x / sa).clamp_(-127, 127).to(torch.int8)


def _int_mm_or_none(aq: torch.Tensor, w: torch.Tensor):
    """torch._int_mm on the quantized operands (the yardstick of
    w8a8_dyn_matmul's integer product), or None where it refuses the shape."""
    try:
        torch._int_mm(aq, w)
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return lambda: torch._int_mm(aq, w)


def phase_kernel_q(name: str) -> None:
    from onnxstream_tpu_torch.kernels.qmatmul import (
        w8_matmul, w8_matmul_reference, w8a8_dyn_matmul, w8a8_dyn_matmul_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    dyn_shapes = [(m, k, n) for m in (1, 128, 512, 1024) for k, n in LLAMA_KN]
    # ragged edges: M = 77, K off the 64-deep tile, odd N, M on both sides of the GEMV limit
    dyn_shapes += [(77, 2048, 32003), (5, 100, 300), (16, 2048, 256), (17, 100, 300), (33, 130, 33)]
    check_qkernel("w8a8_dyn_matmul", w8a8_dyn_matmul, w8a8_dyn_matmul_reference, _dyn_case,
                  dyn_shapes, 1e-5, 1e-2)
    # the SD15 graph's own shapes are checked in its phase; here the ragged ones
    w8_shapes = [(100, 130, 33), (77, 768, 320), (1, 320, 1280), (64, 2048, 32003), (17, 100, 300)]
    check_qkernel("w8_matmul", w8_matmul, w8_matmul_reference, _w8_case, w8_shapes, 1e-4, 2e-2)

    # times at the TinyLlama shapes, bf16 activations, per-channel scales as the route has them;
    # the weight stays in L2 between launches here (the path's replays below read it cold)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for m in (1, 1024):
        for k, n in LLAMA_KN:
            a, w, ws = _dyn_case(gen, m, k, n, torch.bfloat16, True)
            t_k = device_ms(lambda: w8a8_dyn_matmul(a, w, ws))
            t_p = device_ms(lambda: w8a8_dyn_matmul_reference(a, w, ws), iters=3)
            lib = _int_mm_or_none(_quantize_rows(a), w)
            t_l = device_ms(lib) if lib else None
            wb = w.to(torch.bfloat16)
            t_b = device_ms(lambda: a @ wb)
            b = bound(_nbytes(a, w, ws) + m * n * 2, 2 * m * k * n, "int8")
            print(f"time w8a8_dyn_matmul bf16 ({m}, {k}) x ({k}, {n}): kernel {t_k:.4f} ms, twin {t_p:.4f} ms, "
                  f"torch._int_mm " + (f"{t_l:.4f} ms" if t_l is not None else "none at this shape")
                  + f", bf16 matmul on a bf16 weight {t_b:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})  [{name}]")


class _GraphSiteCheck:
    """Stands in for a kernel wrapper that the port's code calls. After
    arm(), the next call's kernel output is held against the twin on the very
    operands the graph passed (with the strides the graph gave them). The
    kernel's launch count is the wrapper's own; the twin launches nothing.
    The twin's scratch is kept out of the device memory peak: ``peak`` is
    the peak before each check, and the allocator's peak is reset after it.
    While ``calls`` is a list, every call's operands are appended to it."""

    def __init__(self, kernel, twin, tol: float, describe):
        self.kernel, self.twin, self.tol, self.describe = kernel, twin, tol, describe
        self.armed, self.result, self.peak, self.worst = False, None, 0, 0.0
        self.calls = None

    def arm(self):
        self.armed, self.result = True, None

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        if self.calls is not None:
            self.calls.append((args, kw))
        if self.armed:
            self.armed = False
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            ref = self.twin(*args, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=self.tol, atol=self.tol)
            self.result = (ok, err, f"max|twin| {ref.float().abs().max().item():.4f}; "
                           + self.describe(*args, **kw))
            self.worst = max(self.worst, err)
            del ref
            torch.cuda.reset_peak_memory_stats()
        return out

    def check(self, label: str) -> None:
        if self.result is None:
            raise SystemExit(f"{label}: no call reached the graph-site check")
        ok, err, about = self.result
        print(f"  first launch vs twin on the graph's operands: max|diff| {err:.3e} "
              f"(rtol=atol={self.tol}) {'ok' if ok else 'FAIL'}; {about}")
        if not ok:
            raise SystemExit(f"{label}: the kernel disagrees with its twin on the graph's operands")


def _about_flash(q, k, v, mask=None, scale=None, k_transposed=False, causal=False) -> str:
    return (f"q {tuple(q.shape)} strides {q.stride()}, k {tuple(k.shape)} strides {k.stride()} "
            f"k_transposed={k_transposed}, v strides {v.stride()}, mask "
            + ("none" if mask is None else f"{tuple(mask.shape)} {str(mask.dtype)[6:]} strides {mask.stride()}")
            + f", causal={causal}")


def _about_qmm(a, w, scale, *rest, **kw) -> str:
    return (f"a {tuple(a.shape)} {str(a.dtype)[6:]} strides {a.stride()}, w {tuple(w.shape)} "
            f"{str(w.dtype)[6:]}, scale {'(N,) vector' if isinstance(scale, torch.Tensor) else scale}"
            + (f", zero point {'(N,) vector' if isinstance(rest[0], torch.Tensor) else rest[0]}" if rest else ""))


def _qmm_cost(a, w, *scales, out_dtype=None):
    """(bytes, operations) of one quantized matmul: A, W and the scale
    vectors read once, the output written once; 2 M K N operations."""
    m = a.numel() // a.shape[-1]
    k, n = w.shape
    out_elt = torch.empty(0, dtype=out_dtype or a.dtype).element_size()
    return _nbytes(a, w, *scales) + m * n * out_elt, 2 * m * k * n


def replay_times(label: str, calls, kernel, twin, library, peak: str, name: str, cost=None) -> dict:
    """The recorded calls of one graph run replayed in order: the kernel,
    its twin and, where every call has one, the PyTorch yardstick (library
    maps a call to a no-argument function or None). The weights are the
    graph's resident ones, so they come from device memory as on the path.
    ``cost`` maps a call to its (bytes, operations); a quantized matmul's
    by default."""
    nbytes = ops = 0
    for args, kw in calls:
        b, o = (cost or _qmm_cost)(*args, **kw)
        nbytes, ops = nbytes + b, ops + o
    run_all = lambda fn: [fn(*args, **kw) for args, kw in calls]
    t_k = device_ms(lambda: run_all(kernel), iters=5)
    t_p = device_ms(lambda: run_all(twin), iters=2, warmup=1)
    libs = [library(*args, **kw) for args, kw in calls]
    t_l = None
    if all(libs):
        t_l = device_ms(lambda: [f() for f in libs], iters=5)
    b = bound(nbytes, ops, peak)
    print(f"replay of {label}: {len(calls)} calls, kernel {t_k:.4f} ms, twin {t_p:.4f} ms, library "
          + (f"{t_l:.4f} ms" if t_l is not None else f"none ({sum(map(bool, libs))} of {len(calls)} calls have one)")
          + f", bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} G ops) [{name}]")
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, **b}


# --------------------------------- the GroupNorm and small-conv routes: kernels 7, 8 and 9
GN_SITES = [(1, 320, 64, 64), (1, 960, 64, 64), (1, 128, 512, 512)]          # x of gn_silu
GN_CONV_SITES = [(320, 64, 320), (2560, 16, 1280), (1280, 8, 1280)]          # (C, H = W, O) of gn_silu_conv
MATMUL_SITES = [(64, 11520, 1280), (256, 23040, 1280), (1024, 5760, 640)]    # (M, K, N) of matmul
CONFIG_A = dict(fuse_gn_conv=True, fuse_groupnorm=True)
CONFIG_B = dict(use_pallas_smallconv=True, fuse_groupnorm=True)


def _gn_operands(gen, n, c, h, w, groups, dt, plain_inorm=False):
    """x and the four GroupNorm parameter vectors, gamma / beta shaped (C, 1, 1)
    as the converter stores them; ``plain_inorm``: sg = 1, sb = 0, as the
    converter emits them (then F.group_norm computes the same function)."""
    r = lambda *sh: torch.randn(*sh, device="cuda", generator=gen)
    x = (r(n, c, h, w) * 2 + 0.5).to(dt)
    sg = torch.ones(groups, device="cuda") if plain_inorm else r(groups) * 0.1 + 1
    sb = torch.zeros(groups, device="cuda") if plain_inorm else r(groups) * 0.05
    return x, sg.to(dt), sb.to(dt), (r(c, 1, 1) * 0.2 + 1).to(dt), (r(c, 1, 1) * 0.1).to(dt)


def _w9_operands(gen, c, o, dt, bias=True):
    wt = torch.randn(o, c, 3, 3, device="cuda", generator=gen) / (9 * c) ** 0.5
    w9 = wt.permute(2, 3, 0, 1).reshape(9, o, c).contiguous().to(dt)
    return w9, (torch.randn(o, device="cuda", generator=gen).to(dt) if bias else None)


def _held(label: str, out, ref, tol: float) -> float:
    """max|out - ref| <= tol * max(1, max|ref|), or the run fails."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err <= tol * max(1.0, top)
    print(f"kernel vs twin {label}: max|diff| {err:.3e}, max|twin| {top:.3f} (tol {tol:g} * max(1, max|twin|)) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: the kernel disagrees with its twin")
    return err


def _gn_library(x, sg, sb, gamma, beta, groups, eps, silu):
    """F.group_norm (+ F.silu): the same function in PyTorch's own calls where
    sg = 1 and sb = 0, as the converter emits them (the yardstick, not used by
    the port)."""
    g, b = gamma.reshape(-1), beta.reshape(-1)
    if silu:
        return lambda: F.silu(F.group_norm(x, groups, g, b, eps))
    return lambda: F.group_norm(x, groups, g, b, eps)


def _gn_conv_library(x, sg, sb, gamma, beta, w9, bias=None, *, groups, eps):
    from onnxstream_tpu_torch.kernels.gn_conv import w9_to_oihw

    w = w9_to_oihw(w9).contiguous()
    g, b = gamma.reshape(-1), beta.reshape(-1)
    return lambda: F.conv2d(F.silu(F.group_norm(x, groups, g, b, eps)), w, bias, padding=1)


def _matmul_library_call(a, b, bias=None, *, out_dtype=None):
    if bias is None:
        return lambda: torch.matmul(a, b)
    bb = bias.to(a.dtype)
    return lambda: torch.addmm(bb, a, b)


def _gn_cost(x, sg, sb, gamma, beta, groups, eps, silu):
    """x read once, y written once, the parameters read once; per element two
    multiply-adds for the moments, one for the affine, a handful for SiLU."""
    return 2 * _nbytes(x) + _nbytes(sg, sb, gamma, beta), (12 if silu else 6) * x.numel()


def _gn_conv_cost(x, sg, sb, gamma, beta, w9, bias=None, *, groups, eps):
    n, c, h, w = x.shape
    o = w9.shape[1]
    out_bytes = n * o * h * w * x.element_size()
    return _nbytes(x, sg, sb, gamma, beta, w9, bias) + out_bytes, 2 * 9 * c * o * n * h * w + 12 * x.numel()


def _matmul_cost(a, b, bias=None, *, out_dtype=None):
    (m, k), n = a.shape, b.shape[1]
    out_elt = torch.empty(0, dtype=out_dtype or a.dtype).element_size()
    return _nbytes(a, b, bias) + m * n * out_elt, 2 * m * k * n


def _site_times(label, name, kernel, twin, library, cost, peak="bf16"):
    t_k, t_p, t_l = device_ms(kernel), device_ms(twin, iters=3, warmup=1), device_ms(library)
    b = bound(*cost, peak)
    print(f"time bf16 {label}: kernel {t_k:.4f} ms, twin {t_p:.4f} ms, library {t_l:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{name}]")
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, **b}


def phase_kernel_gn(name: str) -> dict:
    """Kernels 7, 8 and 9 against their twins at the JAX suite's ragged cases
    in three dtypes, then at the sites of the routes in bf16 with their
    times. Tolerances: gn_silu 2e-5 (f32) / 2e-2 (16-bit); gn_silu_conv 1e-4 /
    2e-2; matmul 1e-4 (f32), 1e-3 (bf16 operands, f32 output), 2e-2 (16-bit
    output); each times max(1, max|twin|)."""
    from onnxstream_tpu_torch.kernels.gn_conv import gn_silu_conv, gn_silu_conv_reference
    from onnxstream_tpu_torch.kernels.gn_silu import gn_silu, gn_silu_reference
    from onnxstream_tpu_torch.kernels.matmul import conv3x3_im2col, matmul, matmul_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    tols = lambda f32: ((torch.float32, f32), (torch.bfloat16, 2e-2), (torch.float16, 2e-2))
    # (n, c, h, w, groups, silu): C/G = 2, 10, 5, 6 with H W = 35; batch 2; the route's sites
    gn_cases = [(1, 64, 8, 8, 32, True), (1, 320, 16, 16, 32, True), (2, 40, 4, 4, 8, False),
                (1, 24, 5, 7, 4, True)] + [(*site, 32, i != 1) for i, site in enumerate(GN_SITES)]
    for n, c, h, w, g, silu in gn_cases:
        for dt, tol in tols(2e-5):
            args = _gn_operands(gen, n, c, h, w, g, dt)
            _held(f"gn_silu {(n, c, h, w)} G{g} silu={silu} {str(dt)[6:]}", gn_silu(*args, g, 1e-5, silu),
                  gn_silu_reference(*args, g, 1e-5, silu), tol)
    # (n, c, groups, h, w, o, bias): 5 x 7 borders, no bias and O != C, C/G = 5, ragged everything, O = 4
    conv_cases = [(2, 16, 4, 5, 7, 16, True), (1, 32, 8, 8, 8, 24, False), (1, 20, 4, 4, 4, 8, True),
                  (2, 64, 8, 33, 17, 70, True), (1, 320, 32, 64, 64, 4, True)]
    conv_cases += [(1, c, 32, hw, hw, o, True) for c, hw, o in GN_CONV_SITES]
    for n, c, g, h, w, o, bias in conv_cases:
        for dt, tol in tols(1e-4):
            args = _gn_operands(gen, n, c, h, w, g, dt)
            w9, bv = _w9_operands(gen, c, o, dt, bias)
            _held(f"gn_silu_conv {(n, c, h, w)} G{g} -> {o} bias={bias} {str(dt)[6:]}",
                  gn_silu_conv(*args, w9, bv, groups=g, eps=1e-5),
                  gn_silu_conv_reference(*args, w9, bv, g, 1e-5), tol)
    mm_cases = [(64, 1152, 128, False), (128, 2560, 256, True), (512, 1280, 640, True), (35, 100, 33, True)]
    mm_cases += [(m, k, n, True) for m, k, n in MATMUL_SITES]
    for m, k, n, bias in mm_cases:
        for dt, odt, tol in ((torch.float32, torch.float32, 1e-4), (torch.bfloat16, torch.float32, 1e-3),
                             (torch.bfloat16, torch.bfloat16, 2e-2), (torch.float16, torch.float16, 2e-2)):
            a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
            b = (torch.randn(k, n, device="cuda", generator=gen) * 0.02).to(dt)
            bv = torch.randn(n, device="cuda", generator=gen) if bias else None
            _held(f"matmul ({m}, {k}) x ({k}, {n}) bias={bias} {str(dt)[6:]} -> {str(odt)[6:]}",
                  matmul(a, b, bv, out_dtype=odt), matmul_reference(a, b, bv, out_dtype=odt), tol)
    for cin, cout, h, w, batch in [(128, 128, 8, 8, 2), (256, 128, 5, 7, 1)]:
        x = torch.randn(batch, h, w, cin, device="cuda", generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) * 0.05
        bv = torch.randn(cout, device="cuda", generator=gen)
        ref = F.conv2d(x.permute(0, 3, 1, 2), wt, bv, padding=1).permute(0, 2, 3, 1)
        _held(f"conv3x3_im2col NHWC {(batch, h, w, cin)} -> {cout} float32 against F.conv2d",
              conv3x3_im2col(x, wt, bv), ref, 1e-4)

    # times at the sites, bf16
    dt, out = torch.bfloat16, {"gn_silu": {}, "gn_silu_conv": {}, "matmul": {}}
    for i, (n, c, h, w) in enumerate(GN_SITES):
        args = (*_gn_operands(gen, n, c, h, w, 32, dt, plain_inorm=True), 32, 1e-5, i != 1)
        out["gn_silu"][f"{c}x{h}x{w}"] = _site_times(
            f"gn_silu {(n, c, h, w)} silu={i != 1}", name, lambda: gn_silu(*args),
            lambda: gn_silu_reference(*args), _gn_library(*args), _gn_cost(*args))
    for c, hw, o in GN_CONV_SITES:
        args = _gn_operands(gen, 1, c, hw, hw, 32, dt, plain_inorm=True)
        w9, bv = _w9_operands(gen, c, o, dt)
        kw = dict(groups=32, eps=1e-5)
        out["gn_silu_conv"][f"{c}x{hw}x{hw}->{o}"] = _site_times(
            f"gn_silu_conv (1, {c}, {hw}, {hw}) -> {o}", name, lambda: gn_silu_conv(*args, w9, bv, **kw),
            lambda: gn_silu_conv_reference(*args, w9, bv, 32, 1e-5), _gn_conv_library(*args, w9, bv, **kw),
            _gn_conv_cost(*args, w9, bv, **kw))
    for m, k, n in MATMUL_SITES:
        a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
        b = (torch.randn(k, n, device="cuda", generator=gen) * 0.02).to(dt)
        bv = torch.randn(n, device="cuda", generator=gen).to(dt)
        out["matmul"][f"{m}x{k}x{n}"] = _site_times(
            f"matmul ({m}, {k}) x ({k}, {n}) + bias", name, lambda: matmul(a, b, bv),
            lambda: matmul_reference(a, b, bv), _matmul_library_call(a, b, bv), _matmul_cost(a, b, bv))
    return out


def _smallconv_sites(graph) -> int:
    """Conv ops of a fused graph that pass the use_pallas_smallconv gate of
    ops/standard.py (their shapes are static in these graphs)."""
    n = 0
    for op in graph.ops:
        if op.op_type != "Conv" or op.attr_int("group", 1) != 1:
            continue
        x, w = op.inputs[0].shape, op.inputs[1].shape
        n += (len(x) == 4 and tuple(w[2:]) == (3, 3) and list(op.attr_ints("strides", [1, 1])) == [1, 1]
              and list(op.attr_ints("dilations", [1, 1])) == [1, 1]
              and list(op.attr_ints("pads", [0, 0, 0, 0])) == [1, 1, 1, 1] and x[1] % 128 == 0 and w[0] % 128 == 0
              and x[2] * x[3] <= 1024 and (x[0] * x[2] * x[3]) % 8 == 0)
    return n


class _LaunchForwardingSite(_GraphSiteCheck):
    """A site check that stands in for a wrapper inside the wrapper's own
    module: the wrapper counts through its module's name for itself
    (``matmul.launches += 1``), so the count is passed on to the kernel."""

    @property
    def launches(self) -> int:
        return self.kernel.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.kernel.launches = value


def busy_and_wall(step, label: str, name: str, steps: int = 3) -> dict:
    """Warm wall ms (median of `steps` runs ended by a synchronize) and device
    busy ms (the kernels' summed durations) of one call of step."""
    step()
    walls = []
    for _ in range(steps):
        _, ms = _timed(step)
        walls.append(ms)
    dev = device_ms(step, iters=steps, warmup=0)
    print(f"{label}: wall median {np.median(walls):.2f} ms (min {min(walls):.2f}, {steps} runs), "
          f"device busy {dev:.3f} ms [{name}]")
    return {"wall_ms": float(np.median(walls)), "device_ms": dev}


def phase_gn_routes(name: str, sd: dict) -> dict:
    """The SD15 UNet and the VAE_SD decoder at full width under the optional
    GroupNorm and small-conv routes (see the module docstring, phase 4b)."""
    import onnxstream_tpu_torch.kernels.matmul as matmul_mod
    import onnxstream_tpu_torch.ops.standard as standard
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed
    from onnxstream_tpu_torch.kernels.gn_conv import gn_silu_conv, gn_silu_conv_reference
    from onnxstream_tpu_torch.kernels.gn_silu import gn_silu, gn_silu_reference
    from onnxstream_tpu_torch.kernels.matmul import matmul, matmul_reference
    from onnxstream_tpu_torch.models.sd.pipeline import image_to_uint8
    from onnxstream_tpu_torch.models.sd.unet import SD15, TINY, build_unet
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder

    gt = build_unet(TINY)
    for label, cfg in (("A", CONFIG_A), ("B", CONFIG_B)):
        _tiny_unet_card_vs_cpu(f"TINY UNet, config {label},", gt.to_text(), gt.weights, _requests(TINY, 1)[1], **cfg)

    about = lambda x, *rest, **kw: f"x {tuple(x.shape)} {str(x.dtype)[6:]} strides {x.stride()}"
    sites = {"gn_silu": _GraphSiteCheck(gn_silu, gn_silu_reference, 2e-2, about),
             "gn_silu_conv": _GraphSiteCheck(gn_silu_conv, gn_silu_conv_reference, 2e-2, about),
             "matmul": _LaunchForwardingSite(matmul, matmul_reference, 2e-2,
                                             lambda a, b, *r, **kw: f"a {tuple(a.shape)} x b {tuple(b.shape)}")}
    kernels = {"gn_silu": gn_silu, "gn_silu_conv": gn_silu_conv, "matmul": matmul}

    def patched(on: bool) -> None:
        standard.gn_silu = sites["gn_silu"] if on else gn_silu
        standard.gn_silu_conv = sites["gn_silu_conv"] if on else gn_silu_conv
        matmul_mod.matmul = sites["matmul"] if on else matmul

    g, reqs, text = sd["graph"], _requests(SD15, 0), sd["graph"].to_text()
    sessions, want, times, replays = {}, {}, {}, {}
    # the path: three requests under A, three under B, the VAE decodes; the counts are zeroed just before it
    for k in kernels.values():
        k.launches = 0
    patched(True)
    try:
        for label, cfg in (("A", CONFIG_A), ("B", CONFIG_B)):
            s = sessions[label] = _session(text, g.weights, "bfloat16", "cuda:0", **cfg)
            kinds = [op.op_type for op in s.graph.ops]
            want[label] = {"gn_silu": kinds.count("ostpu.gn_silu"), "gn_silu_conv": kinds.count("ostpu.gn_silu_conv"),
                           "matmul": _smallconv_sites(s.graph) if "use_pallas_smallconv" in cfg else 0}
            print(f"SD15 UNet, config {label} {cfg}: fused graph {len(s.graph.ops)} ops, "
                  f"{kinds.count('InstanceNormalization')} GroupNorm chains left decomposed, expected launches per run {want[label]}")
            for i, req in enumerate(reqs):
                for k, v in req.items():
                    s.add_tensor(k, v)
                before = {k: f.launches for k, f in kernels.items()}
                f0 = flash_attention_packed.launches
                for k, n in want[label].items():
                    if n:
                        sites[k].arm()
                out, ms = _timed(lambda: s.run()["out_sample"])
                got = {k: f.launches - before[k] for k, f in kernels.items()}
                diff = float(np.abs(out - sd["outs"][i]).max())
                top = float(np.abs(sd["outs"][i]).max())
                print(f"config {label} request {i} (t={req['timestep'][0]:g}): {out.shape} finite={np.isfinite(out).all()} "
                      f"{ms:.1f} ms, launches {got}, flash {flash_attention_packed.launches - f0}; against the default "
                      f"config: max|diff| {diff:.4e}, max|out| {top:.4f}, ratio {diff / top:.4e} (bound 5e-2) [{name}]")
                if out.shape != (1, 4, 64, 64) or not np.isfinite(out).all() or not diff <= 5e-2 * top:
                    raise SystemExit(f"config {label} request {i}: bad output or far from the default config's")
                if got != want[label] or flash_attention_packed.launches - f0 != 10:
                    raise SystemExit(f"config {label} request {i}: launches {got}, want {want[label]}")
                for k, n in want[label].items():
                    if n:
                        sites[k].check(f"config {label} request {i}, {k}")
        if want["B"] != {"gn_silu": 61, "gn_silu_conv": 0, "matmul": 34}:
            raise SystemExit(f"config B: the fused graph predicts {want['B']}, not 61 gn_silu / 34 matmul launches")

        # the VAE_SD decoder, one 64 x 64 latent -> 512 x 512
        vae = build_vae_decoder(dataclasses.replace(VAE_SD, sample=64), seed=2)
        z = np.random.default_rng(3).standard_normal((1, 4, 64, 64)).astype(np.float32)
        images = {}
        for label, cfg in (("default", {}), ("fuse_groupnorm", dict(fuse_groupnorm=True)), ("A", CONFIG_A)):
            s = sessions[f"vae_{label}"] = _session(vae.to_text(), vae.weights, "bfloat16", "cuda:0", **cfg)
            kinds = [op.op_type for op in s.graph.ops]
            wantv = {"gn_silu": kinds.count("ostpu.gn_silu"), "gn_silu_conv": kinds.count("ostpu.gn_silu_conv"), "matmul": 0}
            s.add_tensor("latent", z)
            before = {k: f.launches for k, f in kernels.items()}
            for k, n in wantv.items():
                if n:
                    sites[k].arm()
            img_f, ms = _timed(lambda: s.run(device_outputs=True))
            img_f = next(iter(img_f.values()))
            got = {k: f.launches - before[k] for k, f in kernels.items()}
            if img_f.shape != (1, 3, 512, 512) or not bool(torch.isfinite(img_f).all()):
                raise SystemExit(f"VAE decode, {label}: bad image {tuple(img_f.shape)}")
            images[label] = image_to_uint8(img_f[0]).astype(np.int32)
            print(f"VAE_SD decode, {label}: {len(s.graph.ops)} ops, {ms:.1f} ms, launches {got} (want {wantv}) [{name}]")
            if got != wantv or (label == "fuse_groupnorm" and wantv["gn_silu"] != 30):
                raise SystemExit(f"VAE decode, {label}: launches {got}, want {wantv} (30 gn_silu under fuse_groupnorm)")
            for k, n in wantv.items():
                if n:
                    sites[k].check(f"VAE decode, {label}, {k}")
            if label != "default":
                d = np.abs(images[label] - images["default"])
                print(f"VAE_SD decode, {label} against the default: mean |diff| {d.mean():.4f}, max {d.max()} levels "
                      f"(bound: mean < 1)")
                if not d.mean() < 1.0:
                    raise SystemExit(f"VAE decode, {label}: the image drifted from the default decode")
        launches = {k: f.launches for k, f in kernels.items()}
        print(f"GroupNorm / small-conv route launches on the path: {launches}")
        # which bf16 decode lies nearer the float32 one (printed, not gated)
        s32 = _session(vae.to_text(), vae.weights, "float32", "cuda:0")
        s32.add_tensor("latent", z)
        img32 = image_to_uint8(next(iter(s32.run(device_outputs=True).values()))[0]).astype(np.int32)
        del s32
        print("VAE_SD decode against the float32 decode, mean |diff| in levels: "
              + ", ".join(f"{label} {np.abs(img - img32).mean():.4f}" for label, img in images.items()))

        # one run's calls recorded under each config (after the read of the counts)
        recorded = {}
        for label in ("A", "B", "vae_fuse_groupnorm"):
            for site in sites.values():
                site.calls = []
            sessions[label].run(device_outputs=True)
            recorded[label] = {k: site.calls for k, site in sites.items()}
            for site in sites.values():
                site.calls = None
    finally:
        patched(False)

    # device busy and wall time of a run under every config, in turns within this process
    # (fuse_groupnorm alone joins here, after the read of the counts, held to the default like A and B)
    for label, cfg in (("default", {}), ("fuse_groupnorm", dict(fuse_groupnorm=True))):
        sessions[label] = _session(text, g.weights, "bfloat16", "cuda:0", **cfg)
    for label in ("default", "fuse_groupnorm", "A", "B"):
        for k, v in reqs[0].items():
            sessions[label].add_tensor(k, v)
    out = sessions["fuse_groupnorm"].run()["out_sample"]
    diff, top = float(np.abs(out - sd["outs"][0]).max()), float(np.abs(sd["outs"][0]).max())
    print(f"config fuse_groupnorm request 0 against the default config: max|diff| {diff:.4e}, ratio {diff / top:.4e} "
          f"(bound 5e-2); fused graph {len(sessions['fuse_groupnorm'].graph.ops)} ops")
    if not diff <= 5e-2 * top:
        raise SystemExit("config fuse_groupnorm: far from the default config's output")
    for label in ("default", "fuse_groupnorm", "A", "B", "B", "A", "fuse_groupnorm", "default"):
        times.setdefault(label, []).append(
            busy_and_wall(sessions[label].run, f"SD15 UNet run, config {label}", name, steps=5))
    for label in ("default", "fuse_groupnorm", "A", "A", "fuse_groupnorm", "default"):
        step = lambda s=sessions[f"vae_{label}"]: s.run(device_outputs=True)
        times.setdefault(f"vae_{label}", []).append(busy_and_wall(step, f"VAE_SD decode, config {label}", name))
    profile_steps(sessions["A"].run, name, "SD15 step, config A")
    profile_steps(sessions["B"].run, name, "SD15 step, config B")

    specs = {"gn_silu": (gn_silu, gn_silu_reference, _gn_library, _gn_cost),
             "gn_silu_conv": (gn_silu_conv, gn_silu_conv_reference, _gn_conv_library, _gn_conv_cost),
             "matmul": (matmul, matmul_reference, _matmul_library_call, _matmul_cost)}
    for label, k in (("B", "gn_silu"), ("A", "gn_silu"), ("vae_fuse_groupnorm", "gn_silu"), ("A", "gn_silu_conv"),
                     ("B", "matmul")):
        kernel, twin, library, cost = specs[k]
        replays[(label, k)] = replay_times(f"{k} over one run under config {label} (bf16)", recorded[label][k],
                                           kernel, twin, library, "bf16", name, cost=cost)
    out = {}
    for k, main in (("gn_silu", "B"), ("gn_silu_conv", "A"), ("matmul", "B")):
        out[k] = {"launches": launches[k], "max_abs_err": sites[k].worst, **replays[(main, k)],
                  "launches_per_run": {label: want[label][k] for label in ("A", "B")}}
    out["gn_silu"]["ms_by_path"] = {label: replays[(label, "gn_silu")] for label in ("A", "vae_fuse_groupnorm")}
    out["times"] = times
    return out


def phase_sd_u8(name: str, sd: dict) -> dict:
    import onnxstream_tpu_torch.runtime.executor as executor_mod
    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights
    from onnxstream_tpu_torch.dtypes import DType
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed
    from onnxstream_tpu_torch.kernels.qmatmul import w8_matmul, w8_matmul_reference
    from onnxstream_tpu_torch.models.sd.unet import SD15, TINY, build_unet

    gt = build_unet(TINY)
    text, weights = quantize_graph_weights(gt.to_text(), gt.weights)
    _tiny_unet_card_vs_cpu("TINY UNet, uint8 weights,", text, weights, _requests(TINY, 1)[1])

    g = sd["graph"]
    t0 = time.perf_counter()
    text, weights = quantize_graph_weights(g.to_text(), g.weights)
    print(f"SD15 quantize_graph_weights on the host: {time.perf_counter() - t0:.1f} s, "
          f"{sum(np.asarray(v).dtype == np.uint8 for v in weights.values())} uint8 weights")
    del sd["graph"], g
    s = _session(text, weights, "bfloat16", "cuda:0")
    del weights
    u8_mm = [op for op in s.graph.ops if op.op_type == "MatMul" and len(op.inputs) == 2
             and op.inputs[1].dtype == DType.uint8 and len(op.inputs[1].shape) == 2]
    print(f"fused uint8 graph: {len(s.graph.ops)} ops, {len(u8_mm)} MatMuls with a 2-D uint8 weight")
    if not u8_mm:
        raise SystemExit("the quantized SD15 graph has no uint8 MatMul weight")

    reqs = _requests(SD15, 0)
    site = _GraphSiteCheck(w8_matmul, w8_matmul_reference, 2e-2, _about_qmm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results = []
    # the path: three requests; the counts are zeroed just before it
    w8_matmul.launches = 0
    flash_attention_packed.launches = 0
    executor_mod.w8_matmul = site
    try:
        for i, req in enumerate(reqs):
            for k, v in req.items():
                s.add_tensor(k, v)
            b5, b1 = w8_matmul.launches, flash_attention_packed.launches
            site.arm()
            t1 = time.perf_counter()
            out = s.run()["out_sample"]
            ms = (time.perf_counter() - t1) * 1e3
            n5, n1 = w8_matmul.launches - b5, flash_attention_packed.launches - b1
            results.append(out)
            print(f"uint8 request {i} (t={req['timestep'][0]:g}): {out.shape} finite={np.isfinite(out).all()} "
                  f"max|out|={np.abs(out).max():.4f} {ms:.1f} ms, w8_matmul launches {n5} (want {len(u8_mm)}), "
                  f"flash_attention_packed launches {n1} (want 10)")
            if out.shape != (1, 4, 64, 64) or not np.isfinite(out).all():
                raise SystemExit(f"uint8 request {i}: bad output")
            if n5 != len(u8_mm) or n1 != 10:
                raise SystemExit(f"uint8 request {i}: {n5} w8_matmul / {n1} flash launches")
            site.check(f"uint8 request {i}")
    finally:
        executor_mod.w8_matmul = w8_matmul
    launches = w8_matmul.launches
    peak = max(site.peak, torch.cuda.max_memory_allocated())
    stats = s.hbm_stats()
    if np.allclose(results[0], results[1]):
        raise SystemExit("uint8 requests did not give distinct outputs")
    diff = float(np.abs(results[0] - sd["out0"]).max())
    ref = float(np.abs(sd["out0"]).max())
    print(f"uint8 weights vs the float UNet (bf16), request 0: max|diff| {diff:.4e}, max|out| {ref:.4f}, "
          f"ratio {diff / ref:.4e}")
    for k, v in reqs[0].items():
        s.add_tensor(k, v)
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        s.run()
        times.append((time.perf_counter() - t1) * 1e3)
    print(f"SD15 UNet step bf16, uint8 weights, warm: median {np.median(times):.2f} ms over 5 runs "
          f"(min {min(times):.2f}) [{name}]")
    print(f"peak device memory {peak / 2**20:.1f} MB, weights {stats['weight_bytes'] / 2**20:.1f} MB [{name}]")
    profile_steps(s.run, name, "SD15 step, uint8 weights")

    # one step's calls recorded, then the kernel at each of the graph's shapes
    # against its twin, and the step's calls replayed
    site.calls = []
    executor_mod.w8_matmul = site
    try:
        s.run()
    finally:
        executor_mod.w8_matmul = w8_matmul
    calls, site.calls = site.calls, None
    shapes = sorted({(a.numel() // a.shape[-1], *w.shape) for (a, w, *_), _ in calls})
    print(f"w8_matmul shapes of the SD15 step (M, K, N): {shapes}")
    check_qkernel("w8_matmul", w8_matmul, w8_matmul_reference, _w8_case, shapes, 1e-4, 2e-2)

    def dequantized_matmul(a, w, sw, zw, out_dtype=None):
        wd = ((w.float() - zw) * sw).to(a.dtype)
        return lambda: torch.matmul(a, wd)

    times = replay_times("w8_matmul over one SD15 step (bf16)", calls, w8_matmul, w8_matmul_reference,
                         dequantized_matmul, "bf16", name)
    return {"launches": launches, "max_abs_err": site.worst, **times}


# ------------------------------------------------ calibrated W8A8: kernels 3 and 4
def _about_qlinear(a, w, *args, **kw) -> str:
    return (f"a {tuple(a.shape)} strides {a.stride()}, w {tuple(w.shape)}, a (scale, zero) {args[:2]}, "
            f"w (scale, zero) {args[2:4]}" + (f", pads {kw.get('pads')}" if "pads" in kw else ""))


def _qconv_cost(x, w, *args, bias=None, strides=(1, 1), pads=(0, 0, 0, 0), dilations=(1, 1),
                out_scale=None, out_zero=None, out_dtype=torch.float32):
    """(bytes, operations) of one qconv: x, w and the bias read once, the
    output written once; 2 M K N integer operations (M = B Ho Wo, K = C kh kw,
    N = O)."""
    bsz, c, h, wd = x.shape
    o, _, kh, kw = w.shape
    ho = (h + pads[0] + pads[2] - ((kh - 1) * dilations[0] + 1)) // strides[0] + 1
    wo = (wd + pads[1] + pads[3] - ((kw - 1) * dilations[1] + 1)) // strides[1] + 1
    out_elt = 1 if out_scale is not None else torch.empty(0, dtype=out_dtype).element_size()
    return _nbytes(x, w, bias) + bsz * o * ho * wo * out_elt, 2 * bsz * ho * wo * c * kh * kw * o


def _qmatmul_cost(a, w, *args, out_dtype=torch.float32, out_scale=None, **kw):
    m = a.numel() // a.shape[-1]
    k, n = a.shape[-1], w.numel() // a.shape[-1]
    out_elt = 1 if out_scale is not None else torch.empty(0, dtype=out_dtype).element_size()
    return _nbytes(a, w) + m * n * out_elt, 2 * m * k * n


def _dequantized(q, scale, zero, dtype):
    return ((q.float() - zero) * scale).to(dtype)


def _conv_library(x, w, a_scale, a_zero, w_scale, w_zero, bias=None, strides=(1, 1), pads=(0, 0, 0, 0),
                  dilations=(1, 1), out_dtype=torch.bfloat16, **kw):
    """cuDNN's bf16 convolution on the dequantized input and weight: the same
    function in one PyTorch call (the yardstick, not used by the port)."""
    xd, wd = _dequantized(x, a_scale, a_zero, torch.bfloat16), _dequantized(w, w_scale, w_zero, torch.bfloat16)
    xd = F.pad(xd, (pads[1], pads[3], pads[0], pads[2]))
    b = None if bias is None else bias.to(torch.bfloat16)
    return lambda: F.conv2d(xd, wd, b, stride=tuple(strides), dilation=tuple(dilations))


def _matmul_library(a, w, a_scale, a_zero, w_scale, w_zero, **kw):
    ad, wd = _dequantized(a, a_scale, a_zero, torch.bfloat16), _dequantized(w, w_scale, w_zero, torch.bfloat16)
    return lambda: torch.matmul(ad, wd)


def check_qlinear_calls(label, kernel, twin, calls, what: str) -> float:
    """The kernel against its twin on every call's operands: the same
    integer arithmetic, so bit for bit. Returns max|diff|."""
    worst = 0.0
    for args, kw in calls:
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        ref = twin(*args, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        if not torch.equal(out, ref):
            raise SystemExit(f"{label} disagrees with its twin (max|diff| {err:.3e}) on {_about_qlinear(*args, **kw)}")
    print(f"{label} vs twin on {len(calls)} calls ({what}): bit for bit (max|diff| {worst:.3e})")
    return worst


def phase_kernel_qlinear(name: str) -> None:
    """Kernels 3 and 4 against their twins at ragged shapes (the VAE path's
    own shapes are checked in the SD image phase): K 36 and N 3 as in the
    VAE's conv_in / conv_out, uint8 / f32 / bf16 outputs, strides,
    dilations, asymmetric pads, 1 x 1 convs (the conv's (N, K) weight rows
    with K % 16 != 0 and == 0)."""
    from onnxstream_tpu_torch.kernels.qconv import qconv, qconv_reference
    from onnxstream_tpu_torch.kernels.qmatmul import qmatmul, qmatmul_reference

    gen = torch.Generator(device="cuda").manual_seed(4)
    u8 = lambda *shape: torch.randint(0, 256, shape, device="cuda", generator=gen, dtype=torch.uint8)
    outs = [dict(out_dtype=torch.float32), dict(out_dtype=torch.bfloat16), dict(out_scale=40.0, out_zero=100)]
    calls = []
    for m, k, n in [(77, 36, 3), (130, 100, 257), (4096, 512, 512), (1, 64, 8), (300, 4608, 130)]:
        a, w = u8(m, k), u8(k, n)
        bias = torch.randint(-5000, 5000, (n,), device="cuda", generator=gen, dtype=torch.int32)
        calls += [((a, w, 0.03, 120, 0.02, 128), dict(bias=bias, **o)) for o in outs]
    check_qlinear_calls("qmatmul", qmatmul, qmatmul_reference, calls, "ragged shapes, 3 outputs")
    calls = []
    for x, w, st, pd, dl in [((1, 4, 9, 11), (8, 4, 3, 3), (1, 1), (1, 1, 1, 1), (1, 1)),
                             ((1, 16, 12, 12), (3, 16, 3, 3), (1, 1), (1, 1, 1, 1), (1, 1)),
                             ((2, 8, 10, 7), (16, 8, 1, 1), (1, 1), (0, 0, 0, 0), (1, 1)),
                             ((1, 3, 16, 16), (6, 3, 3, 3), (2, 2), (1, 1, 1, 1), (1, 1)),
                             ((1, 5, 14, 14), (7, 5, 3, 3), (1, 1), (2, 2, 2, 2), (2, 2)),
                             ((1, 6, 9, 9), (5, 6, 3, 2), (2, 1), (0, 1, 2, 0), (1, 1)),
                             ((1, 100, 10, 13), (257, 100, 1, 1), (1, 1), (0, 0, 0, 0), (1, 1)),
                             ((1, 64, 1, 1), (8, 64, 1, 1), (1, 1), (0, 0, 0, 0), (1, 1))]:
        bias = torch.randn(w[0], device="cuda", generator=gen) * 30
        calls += [((u8(*x), u8(*w), 0.03, 120, 0.02, 128),
                   dict(bias=bias, strides=st, pads=pd, dilations=dl, **o)) for o in outs]
    check_qlinear_calls("qconv", qconv, qconv_reference, calls, "strides, dilations, pads, 1 x 1, 3 outputs")


def _decode_image(pipe, lat, tiled: bool = False):
    """The decoder's float image (finite, checked before the cast) and the
    uint8 image, (512, 512, 3)."""
    from onnxstream_tpu_torch.models.sd.pipeline import image_to_uint8

    img_f = pipe.decode_to_float(lat, tiled=tiled)
    if not bool(torch.isfinite(img_f).all()):
        raise SystemExit("the decoder gave a non-finite image")
    img = image_to_uint8(img_f)
    if img.shape != (512, 512, 3) or img.dtype != np.uint8:
        raise SystemExit(f"bad image {img.shape} {img.dtype}")
    return img


class _FlashSites(_GraphSiteCheck):
    """The packed flash wrapper as ops/attention.py calls it: each call's
    head dim is recorded, and the armed call is held against the twin."""

    def __init__(self, kernel, twin, tol):
        super().__init__(kernel, twin, tol, lambda q, k, v, heads, **kw: f"q {tuple(q.shape)} heads {heads}")
        self.head_dims = []

    def __call__(self, q, k, v, heads, **kw):
        self.head_dims.append(q.shape[-1] // heads)
        return super().__call__(q, k, v, heads, **kw)


def _tiny_pipeline_card_vs_cpu() -> None:
    """TINY SD1.5 in fp32 on the card against the same pipeline on the CPU:
    the device loop's latents within 1e-4 * max, and the calibrated W8A8
    decode (kernels 3 and 4 on the card, their twins on the CPU) within one
    level of 255."""
    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline, qu8_decoder
    from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder

    lats, imgs = {}, {}
    g = build_vae_decoder(dataclasses.replace(VAE_TINY, sample=16), seed=2)  # from_synthetic's decoder
    for dev in ("cpu", "cuda:0"):
        pipe = StableDiffusionPipeline.from_synthetic(tiny=True, device=torch.device(dev))
        lats[dev] = pipe.generate_on_device("a photo of a cat", "dog", steps=3, seed=7, decode=False).latents
        if dev == "cpu":  # calibrated on the CPU, the same ranges for both
            pipe.calibrate_decoder(True)
            pipe.decode(lats[dev])
            ranges = pipe.calibration_ranges().data
        pipe.vae_decoder = qu8_decoder(g.to_text(), g.weights, ranges, "float32", torch.device(dev))
        imgs[dev] = pipe.decode(lats["cpu"])
    err = float(np.abs(lats["cuda:0"] - lats["cpu"]).max())
    bound_ = 1e-4 * float(np.abs(lats["cpu"]).max())
    lev = int(np.abs(imgs["cuda:0"].astype(int) - imgs["cpu"].astype(int)).max())
    print(f"TINY SD1.5 fp32 card vs CPU: latents max|diff| {err:.3e} (bound {bound_:.3e}); "
          f"W8A8 image max |diff| {lev} levels (bound 1)")
    if not err <= bound_ or lev > 1:
        raise SystemExit("the TINY SD1.5 pipeline on the card disagrees with the CPU run")


# W8A8 against bf16 image of request (a), in levels of 255: (mean, max). The
# JAX suite's bound on VAE_TINY is (4, 32) (tests/test_vae_quant_parity.py);
# at full width with random weights this path measures 5.060 / 75 on an
# NVIDIA H100 80GB HBM3, and the JAX package's own VAE_SD W8A8 decode shows a
# gap of that size on the CPU (tools/vae_w8a8_gap.py; PERF.md §6), so the
# gate is the measurement with a margin.
W8A8_IMAGE_BOUND = (6.0, 96)
SD_PROMPTS = ["a photo of an astronaut riding a horse on mars",
              "a fluffy cat sitting on a red chair, oil painting",
              "a lighthouse on a cliff at sunset, high detail"]


def phase_sd_image(name: str) -> dict:
    """The SD1.5 text-to-image path at full width: CLIP-L, the SD15 UNet and
    VAE_SD (random weights from seed 0), bf16, three requests, the decoder
    calibrated on the first request's latents and every image decoded by the
    calibrated W8A8 decoder."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    import onnxstream_tpu_torch.runtime.executor as executor_mod
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.kernels.qconv import qconv, qconv_reference
    from onnxstream_tpu_torch.kernels.qmatmul import qmatmul, qmatmul_reference
    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline, qu8_decoder
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder
    from onnxstream_tpu_torch.runtime.quantization import RangeData

    _tiny_pipeline_card_vs_cpu()

    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.from_synthetic(tiny=False, seed=0, compute_dtype="bfloat16",
                                                  device=torch.device("cuda:0"))
    vae = build_vae_decoder(dataclasses.replace(VAE_SD, sample=pipe.lath), seed=2)  # the pipeline's decoder
    print(f"SD1.5 pipeline (CLIP-L, SD15 UNet, VAE_SD + its 32 x 32 tile decoder) built in "
          f"{time.perf_counter() - t0:.1f} s")
    flash = _FlashSites(flash_attention_packed, flash_attention_packed_reference, 2e-2)
    qmm = _GraphSiteCheck(qmatmul, qmatmul_reference, 0.0, _about_qlinear)
    qcv = _GraphSiteCheck(qconv, qconv_reference, 0.0, _about_qlinear)
    cal_dir = os.path.join(REPO, ".cache", "chip_smoke")
    os.makedirs(cal_dir, exist_ok=True)
    rd_path = os.path.join(cal_dir, "range_data.txt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, ms = {}, {}
    # the path: three requests, calibration, five decodes; the counts are zeroed just before it
    flash_attention_packed.launches = qmatmul.launches = qconv.launches = 0
    attention_op.flash_attention_packed = flash
    executor_mod.qmatmul, executor_mod.qconv = qmm, qcv
    try:
        for key, prompt, steps, sampler, loop in [("a", SD_PROMPTS[0], 10, "euler_a", "device"),
                                                  ("b", SD_PROMPTS[1], 10, "euler", "device"),
                                                  ("c", SD_PROMPTS[2], 6, "dpm++2m", "host")]:
            gen = pipe.generate_on_device if loop == "device" else pipe.generate
            n0, runs = flash_attention_packed.launches, 2 * steps
            flash.arm()
            res[key], ms[key] = _timed(lambda: gen(prompt, "", steps=steps, seed=42, sampler=sampler, decode=False))
            n1 = flash_attention_packed.launches - n0
            lat = res[key].latents
            print(f"request ({key}) {sampler}, {steps} steps, {loop} loop: latents {lat.shape} "
                  f"finite={np.isfinite(lat).all()} max|lat| {np.abs(lat).max():.3f}, {ms[key]:.1f} ms, "
                  f"flash_attention_packed launches {n1} (want {10 * runs}) [{name}]")
            if lat.shape != (4, 64, 64) or not np.isfinite(lat).all() or n1 != 10 * runs:
                raise SystemExit(f"request ({key}): bad latents or {n1} flash launches")
            flash.check(f"request ({key})")
        # --decoder-calibrate on (a)'s latents, range_data.txt written and read back
        pipe.calibrate_decoder(True)
        t1 = time.perf_counter()
        _decode_image(pipe, res["a"].latents)
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t1
        pipe.calibrate_decoder(False)
        pipe.calibration_ranges().write(rd_path)
        ranges = RangeData.read(rd_path).data
        print(f"calibration: eager decode of (a) in {cal_s:.2f} s, {len(ranges)} ranges -> {rd_path}")
        float_decoder = pipe.vae_decoder
        w8a8 = pipe.vae_decoder = qu8_decoder(vae.to_text(), vae.weights, ranges, "bfloat16",
                                              torch.device("cuda:0"))
        images = {}
        for key in ("a", "b", "c"):
            c0, f0 = qmatmul.launches, flash_attention_packed.launches
            d0 = len(flash.head_dims)
            flash.arm(), qmm.arm(), qcv.arm()
            images[key], ms[f"w8a8_{key}"] = _timed(lambda: _decode_image(pipe, res[key].latents))
            nq, nf = qmatmul.launches - c0, flash_attention_packed.launches - f0
            dims = flash.head_dims[d0:]
            print(f"W8A8 decode of ({key}): {images[key].shape} {images[key].dtype}, {ms[f'w8a8_{key}']:.1f} ms, "
                  f"qmatmul launches {nq} (want 39: 4 MatMuls + 35 through qconv), flash launches {nf} at head "
                  f"dims {dims} (want one at 512) [{name}]")
            if nq != 39 or nf != 1 or dims != [512]:
                raise SystemExit(f"W8A8 decode of ({key}): {nq} qmatmul / {nf} flash launches, head dims {dims}")
            for site, what in ((flash, "flash d512"), (qmm, "qmatmul"), (qcv, "qconv")):
                site.check(f"W8A8 decode of ({key}), {what}")
        # the float decoder: (a) whole and tiled
        pipe.vae_decoder = float_decoder
        f0 = flash_attention_packed.launches
        img_bf16, ms["bf16"] = _timed(lambda: _decode_image(pipe, res["a"].latents))
        img_tiled, ms["tiled"] = _timed(lambda: _decode_image(pipe, res["a"].latents, tiled=True))
        print(f"bf16 decode of (a) {ms['bf16']:.1f} ms, tiled (9 tiles of 32 x 32 latents) {ms['tiled']:.1f} ms, "
              f"flash launches {flash_attention_packed.launches - f0} (want 1: the tiles' 1024 tokens are "
              f"under the size gate)")
        if flash_attention_packed.launches - f0 != 1:
            raise SystemExit("the bf16 decodes did not launch the flash kernel once")
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
        executor_mod.qmatmul, executor_mod.qconv = qmatmul, qconv
    launches = {"flash_attention_packed": flash_attention_packed.launches, "qmatmul": qmatmul.launches,
                "qconv": qconv.launches}
    peak = max(flash.peak, qmm.peak, qcv.peak, torch.cuda.max_memory_allocated())
    print(f"SD image path launches: {launches}; peak device memory {peak / 2**20:.1f} MB [{name}]")
    if len({images[k].tobytes() for k in images}) != 3:
        raise SystemExit("the three requests gave the same image")
    d = np.abs(images["a"].astype(np.int32) - img_bf16.astype(np.int32))
    dt = np.abs(img_tiled.astype(np.int32) - img_bf16.astype(np.int32))
    print(f"W8A8 vs bf16 image of (a): mean |diff| {d.mean():.3f}, max |diff| {d.max()} levels (bound mean "
          f"< {W8A8_IMAGE_BOUND[0]}, max < {W8A8_IMAGE_BOUND[1]}); tiled vs whole bf16: mean {dt.mean():.3f}, "
          f"max {dt.max()}")
    if not (d.mean() < W8A8_IMAGE_BOUND[0] and d.max() < W8A8_IMAGE_BOUND[1]):
        raise SystemExit("the W8A8 image drifted from the bf16 image")

    # warm times of the path's pieces
    _, ms["clip"] = _timed(lambda: pipe.encode_prompt(SD_PROMPTS[0]))
    _, ms["loop"] = _timed(lambda: pipe.generate_on_device(SD_PROMPTS[0], "", steps=10, seed=42, decode=False))
    unet = pipe.unet
    _, ms["step"] = _timed(lambda: unet.run(device_outputs=True))
    syncs = [_syncs_in(lambda: pipe.generate_on_device(SD_PROMPTS[0], "", steps=n, seed=42, decode=False))
             for n in (2, 4)]
    print(f"host syncs reported in generate_on_device (prompt encodings and the latents' copy included): "
          f"{syncs[0]} for 2 steps, {syncs[1]} for 4 steps")
    if syncs[1] > syncs[0]:
        raise SystemExit("the SD device loop syncs with the host on every step")
    pipe.vae_decoder = w8a8
    _, ms["w8a8"] = _timed(lambda: _decode_image(pipe, res["a"].latents))
    pipe.vae_decoder = float_decoder
    _, ms["bf16_warm"] = _timed(lambda: _decode_image(pipe, res["a"].latents))
    _, ms["tiled_warm"] = _timed(lambda: _decode_image(pipe, res["a"].latents, tiled=True))
    print(f"SD1.5 image path, warm [{name}]: CLIP-L {ms['clip']:.2f} ms, UNet step (one CFG branch) "
          f"{ms['step']:.2f} ms, euler_a loop of 10 steps {ms['loop']:.1f} ms, decode bf16 {ms['bf16_warm']:.1f} ms, "
          f"W8A8 {ms['w8a8']:.1f} ms, tiled bf16 {ms['tiled_warm']:.1f} ms; calibration {cal_s:.2f} s")
    z = torch.as_tensor(res["a"].latents).cuda() / np.float32(pipe.vae_scale)
    for label, sess in (("W8A8 decode", w8a8), ("bf16 decode", float_decoder)):
        sess.clear_tensors()
        sess.add_tensor("latent", z[None])
        profile_steps(lambda: sess.run(device_outputs=True), name, label, steps=1)

    # one W8A8 decode's calls recorded: every call against the twin, then replayed
    qmm.calls, qcv.calls = [], []
    executor_mod.qmatmul, executor_mod.qconv = qmm, qcv
    try:
        w8a8.clear_tensors()
        w8a8.add_tensor("latent", z[None])
        w8a8.run(device_outputs=True)
    finally:
        executor_mod.qmatmul, executor_mod.qconv = qmatmul, qconv
    calls = {"qmatmul": qmm.calls, "qconv": qcv.calls}
    qmm.calls = qcv.calls = None
    errs = {k: check_qlinear_calls(k, kern, twin, calls[k], "one W8A8 decode, the graph's own operands")
            for k, kern, twin in (("qmatmul", qmatmul, qmatmul_reference), ("qconv", qconv, qconv_reference))}
    ops_total = sum(_qmatmul_cost(*a, **k)[1] for a, k in calls["qmatmul"]) + \
        sum(_qconv_cost(*a, **k)[1] for a, k in calls["qconv"])
    print(f"one W8A8 decode: {len(calls['qmatmul'])} MatMuls + {len(calls['qconv'])} convs, "
          f"{ops_total / 1e12:.3f} T integer operations, bound {ops_total / PEAK_OPS_PER_S['int8'] * 1e3:.3f} ms "
          f"at the int8 peak")
    times = {
        "qmatmul": replay_times("qmatmul over one W8A8 decode's MatMuls (bf16 out)", calls["qmatmul"], qmatmul,
                                qmatmul_reference, _matmul_library, "int8", name, cost=_qmatmul_cost),
        "qconv": replay_times("qconv over one W8A8 decode's convs (bf16 out)", calls["qconv"], qconv,
                              qconv_reference, _conv_library, "int8", name, cost=_qconv_cost)}
    out = {k: {"launches": launches[k], "max_abs_err": max(errs[k], (qmm if k == "qmatmul" else qcv).worst),
               **times[k]} for k in ("qmatmul", "qconv")}
    out["flash_launches"] = launches["flash_attention_packed"]
    return out


def _logit_trace(pipe, seq):
    pipe.reset()
    out = [pipe.forward(seq)[1]]
    out.append(pipe.forward([4])[1])
    out.append(pipe.forward([8, 2, 7])[1])
    out.append(pipe.forward([11])[1])
    return out


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _syncs_in(fn) -> int:
    """Host syncs the CUDA runtime reports while fn runs (sync debug mode)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _tiny_llama_card_vs_cpu(label: str, rel: float, **kw) -> None:
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    seq, prompt = [1, 5, 7, 9, 2, 3], [3, 17, 99, 5]
    runs = {dev: LlamaPipeline(LLAMA_TINY, buckets=[8, 16, 32], device=torch.device(dev), **kw)
            for dev in ("cuda:0", "cpu")}
    traces = {dev: _logit_trace(p, seq) for dev, p in runs.items()}
    for dev, p in runs.items():
        p.reset()
    toks = {dev: p.generate(prompt, 8) for dev, p in runs.items()}
    runs["cuda:0"].reset()
    dev_toks = runs["cuda:0"].generate_on_device(prompt, 8)
    errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(traces["cuda:0"], traces["cpu"])]
    print(f"{label} fp32 card vs CPU: logits max|diff|/max|logits| {max(errs):.3e} (bound {rel:g}); "
          f"tokens card {toks['cuda:0']} cpu {toks['cpu']} on-device {dev_toks}")
    if not max(errs) <= rel or toks["cuda:0"] != toks["cpu"] or dev_toks != toks["cpu"]:
        raise SystemExit(f"{label} on the card disagrees with the CPU run")


LLM_REQUESTS = [("request 1: 700-token prompt (bucket 1024)", None),
                ("request 2: 100-token follow-up (L 128, P 1024)", None),
                ("request 3: 300-token prompt after reset (bucket 512)", "reset")]


def _decode_measurements(pipe, name: str, label: str, p1) -> None:
    """Warm prefill of p1, decode ms/token on both loops at P 1024, host
    syncs per decode_on_device call, profiles of decode and prefill."""
    pipe.reset()
    (_, _), ms_pf = _timed(lambda: pipe.forward(p1, want_logits=False))
    print(f"{label} prefill of 700 tokens (bucket 1024), warm: {ms_pf:.2f} ms = {700 / ms_pf * 1e3:.0f} tok/s [{name}]")
    first = pipe.forward([5], want_logits=False)[0]
    pipe.decode_on_device(first, 8)  # warm
    _, ms_dev = _timed(lambda: pipe.decode_on_device(first, 32))
    _, ms_host = _timed(lambda: [pipe.forward([first], want_logits=False) for _ in range(8)])
    print(f"{label} decode at P 1024: on-device loop {ms_dev / 32:.2f} ms/token, host loop "
          f"{ms_host / 8:.2f} ms/token [{name}]")
    s8 = _syncs_in(lambda: pipe.decode_on_device(first, 8))
    s32 = _syncs_in(lambda: pipe.decode_on_device(first, 32))
    print(f"{label} host syncs reported in decode_on_device: {s8} for 8 tokens, {s32} for 32 tokens")
    if s32 > s8:
        raise SystemExit(f"{label}: host syncs grow with the decoded tokens ({s8} for 8, {s32} for 32)")
    profile_steps(lambda: pipe.decode_on_device(first, 4), name, f"{label} decode_on_device(4 tokens)")
    pipe.reset()
    profile_steps(lambda: (pipe.reset(), pipe.forward(p1, want_logits=False)), name,
                  f"{label} prefill 700 (bucket 1024)")


def phase_llm(name: str) -> dict:
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference
    from onnxstream_tpu_torch.models.llm.llama import TINYLLAMA, param_count
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    # small model first: the LLM path on the card against the CPU, fp32
    _tiny_llama_card_vs_cpu("LLAMA_TINY", 1e-4)

    t0 = time.perf_counter()
    pipe = LlamaPipeline(TINYLLAMA, compute_dtype="bfloat16", device=torch.device("cuda:0"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, TINYLLAMA.vocab_size, n).tolist() for n in (700, 100, 300)]
    p1, p3 = prompts[0], prompts[2]
    torch.cuda.reset_peak_memory_stats()
    # the main path: three chat requests; the counts are zeroed just before it
    flash_attention.launches = 0
    outs = []
    # each request's first launch is checked against the twin on the graph's
    # own operands (its time, one twin call, is inside the request's time)
    site = _GraphSiteCheck(flash_attention, flash_attention_reference, 2e-2, _about_flash)
    attention_op.flash_attention = site
    try:
        for (label, pre), ids in zip(LLM_REQUESTS, prompts):
            if pre == "reset":
                pipe.reset()
            before = flash_attention.launches
            site.arm()
            toks_i, ms = _timed(lambda: pipe.generate_on_device(ids, max_new_tokens=32))
            n_launch = flash_attention.launches - before
            outs.append(toks_i)
            print(f"{label}: {len(toks_i)} tokens in {ms:.1f} ms, cache_len {pipe.cache_len}, "
                  f"flash_attention launches {n_launch} (want 22) [{name}]")
            if len(toks_i) != 32 or not all(0 <= t < TINYLLAMA.vocab_size for t in toks_i):
                raise SystemExit(f"{label}: bad tokens {toks_i}")
            if n_launch != 22:
                raise SystemExit(f"{label}: {n_launch} flash_attention launches, want 22")
            site.check(label)
    finally:
        attention_op.flash_attention = flash_attention
    launches = flash_attention.launches
    peak = max(site.peak, torch.cuda.max_memory_allocated())
    wbytes = pipe.device_weight_bytes()
    print(f"TinyLlama bf16: {param_count(TINYLLAMA) / 1e9:.3f} B params, three requests done "
          f"{time.perf_counter() - t0:.1f} s after the pipeline was made (weights built, uploaded once, "
          f"{len(pipe._sessions)} bucket sessions planned)")
    print(f"peak device memory {peak / 2**20:.1f} MB, device weights {wbytes / 2**20:.1f} MB [{name}]")
    for key, sess in pipe._sessions.items():
        if len(sess._executors) != 1:
            raise SystemExit(f"bucket {key}: {len(sess._executors)} executors, want 1")

    # on-device decode against the host loop, request 3
    pipe.reset()
    host = pipe.generate(p3, max_new_tokens=32)
    print(f"request 3 host loop == on-device decode: {host == outs[2]}")
    if host != outs[2]:
        raise SystemExit(f"on-device decode {outs[2]} != host loop {host}")

    # flash on vs off on request 1's last-position logits
    sess = pipe._session(1024, 0)
    pipe.reset()
    (_, on), ms_on = _timed(lambda: pipe.forward(p1))
    sess.set_option("use_flash_attention", False)
    pipe.reset()
    (_, off), ms_off = _timed(lambda: pipe.forward(p1))
    sess.set_option("use_flash_attention", True)
    pipe.reset()
    pipe.forward(p1, want_logits=False)  # plans the bucket anew after set_option
    diff, ref = float(np.abs(on - off).max()), float(np.abs(off).max())
    print(f"flash on vs off, request 1 last logits: max|diff| {diff:.4e}, max|logits| {ref:.4f}, "
          f"ratio {diff / ref:.4e} (bound 5e-2)")
    if not diff <= 5e-2 * ref:
        raise SystemExit("flash-on and flash-off logits disagree")
    # which of the two bf16 runs is nearer the float32 model (same weights)
    p32 = LlamaPipeline(TINYLLAMA, compute_dtype="float32", device=torch.device("cuda:0"))
    p32._weight_bank = pipe._weight_bank  # the same host weights, not generated again
    _, l32 = p32.forward(p1)
    del p32
    torch.cuda.empty_cache()
    scale = float(np.abs(l32).max())
    print(f"bf16 last logits vs the float32 model: flash on {np.abs(on - l32).max() / scale:.4e}, "
          f"flash off {np.abs(off - l32).max() / scale:.4e} (max|diff| / max|logits|); "
          f"with the (1024, 32003) logits copied to the host: flash on {ms_on:.2f} ms, "
          f"flash off {ms_off:.2f} ms (plan included)")
    _decode_measurements(pipe, name, "bf16", p1)
    return {"launches": launches, "bank": pipe._weight_bank, "logits_p1": on, "logits_p1_f32": l32,
            "prompts": prompts}


def _nrms(x: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-9))


def _int8_vs_bf16_two_layers(prompt) -> float:
    """nrms of int8 against bf16 last logits of TinyLlama at full width, cut
    to the depth of the model its bound was set on (tests/test_llm.py,
    LLAMA_TINY, 2 layers): the weights' and activations' rounding adds up
    over the layers, so at full depth the same quantization drifts further."""
    from onnxstream_tpu_torch.models.llm.llama import TINYLLAMA
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    cfg = dataclasses.replace(TINYLLAMA, layers=2)
    bank, logits = {}, []
    for int8 in (False, True):
        p = LlamaPipeline(cfg, compute_dtype="bfloat16", device=torch.device("cuda:0"), int8_weights=int8)
        p._weight_bank = bank  # one set of host weights for both
        logits.append(p.forward(prompt)[1])
        del p
    gc.collect()
    torch.cuda.empty_cache()
    return _nrms(logits[1], logits[0])


def phase_llm_int8(name: str, llm: dict) -> dict:
    import onnxstream_tpu_torch.runtime.executor as executor_mod
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention
    from onnxstream_tpu_torch.kernels.qmatmul import w8a8_dyn_matmul, w8a8_dyn_matmul_reference
    from onnxstream_tpu_torch.models.llm.llama import TINYLLAMA
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
    from onnxstream_tpu_torch.runtime.session import Session

    _tiny_llama_card_vs_cpu("LLAMA_TINY int8", 1e-3, int8_weights=True)

    prompts = llm["prompts"]
    p1, p3 = prompts[0], prompts[2]
    per_run = 7 * TINYLLAMA.layers + 1  # q k v o gate up down per layer + the LM head
    pipe = LlamaPipeline(TINYLLAMA, compute_dtype="bfloat16", device=torch.device("cuda:0"), int8_weights=True)
    pipe._weight_bank = llm["bank"]  # the bf16 phase's host weights, not generated again
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    site = _GraphSiteCheck(w8a8_dyn_matmul, w8a8_dyn_matmul_reference, 1e-2, _about_qmm)
    graph_runs = [0]
    session_run = Session.run

    def counted_run(self, *args, **kw):
        graph_runs[0] += 1
        return session_run(self, *args, **kw)

    t0 = time.perf_counter()
    outs = []
    # the path: three chat requests; the counts are zeroed just before it
    w8a8_dyn_matmul.launches = 0
    flash_attention.launches = 0
    Session.run = counted_run
    executor_mod.w8a8_dyn_matmul = site
    try:
        for (label, pre), ids in zip(LLM_REQUESTS, prompts):
            if pre == "reset":
                pipe.reset()
            b6, b2, r0 = w8a8_dyn_matmul.launches, flash_attention.launches, graph_runs[0]
            site.arm()
            toks_i, ms = _timed(lambda: pipe.generate_on_device(ids, max_new_tokens=32))
            n6, n2, runs = w8a8_dyn_matmul.launches - b6, flash_attention.launches - b2, graph_runs[0] - r0
            outs.append(toks_i)
            print(f"int8 {label}: {len(toks_i)} tokens in {ms:.1f} ms, {runs} graph runs, w8a8_dyn_matmul "
                  f"launches {n6} (want {per_run} x {runs} = {per_run * runs}), flash_attention launches {n2} "
                  f"(want 22) [{name}]")
            if len(toks_i) != 32 or not all(0 <= t < TINYLLAMA.vocab_size for t in toks_i):
                raise SystemExit(f"int8 {label}: bad tokens {toks_i}")
            if n6 != per_run * runs or n2 != 22:
                raise SystemExit(f"int8 {label}: {n6} w8a8_dyn_matmul / {n2} flash launches over {runs} runs")
            site.check(f"int8 {label}")
    finally:
        Session.run = session_run
        executor_mod.w8a8_dyn_matmul = w8a8_dyn_matmul
    launches = w8a8_dyn_matmul.launches
    peak = max(site.peak, torch.cuda.max_memory_allocated())
    wbytes = pipe.device_weight_bytes()
    print(f"TinyLlama int8: three requests done {time.perf_counter() - t0:.1f} s after the pipeline was made "
          f"(host quantization at first fetch {pipe.quantize_seconds():.1f} s, {len(pipe._sessions)} bucket "
          f"sessions) [{name}]")
    print(f"int8 peak device memory {peak / 2**20:.1f} MB over {base / 2**20:.1f} MB held before the phase, "
          f"device weights {wbytes / 2**20:.1f} MB (scales included) [{name}]")

    pipe.reset()
    host = pipe.generate(p3, max_new_tokens=32)
    print(f"int8 request 3 host loop == on-device decode: {host == outs[2]}")
    if host != outs[2]:
        raise SystemExit(f"int8 on-device decode {outs[2]} != host loop {host}")
    pipe.reset()
    _, l8 = pipe.forward(p1)
    lf, l32 = llm["logits_p1"], llm["logits_p1_f32"]
    print(f"TinyLlama ({TINYLLAMA.layers} layers) last logits of request 1, nrms: int8 vs bf16 {_nrms(l8, lf):.4e}, "
          f"int8 vs the float32 model {_nrms(l8, l32):.4e}, bf16 vs the float32 model {_nrms(lf, l32):.4e}")
    two = _int8_vs_bf16_two_layers(p1)
    print(f"TinyLlama at full width cut to 2 layers, last logits of request 1: int8 vs bf16 nrms {two:.4e} "
          f"(bound 0.15, set on 2 layers)")
    if not two < 0.15:
        raise SystemExit("int8 logits drifted from the bf16 pipeline's")
    _decode_measurements(pipe, name, "int8", p1)

    # one decode step's and one prefill's calls recorded and replayed
    recorded = {}
    executor_mod.w8a8_dyn_matmul = site
    try:
        site.calls = []
        pipe.reset()
        first = pipe.forward(p1, want_logits=False)[0]
        recorded["prefill"], site.calls = site.calls, []
        pipe.decode_on_device(first, 1)
        recorded["decode"], site.calls = site.calls, None
    finally:
        executor_mod.w8a8_dyn_matmul = w8a8_dyn_matmul

    def int_mm(a, w, ws, out_dtype=None):
        return _int_mm_or_none(_quantize_rows(a), w)

    times = {k: replay_times(f"w8a8_dyn_matmul over one TinyLlama {k} run (bf16)", calls, w8a8_dyn_matmul,
                             w8a8_dyn_matmul_reference, int_mm, "int8", name)
             for k, calls in recorded.items()}
    return {"launches": launches, "max_abs_err": site.worst, **times["decode"]}


def main() -> int:
    sys.path.insert(0, REPO)
    name = phase_device()
    phase_build()
    kernel = phase_kernel(name)
    kernel_hm = phase_kernel_head_major(name)
    phase_kernel_q(name)
    phase_kernel_qlinear(name)
    gn_sites = phase_kernel_gn(name)
    sd = phase_slice(name)
    launches_sd = sd["launches"]
    gn = phase_gn_routes(name, sd)
    gc.collect()
    torch.cuda.empty_cache()
    sd_u8 = phase_sd_u8(name, sd)
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    sd_image = phase_sd_image(name)
    gc.collect()
    torch.cuda.empty_cache()
    llm = phase_llm(name)
    launches_llm = llm["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    llm_int8 = phase_llm_int8(name, llm)
    print(f"card: {name}")
    fa_src = "onnxstream_tpu_torch/kernels/csrc/flash_attention.cu"
    q_src = "onnxstream_tpu_torch/kernels/csrc/qmatmul.cu"
    ql_src = "onnxstream_tpu_torch/kernels/csrc/qlinear.cu"
    gn_src = "onnxstream_tpu_torch/kernels/csrc/gn_conv.cu"
    q_py = "onnxstream_tpu/kernels/qmatmul.py"
    print(json.dumps({"kernels": [
        {"name": "flash_attention_packed", "route": "cuda", "source": fa_src,
         "replaces": "onnxstream_tpu/kernels/flash_attention.py:260", **kernel,
         "launches": sd_image["flash_launches"],
         "launches_by_path": {"sd15_step": launches_sd, "sd15_image": sd_image["flash_launches"]}},
        {"name": "flash_attention", "route": "cuda", "source": fa_src,
         "replaces": "onnxstream_tpu/kernels/flash_attention.py:366", **kernel_hm, "launches": launches_llm},
        {"name": "w8a8_dyn_matmul", "route": "cuda", "source": q_src, "replaces": f"{q_py}:332", **llm_int8},
        {"name": "w8_matmul", "route": "cuda", "source": q_src, "replaces": f"{q_py}:186", **sd_u8},
        {"name": "qmatmul", "route": "cuda", "source": ql_src, "replaces": f"{q_py}:73", **sd_image["qmatmul"]},
        {"name": "qconv", "route": "cuda", "source": ql_src, "replaces": "onnxstream_tpu/kernels/qconv.py:68",
         **sd_image["qconv"]},
        {"name": "gn_silu", "route": "cuda", "source": gn_src, "replaces": "onnxstream_tpu/kernels/gn_silu.py:121",
         **gn["gn_silu"], "ms_by_shape": gn_sites["gn_silu"]},
        {"name": "gn_silu_conv", "route": "cuda", "source": gn_src,
         "replaces": "onnxstream_tpu/kernels/gn_conv.py:178", **gn["gn_silu_conv"],
         "ms_by_shape": gn_sites["gn_silu_conv"]},
        {"name": "matmul", "route": "cuda", "source": "onnxstream_tpu_torch/kernels/csrc/matmul.cu",
         "replaces": "onnxstream_tpu/kernels/matmul.py:74", **gn["matmul"], "ms_by_shape": gn_sites["matmul"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

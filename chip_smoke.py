"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card, its power limit, the CUDA and nvcc
     versions and the precision flags in effect;
  2. build: compile the flash-attention kernels from the checkout's source;
  3. kernel vs twin: both wrappers of the CUDA kernel against their plain
     PyTorch twins, fp32 (TF32 off) and bf16: the packed form at the two
     SD1.5 site shapes and at GQA / causal edge cases, the head-major form at
     the three TinyLlama prefill sites (1024 x 1024, 128 x 1024, 512 x 512)
     and at every mask group, k_transposed, GQA,
     causal M > N (exactly 0) and D = 128 / 256; with the kernels' and twins'
     times at the SD1.5 and TinyLlama sites;
  4. SD slice: the SD1.5 UNet at full width (random weights from seed 0) in
     bf16 through the port's Session answers three requests; each must be
     finite, (1, 4, 64, 64), and launch the packed kernel exactly 10 times;
     the first request is rerun with the flash kernel off and must agree; the
     TINY UNet in fp32 on the card must agree with the same graph run on the
     CPU;
  5. LLM slice: LLAMA_TINY in fp32 on the card against the CPU (tokens equal,
     logits within 1e-4 * max), then TinyLlama 1.1B at full width (random
     weights from seed 0) in bf16 through LlamaPipeline answers three chat
     requests (a 700-token prompt, a 100-token follow-up, a 300-token prompt
     after reset; 32 greedy tokens each, decoded on the device), each with
     exactly 22 head-major kernel launches (one per layer for its one gated
     run; L = 1 decode runs launch none), and the first launch of each is
     held against the twin on the operands the graph passed it (bf16,
     rtol = atol = 2e-2); flash on and off agree on the
     prompt's last logits; on-device decode equals the host loop; prefill and
     decode times, peak memory and weight bytes are printed.

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
    print(f"build: flash_attention.cu (flash_attention_packed, flash_attention) in "
          f"{time.perf_counter() - t0:.1f} s -> {path}")
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
    print(f"profile of {label} over {steps} warm steps [{name}]: wall {wall_ms:.2f} ms/step (profiler on), "
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
    return launches


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
    t_k = cuda_ms(lambda: flash_attention(q, k, v, mask=mask))
    t_p = cuda_ms(lambda: flash_attention_reference(q, k, v, mask=mask))
    print(f"time bf16 (1, 32, {L}, {D}) with a (1, 1, {L}, {L}) bf16 mask: kernel {t_k:.4f} ms, "
          f"twin {t_p:.4f} ms  [{name}]")
    return {"max_abs_err": site_err, "ms": t_k, "plain_ms": t_p}


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


class _GraphSiteCheck:
    """Stands in for the flash_attention that ops/attention.py calls. After
    arm(), the next call's kernel output is held against the twin on the very
    operands the graph passed: q, k, v with the strides the graph gave them
    and the mask as the graph built it. The kernel's launch count is the
    wrapper's own; the twin launches nothing. The twin's float32 scores are
    kept out of the device memory peak: ``peak`` is the peak before each
    check, and the allocator's peak is reset after it."""

    def __init__(self, kernel, twin, tol: float):
        self.kernel, self.twin, self.tol = kernel, twin, tol
        self.armed, self.result, self.peak = False, None, 0

    def arm(self):
        self.armed, self.result = True, None

    def __call__(self, q, k, v, mask=None, scale=None, k_transposed=False, causal=False):
        out = self.kernel(q, k, v, mask=mask, scale=scale, k_transposed=k_transposed, causal=causal)
        if self.armed:
            self.armed = False
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            ref = self.twin(q, k, v, mask=mask, scale=scale, k_transposed=k_transposed, causal=causal)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=self.tol, atol=self.tol)
            about = (f"max|twin| {ref.float().abs().max().item():.4f}; "
                     f"q {tuple(q.shape)} strides {q.stride()}, k {tuple(k.shape)} strides {k.stride()} "
                     f"k_transposed={k_transposed}, v strides {v.stride()}, mask "
                     + ("none" if mask is None else
                        f"{tuple(mask.shape)} {str(mask.dtype)[6:]} strides {mask.stride()}")
                     + f", causal={causal}")
            self.result = (ok, err, about)
            del ref
            torch.cuda.reset_peak_memory_stats()
        return out


def phase_llm(name: str) -> int:
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_reference
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY, TINYLLAMA, param_count
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    # small model first: the LLM path on the card against the CPU, fp32
    seq, prompt = [1, 5, 7, 9, 2, 3], [3, 17, 99, 5]
    runs = {dev: LlamaPipeline(LLAMA_TINY, buckets=[8, 16, 32], device=torch.device(dev))
            for dev in ("cuda:0", "cpu")}
    traces = {dev: _logit_trace(p, seq) for dev, p in runs.items()}
    for dev, p in runs.items():
        p.reset()
    toks = {dev: p.generate(prompt, 8) for dev, p in runs.items()}
    runs["cuda:0"].reset()
    dev_toks = runs["cuda:0"].generate_on_device(prompt, 8)
    errs = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(traces["cuda:0"], traces["cpu"])]
    print(f"LLAMA_TINY fp32 card vs CPU: logits max|diff|/max|logits| {max(errs):.3e} (bound 1e-4); "
          f"tokens card {toks['cuda:0']} cpu {toks['cpu']} on-device {dev_toks}")
    if not max(errs) <= 1e-4 or toks["cuda:0"] != toks["cpu"] or dev_toks != toks["cpu"]:
        raise SystemExit("LLAMA_TINY on the card disagrees with the CPU run")

    t0 = time.perf_counter()
    pipe = LlamaPipeline(TINYLLAMA, compute_dtype="bfloat16", device=torch.device("cuda:0"))
    rng = np.random.default_rng(0)
    p1, p2, p3 = (rng.integers(3, TINYLLAMA.vocab_size, n).tolist() for n in (700, 100, 300))
    torch.cuda.reset_peak_memory_stats()
    # the main path: three chat requests; the counts are zeroed just before it
    flash_attention.launches = 0
    requests = [("request 1: 700-token prompt (bucket 1024)", None, p1),
                ("request 2: 100-token follow-up (L 128, P 1024)", None, p2),
                ("request 3: 300-token prompt after reset (bucket 512)", "reset", p3)]
    outs = []
    # each request's first launch is checked against the twin on the graph's
    # own operands (its time, one twin call, is inside the request's time)
    site = _GraphSiteCheck(flash_attention, flash_attention_reference, 2e-2)
    attention_op.flash_attention = site
    try:
        for label, pre, ids in requests:
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
            if site.result is None:
                raise SystemExit(f"{label}: no flash_attention call reached the graph-site check")
            ok, err, about = site.result
            print(f"  first launch vs twin on the graph's operands: max|diff| {err:.3e} "
                  f"(rtol=atol={site.tol}) {'ok' if ok else 'FAIL'}; {about}")
            if not ok:
                raise SystemExit(f"{label}: the kernel disagrees with its twin on the graph's operands")
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

    # flash on vs off on request 1's last-position logits; warm prefill times
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
          f"flash off {np.abs(off - l32).max() / scale:.4e} (max|diff| / max|logits|)")
    pipe.reset()
    (_, _), ms_pf = _timed(lambda: pipe.forward(p1, want_logits=False))
    print(f"prefill of 700 tokens (bucket 1024), warm: {ms_pf:.2f} ms = {700 / ms_pf * 1e3:.0f} tok/s "
          f"with flash; with the (1024, 32003) logits copied to the host: flash on {ms_on:.2f} ms, "
          f"flash off {ms_off:.2f} ms (plan included) [{name}]")

    # decode: on-device loop and host loop, ms per token (P = 1024)
    first = pipe.forward([5], want_logits=False)[0]
    pipe.decode_on_device(first, 8)  # warm
    _, ms_dev = _timed(lambda: pipe.decode_on_device(first, 32))
    _, ms_host = _timed(lambda: [pipe.forward([first], want_logits=False) for _ in range(8)])
    print(f"decode bf16 at P 1024: on-device loop {ms_dev / 32:.2f} ms/token, host loop "
          f"{ms_host / 8:.2f} ms/token [{name}]")
    s8 = _syncs_in(lambda: pipe.decode_on_device(first, 8))
    s32 = _syncs_in(lambda: pipe.decode_on_device(first, 32))
    print(f"host syncs reported in decode_on_device: {s8} for 8 tokens, {s32} for 32 tokens")
    profile_steps(lambda: pipe.decode_on_device(first, 4), name, "decode_on_device(4 tokens)")
    pipe.reset()
    profile_steps(lambda: (pipe.reset(), pipe.forward(p1, want_logits=False)), name, "prefill 700 (bucket 1024)")
    return launches


def main() -> int:
    sys.path.insert(0, REPO)
    name = phase_device()
    phase_build()
    kernel = phase_kernel(name)
    kernel_hm = phase_kernel_head_major(name)
    launches = phase_slice(name)
    launches_hm = phase_llm(name)
    print(f"card: {name}")
    src = "onnxstream_tpu_torch/kernels/csrc/flash_attention.cu"
    print(json.dumps({"kernels": [
        {"name": "flash_attention_packed", "route": "cuda", "source": src,
         "replaces": "onnxstream_tpu/kernels/flash_attention.py:260", "launches": launches, **kernel},
        {"name": "flash_attention", "route": "cuda", "source": src,
         "replaces": "onnxstream_tpu/kernels/flash_attention.py:366", "launches": launches_hm,
         **kernel_hm},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

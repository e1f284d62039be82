"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card, its power limit, the CUDA and nvcc
     versions and the precision flags in effect;
  2. build: compile every kernel source of the checkout (flash_attention.cu,
     qmatmul.cu, qlinear.cu, gn_conv.cu, matmul.cu; their wgmma pipelines share
     gemm_sm90.cuh), one nvcc each, all started together; a ptxas note C7514 /
     C7515 (a serialized wgmma pipeline) naming kernel 6's or kernel 8's wgmma
     kernel fails the run;
  3. kernel vs twin: every wrapper of a CUDA kernel against its plain PyTorch
     twin, fp32 (TF32 off) and bf16:
       - flash_attention_packed at the two SD1.5 UNet site shapes and the
         VAE mid-block site (1 head, d = 512, 4096 tokens), which must take a
         wgmma variant, and at ragged / GQA / causal / d = 512 edge cases,
         each with its variant printed and a second call's bits; 16-bit
         outputs are held both elementwise (rtol = atol = 2e-2) and by the
         relative L2 distance ||out - twin|| / ||twin|| <= FLASH_REL_L2, since
         the outputs' own size is near 2e-2; the UNet sites' times beside
         fa_mma_kernel's (held against the twin too), SDPA and a bound that
         counts the exponentials on the MUFU; flash_attention at the three TinyLlama prefill
         sites (1024 x 1024, 128 x 1024, 512 x 512) and at every mask group,
         k_transposed, GQA (Hkv < H on the wgmma variant too), causal M > N
         (exactly 0) and D = 128 / 256, each case's variant printed, the
         site's time beside the mma variant's;
       - w8a8_dyn_matmul at every TinyLlama MatMul shape (M 1 / 128 / 512 /
         1024) with the (K, N) weight, and with the K-major (N, K) weight the
         int8 route uploads (M 1 / 16 / 17 / 128 / 512 / 1024: the GEMV and
         the s8 wgmma pipeline, split along K or not) bit for bit with the
         twin, a second call and the (K, N) weight, timed beside the (K, N)
         weight's variant; w8_matmul at ragged shapes, per-tensor and
         per-channel;
       - qmatmul and qconv (the calibrated W8A8 kernels) at ragged shapes,
         both weight layouts ((K, N) on the mma.sync kernel, (N, K) on the
         wgmma pipeline, a second call's bits), strides / dilations / pads,
         NCHW convs on the mma.sync kernel and channels-last ones on the
         wgmma pipeline (a second call's bits, and the mma.sync kernel's on
         NCHW copies), float32, bf16 and requantized uint8 outputs, bit for
         bit;
       - gn_silu, gn_silu_conv and matmul (with conv3x3_im2col) at the JAX
         suite's ragged cases (C/G = 5 and 10, H W = 35, 5 x 7 borders, no
         bias, O != C, batch 2) in float32 / bfloat16 / float16, and at the
         sites of the GroupNorm and small-conv routes; gn_silu also with
         K = 2 clusters over groups that start off 16-byte boundaries (alone
         and in batch 2) and at the VAE's 2 and 4 MB groups (K = 8, part of
         each piece streamed), every call twice for equal bits, its plan
         printed (K, resident bytes, clusters the card holds at once) and
         exactly one launch of gn_silu_cluster_kernel a call, read from the
         profiler's kernel names; gn_silu_conv also at
         C % 64 != 0, O = 3 / 4 and 512 x 512, every call twice for equal
         bits, each bf16 case also on the mma.sync variant (a misaligned
         weight) and the sites timed beside it; matmul also at the
         edges of its wgmma pipeline (a ragged last K split, M off the tile,
         K off the k-tile, one 8-column strip, a misaligned view that must
         take the masked kernel), every call twice for equal bits;
     with each kernel's time beside its twin's, its bound and one PyTorch
     call computing the same function where there is one
     (scaled_dot_product_attention, torch._int_mm, a bf16 matmul,
     F.group_norm + F.silu [+ F.conv2d], torch.addmm);
  4. SD slice: the SD1.5 UNet at full width (random weights from seed 0) in
     bf16 through the port's Session answers three requests; each must be
     finite, (1, 4, 64, 64), and launch the packed kernel exactly 10 times,
     every launch on a wgmma variant, the first held against the twin on the
     graph's operands (elementwise and by FLASH_REL_L2);
     the first request is rerun with the flash kernel off and must agree; the
     TINY UNet in fp32 on the card must agree with the same graph run on the
     CPU;
  4b. SD slice under the optional routes, bf16, batch 1: the TINY UNet in
     fp32 under config A (fuse_gn_conv + fuse_groupnorm) and config B
     (use_pallas_smallconv + fuse_groupnorm) on the card against the CPU;
     the SD15 UNet at full width answers the three requests under A and
     under B, each output within 5e-2 * max|out| of the default config's, the
     launch counts equal to the fused graph's op counts (B: 61 gn_silu and
     34 matmul launches per run, the B operand of each the resident (9 C, O)
     weight as uploaded), each kernel's first launch of a request
     held against its twin on the graph's operands; the VAE_SD decoder
     decodes one 64 x 64 latent to 512 x 512 under fuse_groupnorm (30 gn_silu
     launches) and under config A, each image within one level on average of
     the default decode (config A's float output also within 5e-2 *
     max|out|); device busy and wall time of a UNet run (also under
     fuse_groupnorm alone) and a decode under every config, in turns; one
     run's kernel calls replayed against the twins and the library calls
     (gn_silu_conv over a config-A UNet run's 45 and a config-A decode's 29
     calls, also beside its mma.sync variant), and matmul and gn_silu_conv
     at every shape of the run on the graph's operands: the variant and plan
     taken, the twin, a second call's bits, the times; gn_silu the same at
     every shape of a config-B run and of a fuse_groupnorm decode, each
     shape and each run's replay launching gn_silu_cluster_kernel once a
     call and nothing else;
  5. SD slice, uint8 weights: the same UNet through the port's
     quantize_graph_weights (per-tensor uint8[scale,zp], the converter's
     exclusions): TINY in fp32 on the card against the CPU, then SD1.5 in
     bf16 answers the three requests with w8_matmul on every MatMul whose
     weight is 2-D uint8 and 10 packed flash launches each, the first
     w8_matmul launch of each held against the twin on the graph's operands;
     w8_matmul against its twin at every shape the graph gave it, and on the
     graph's own operands at each shape: the variant and plan taken, the
     twin, a second call's bits, the times beside the library's and the bound;
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
     and one flash launch at d = 512 (every flash launch of the path on a
     wgmma variant), the first launch of each kernel held against its twin
     on the graph's operands; the bf16 decoder decodes the
     first whole and tiled; images are (512, 512, 3) uint8, finite before
     the cast; W8A8 against bf16 image within W8A8_IMAGE_BOUND; CLIP, UNet,
     loop, decode and calibration times, peak memory, device profiles of
     both decoders, and one decode's kernel calls checked bit for bit and
     replayed against the twins and cuDNN / matmul on dequantized operands,
     qmatmul at every shape of them on the graph's operands (the (N, K)
     weights as uploaded): the wgmma variant, a second call's bits, the times
     beside the (K, N) weight on the mma.sync kernel; qconv the same (the
     channels-last operands as the graph passed them, beside NCHW copies on
     the mma.sync kernel), which of the 35 convs take which variant, and the
     decoder rebuilt with every conv on the NCHW route: the same bits, and
     both decodes' device profiles (the channels-last quantization's cost);
  6b. SDXL: TINY SDXL in fp32 on the card against the CPU (batch-2 UNet,
     and Turbo), then SDXL base at 1024 x 1024 in bf16 at full width with
     its weights synthesized on the card (CLIP-L + CLIP-bigG, the SDXL UNet
     at batch 2, VAE_SD at the 128 x 128 latent and its 64 x 64 tile
     decoder; plan and synthesis seconds, device weight bytes, peak memory):
     a 10-step euler_a image on the device loop, one batch-2 UNet run a step
     (the CFG pair, row 0 cond, row 1 uncond), with 70 packed flash launches
     a run (10 at 4096 tokens, 60 at 1024; d = 64), the first launch of each
     site shape held against the twin on the graph's operands; its decode
     whole (one launch at 16384 tokens, d = 512) and tiled (9 tiles), their
     gap printed; 2 steps on the host loop against the device loop; one
     batch-2 run with flash off against on, and each of its rows against a
     batch-1 run of the same weights (within 5e-2 * max|out|); SDXL Turbo
     (the batch-2 build freed first): one step through a batch-1 UNet with
     no uncond branch (70 launches), host loop against device loop; device
     busy and wall of a UNet run at batch 1 and 2, the 10-step loop and the
     decodes; one batch-2 run's 70 flash calls replayed beside SDPA and the
     bound, and every site shape (batch 1 and 2, the two VAE sites) on the
     graph's operands;
  6c. SD1.5 generate_batch at full width, bf16, weights synthesized on the
     card: 4 prompts through a batch-4 UNet for 2 euler_a steps (44 flash
     launches, the first of each shape held against the twin), the batch-4
     run's rows against batch-1 runs within 5e-2 * max|out|, device busy and
     wall at batch 4 and 1; then in float32 each image's latents against a
     sequential generate with its seed within 1e-3 * max|lat| (bf16's gap,
     CFG-amplified rounding of the batch's other library kernels, printed);
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
     decode times, peak memory and weight bytes are printed; one prefill's 22
     flash calls are recorded: all on the wgmma variant, held against the
     twin on the graph's operands with a second call's bits, timed beside the
     mma variant, SDPA and the twin, and replayed;
  8. LLM slice, int8 weights: LLAMA_TINY int8 in fp32 on the card against the
     CPU (tokens equal, logits within 1e-3 * max), then TinyLlama with
     int8_weights=True on the same host weights answers the same three
     requests with w8a8_dyn_matmul on all 155 weight MatMuls of every graph
     run and 22 flash_attention launches per request, the first
     w8a8_dyn_matmul launch of each held against the twin on the graph's
     operands, bit for bit; int8 against bf16 last logits (nrms < 0.15 on TinyLlama cut
     to the 2 layers the bound was set on; printed at full depth, beside both
     against the float32 model); on-device decode
     equals the host loop; host syncs do not grow with the tokens; prefill,
     decode, device busy time, peak memory, device weight bytes and the host
     quantization time are printed; one prefill's and one decode step's calls
     are recorded: every call on a K-major form (s8 wgmma / GEMV), bit for
     bit with the twin and with the (K, N) weight's variant; both replayed
     beside that variant, the prefill's beside torch._int_mm over the calls
     it takes, both beside cuBLAS bf16 on bf16 copies of the weights;
  9. Whisper (phase_whisper): WHISPER_TINY_TEST in fp32 on the card against
     the CPU (cross K / V within 1e-4 * max, equal tokens for noise, a 300 Hz
     tone and silence), then WHISPER_BASE at full width (random host weights
     from seed 0) through WhisperPipeline with device=None, in bf16 and in
     float32: three 30 s windows from a seed (noise, a chirp, 8 s of tone
     then silence), 32 greedy tokens each, each request launching kernel 1
     exactly 6 times at (1, 1500, 8 x 64) (the encoder's sites; the
     decoder's 4- and 1-query sites take the reference path), the first held
     against the twin on the graph's operands (bf16 also within
     FLASH_REL_L2, every bf16 launch on a wgmma variant); one bf16 request
     with the weights synthesized on the card; one encoder plan and two
     decoder sessions (L = 4, L = 1) of one plan each; float32 card vs CPU
     encoder outputs and first-step logits within 1e-3 * max; bf16 flash on
     vs off cross K / V within 5e-2 * max; host syncs a token not growing;
     tokens, encoder / prefill / decode-step wall and device busy, peak
     memory and device weight bytes, the bf16 vs fp32 logits nrms, and one
     encoder run's 6 calls at the site beside SDPA, the twin and the bound;
 10. op library (phase_ops): every case of tests/test_torch_ops_card.py (the
     ONNX op types of the Whisper / YOLO slice and Conv of rank 3) on the
     card against the CPU, float32 within 1e-5 and bf16 within 1e-2 of
     max|out|, integer and bool results equal;
 11. YOLO (phase_yolo): YoloPipeline.detect at 640 x 640 RGBA on the card
     (device=None) around tests/yolo_standin.py's stand-in head, which has
     YOLOv8n's I/O contract and is not YOLOv8n, against the CPU: boxes
     within rtol = atol = 1e-3, NMS indices equal; detect and session wall
     and busy.
 12. weight streaming (phase_streamed): the reference's SD1.5 folder written
     to a temporary directory by the port's GraphBuilder.save (CLIP-L fp32,
     the SD15 UNet as unet_fp16/ with float16 .bin files, VAE_SD fp16,
     random weights from seeds); the bf16 UNet read from unet_fp16/ by a
     Session under ram+prefetch and the native prefetch at hbm_budget_bytes
     0, 512 MiB and 128 MiB, three requests each: segments, streamed bytes,
     wall, the allocator's peak within Executor.hbm_accounting()'s bound +
     PEAK_SLACK, no host conversion on a warm ram+prefetch run, 10 flash
     launches a run (the first streamed one held to the twin), every output
     bit for bit with the first resident run; one warm streamed run per
     budget profiled: kernels and host-to-device copies by stream, the
     copies' share under kernels, device busy and idle share; then a 4-step
     512 x 512 euler_a image through StableDiffusionPipeline.from_dir at
     hbm_budget_bytes 256 MiB, bit for bit with the resident image;
 13. the model server (phase_serve): cli/serve_main.py in a thread on the
     card, unet_fp16/ loaded over HTTP (wp=prefetch, read_file), three /run
     requests read back as little-endian f32, bit for bit with the
     in-process resident session, 10 flash launches each, each request's
     latency; then tests/data/capi_smoke.c built with gcc against
     libonnxstream_tpu_torch.so (runtime/native.py) and run on the card.
 14. channel-last (phase_layout, after phase_gn_routes on its model): the
     TINY UNet with use_nhwc_layout in fp32 on the card against the CPU; the
     SD15 UNet (seed 0, bf16) NCHW and channel-last in turns, three requests
     each, 10 kernel-1 launches a run (every launch on a wgmma variant, the
     first channel-last one held to the twin), channel-last within 5e-2 *
     max|out| of NCHW, a float32 pair within 1e-3; the VAE_SD decode at
     512 x 512 both ways (float output within 5e-2 * max, the image within
     one level on average, one kernel-1 launch each); config A with the
     pass (its fused ops behind the pass's NCHW fallback): 16 gn_silu and 45
     gn_silu_conv launches, the first of each held to its twin, the output
     within 5e-2 * max of config A's NCHW run; per run the graph's
     ostpu.groupnorm / ostpu.reshape / Transpose counts, device busy and
     wall, and the launches and ms of cuDNN's layout-conversion kernels
     (names holding nchwToNhwc / nhwcToNchw), NCHW and channel-last in turns;
     sd15_nhwc counts kernel 1 in the channel-last runs only (10 a UNet run,
     1 a decode);
 15. flash_packed_nopad (phase_nopad): the SD15 UNet in bf16, three
     requests, kernel 2 at the 10 packed sites a run (head-major views of the
     packed operands) and kernel 1 at none, kernel 2's first launch at
     d = 40 and d = 80 held to its twin (relative L2 <= 1e-2), the output
     within 5e-2 * max|out| of the default run; kernel 2 at d = 160 (the 16 x
     16 level's shape, which the size predicate keeps off the path) against
     its twin; per shape kernel 2, the whole route (its output copy
     included), kernel 1, SDPA, the twin and the bound; a run's busy and wall
     beside the default's, in turns; kernel 1's sd15_nopad is the sum of its
     launches in those runs (0);
 16. force_fp16_storage (phase_fp16_storage): the SD15 UNet in float32
     compute with float16-resident weights, three requests, 10 kernel-1
     launches a run (fma, the first held to the twin), within 1e-4 * max|out|
     of float32 storage of the float16-rounded weights; resident weight bytes
     (hbm_accounting and the allocator) 0.45-0.55 of that run's; peaks within
     the bound + PEAK_SLACK; the same streamed at 512 MiB (segments, bytes,
     peak, 10 kernel-1 launches, request 0's output within 1e-4 * max|out|
     of both resident runs' request 0); busy and wall of both in turns;
     sd15_fp16_storage counts kernel 1 in the float16-storage runs only;
 17. the converter (phase_convert, before phase_streamed): tools/
     torch_sd_unet.py SDUNet(width=1.0) (seed 0, 860 M params) exported in
     float16 on the card (opset 17, 1.72 GB), converted by the port's
     onnx2txt, run through Session(SessionConfig(compute_dtype="float32"))
     on the card, twice with equal bits, and held to the same module with its
     float16-rounded weights in float32 within rel 5e-3; export, conversion
     and run times, op counts and the ostpu.sdpa sites after fusion.

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
import shutil
import subprocess
import sys
import tempfile
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
EX2_PER_CLOCK_PER_SM = 16  # exp2 on Hopper's special-function units: 4 a clock per SM sub-partition
# 16-bit flash outputs: ||out - twin||2 / ||twin||2 at most this. With randn
# operands an output's rms is about sqrt(e / keys) (0.026 at 4096 keys), so
# rtol = atol = 2e-2 alone passes a key tile dropped or counted twice.
FLASH_REL_L2 = 1e-2


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
    # again, twice as long; after five empty ones the call is timed with CUDA
    # events (which count the host's gaps between launches too) and the
    # output says so
    n = iters
    for _ in range(5):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
            for _ in range(n + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        ms = sum(r[0] for r in _device_rows(prof, n))
        if ms > 0:
            return ms
        print("device_ms: the profiler window holds no device events; profiling again")
        n *= 2
    return _event_ms(fn, iters, "device_ms")


def _event_ms(fn, iters: int, who: str) -> float:
    """ms of one call of fn between CUDA events, each call ended by a
    synchronize: the fallback where profiler windows keep coming back empty."""
    total = 0.0
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    print(f"{who}: five profiler windows held no device events; this call is timed with CUDA events "
          f"({total / iters:.4f} ms, host gaps included)")
    return total / iters


def device_ms_per_call(fn, iters: int = 10, windows: int = 3) -> float:
    """Device time of one call of fn where a call is one or two small
    kernels: each kernel's mean duration times its launches per call (its
    count over `iters`, rounded up), so that a launch the tracer misses at the
    start of its window does not lower the time, as it would in device_ms;
    the median of `windows` profiler windows, since a window now and then
    comes back without one of the call's kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows + 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
        ms = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            if str(getattr(e, "device_type", "")).endswith("CUDA") and us > 0:
                ms += us / 1e3 / e.count * -(-e.count // iters)
        if ms > 0:
            times.append(ms)
        if len(times) == windows:
            return float(np.median(times))
    return _event_ms(fn, iters, "device_ms_per_call")


_EX2_RATE = []


def ex2_rate() -> float:
    """exp2 a second of the card's special-function units: 16 a clock per
    SM (Hopper's MUFU.EX2 rate), times the SMs and the maximum SM clock that
    the card reports (nvidia-smi clocks.max.sm)."""
    if not _EX2_RATE:
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True, check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _EX2_RATE.append(EX2_PER_CLOCK_PER_SM * sms * mhz * 1e6)
        print(f"exp2 rate for the bounds: {EX2_PER_CLOCK_PER_SM} a clock per SM x {sms} SMs x {mhz:g} MHz "
              f"= {_EX2_RATE[0] / 1e12:.3f} T/s")
    return _EX2_RATE[0]


def bound(nbytes: float, ops: float, peak: str, exps: float = 0) -> dict:
    """The least time the card could take for the work: the bytes it must
    move over the memory rate, its operations over the peak rate of their
    type, or (attention) its `exps` exponentials over the MUFU's exp2 rate,
    whichever is largest. `bound_by` says bytes or operations, `bound_op`
    which rate: "HBM", the peak's type, or "MUFU exp2". The last is a floor
    for exp2 on the special-function units only: exp2 computed on the FMA
    pipes (range reduction and a polynomial) is not counted, so it is not a
    hard floor for a kernel that does that."""
    t = {"HBM": nbytes / HBM_BYTES_PER_S * 1e3, peak: ops / PEAK_OPS_PER_S[peak] * 1e3,
         "MUFU exp2": exps / ex2_rate() * 1e3 if exps else 0.0}
    op = max(t, key=t.get)
    return {"bound_ms": t[op], "bound_by": "bytes" if op == "HBM" else "operations", "bound_op": op}


def _rel_l2(out, ref) -> float:
    """||out - ref||2 / ||ref||2 in float32."""
    r = ref.float()
    return ((out.float() - r).norm() / r.norm().clamp_min(1e-30)).item()


def _flash_agrees(out, ref, tol: float):
    """(ok, max|diff|, relative L2) of a flash output against its twin:
    elementwise within rtol = atol = tol, and for 16-bit outputs also the
    relative L2 distance within FLASH_REL_L2."""
    err, rel = (out.float() - ref.float()).abs().max().item(), _rel_l2(out, ref)
    ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
    return ok and (out.dtype == torch.float32 or rel <= FLASH_REL_L2), err, rel


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


# wgmma kernels whose pipeline ptxas must not serialize (notes C7514 / C7515 naming them fail the build phase)
SERIAL_FREE = ("gn_conv_wgmma_kernel", "dyn_wgmma_kernel")


def phase_build():
    from onnxstream_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = dict(zip(KERNEL_SOURCES, pool.map(build.build, KERNEL_SOURCES)))
    print(f"build: {len(paths)} sources in parallel in {time.perf_counter() - t0:.1f} s")
    serialized = []
    for src, path in paths.items():
        print(f"  {src}.cu ({KERNEL_SOURCES[src]}) -> {path}")
        lines = (path.parent / "build.log").read_text().splitlines()
        print("\n".join(l for l in lines if "registers" in l or "spill" in l or "C751" in l))
        serialized += [l for l in lines if ("C7514" in l or "C7515" in l) and any(k in l for k in SERIAL_FREE)]
    print(f"ptxas C7514 / C7515 notes naming {', '.join(SERIAL_FREE)}: {len(serialized)}")
    if serialized:
        raise SystemExit("build: ptxas serialized the wgmma pipeline of " + "; ".join(serialized))


def _sdpa_packed(q, k, v, heads):
    """scaled_dot_product_attention on the packed (B, L, H*D) layout, as views."""
    b, d = q.shape[0], q.shape[-1] // heads
    split = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
    return F.scaled_dot_product_attention(split(q), split(k), split(v))


def _packed_variant(q, k, v, heads, **kw) -> str:
    """flash_variant's answer for a flash_attention_packed call: the packed
    (B, L, H*D) operands as the head-major views the kernel reads."""
    from onnxstream_tpu_torch.kernels.flash_attention import flash_variant

    if q.ndim == 2:
        q, k, v = q[None], k[None], v[None]
    d = q.shape[-1] // heads
    split = lambda t: t.unflatten(-1, (t.shape[-1] // d, d)).transpose(1, 2)
    return flash_variant(split(q), split(k), split(v), form="packed")


def _packed_earlier(q, k, v, heads, scale=None, causal=False):
    """The same flash_attention_packed call (head dims up to 128) on
    fa_mma_kernel, the variant it took before the wgmma one: (the launch,
    its output, allocated here outside the timed call)."""
    from onnxstream_tpu_torch.kernels import flash_attention as fa

    d, _, dv = fa._check_packed(q, k, v, heads)
    dims, strides = fa._packed_launch(q, k, v, heads, d, dv)
    out = torch.empty((q.shape[0], q.shape[1], heads * dv), dtype=q.dtype, device=q.device)
    sc = 1.0 / float(np.sqrt(d)) if scale is None else scale
    return lambda: fa._launch(q, k, v, out, None, dims, strides, sc, causal, wgmma=False), out


def phase_kernel(name: str) -> dict:
    from onnxstream_tpu_torch.kernels.flash_attention import (
        flash_attention_packed, flash_attention_packed_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (label, b, m, n, heads, kv_heads, d, causal); the sd15 and vae sites
    # must take a wgmma variant in bf16
    cases = [
        ("sd15_d40", 1, 4096, 4096, 8, 8, 40, False),
        ("sd15_d80", 1, 1024, 1024, 8, 8, 80, False),
        ("d40_ragged_gqa", 2, 77, 300, 8, 4, 40, False),
        ("d80_causal_m_gt_n", 1, 200, 150, 2, 2, 80, True),
        ("gqa_causal", 2, 300, 700, 8, 2, 64, True),
        ("causal_m_gt_n", 1, 80, 24, 4, 4, 32, True),
        ("d160_fma_path", 1, 256, 512, 8, 8, 160, False),  # head dims 129..256: CUDA-core variant
        ("vae_d512", 1, 4096, 4096, 1, 1, 512, False),  # the VAE mid-block: wide wgmma, keys split
        ("d512_ragged", 2, 77, 300, 1, 1, 512, False),
        ("d512_causal_m_gt_n", 1, 100, 40, 2, 1, 512, True),
    ]
    worst_bf16, bad = 0.0, []
    for label, b, m, n, h, hkv, d, causal in cases:
        q32 = torch.randn(b, m, h * d, device="cuda", generator=gen)
        k32 = torch.randn(b, n, hkv * d, device="cuda", generator=gen)
        v32 = torch.randn(b, n, hkv * d, device="cuda", generator=gen)
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            variant = _packed_variant(q, k, v, h)
            out = flash_attention_packed(q, k, v, h, causal=causal)
            again = flash_attention_packed(q, k, v, h, causal=causal)
            torch.cuda.synchronize()
            ref = flash_attention_packed_reference(q, k, v, h, causal=causal)
            ok, err, rel = _flash_agrees(out, ref, tol)
            elementwise = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            same = torch.equal(out, again)
            print(f"kernel vs twin {label} {str(dt)[6:]} ({variant}): max|diff| {err:.3e} (rtol=atol={tol}: "
                  f"{'ok' if elementwise else 'FAIL'}), relative L2 {rel:.3e}"
                  + ("" if dt == torch.float32 else f" (limit {FLASH_REL_L2:g})")
                  + f", max|twin| {ref.float().abs().max().item():.4f}, second call bit-equal: {same} "
                  f"{'ok' if ok and same else 'FAIL'}")
            if not ok or not same:
                bad.append(f"{label} {str(dt)[6:]}")
            if label.startswith(("sd15", "vae")) and dt == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
                if not variant.startswith("wgmma"):
                    raise SystemExit(f"{label}: the packed entry took the {variant} variant, not a wgmma one")
            if m > n and causal:
                zero_rows = out[:, : m - n]
                if zero_rows.abs().max().item() != 0.0:
                    raise SystemExit(f"{label}: rows with no valid key are not exactly 0")
    if bad:  # every case printed first
        raise SystemExit(f"flash kernel disagrees with its twin, or with itself, on {', '.join(bad)}")

    def timed(q, k, v, h, label):
        """(kernel, earlier variant, twin, SDPA) device ms of one call; the
        earlier variant's output is held against the twin first."""
        earlier, out = _packed_earlier(q, k, v, h)
        earlier()
        ok, err, rel = _flash_agrees(out, flash_attention_packed_reference(q, k, v, h), 2e-2)
        print(f"fa_mma_kernel vs twin {label} bf16: max|diff| {err:.3e}, relative L2 {rel:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: fa_mma_kernel disagrees with the twin")
        return (device_ms(lambda: flash_attention_packed(q, k, v, h)), device_ms(earlier),
                device_ms(lambda: flash_attention_packed_reference(q, k, v, h)),
                device_ms(lambda: _sdpa_packed(q, k, v, h)))

    times, nbytes, ops, exps, by_shape = {}, 0, 0, 0, {}
    for m, d in SD15_SITES:
        q, k, v = (torch.randn(1, m, 8 * d, device="cuda", generator=gen, dtype=torch.bfloat16) for _ in range(3))
        times[f"{m}x{d}"] = t = timed(q, k, v, 8, f"sd15 {m}x{d}")
        # per UNet run: 5 sites of each shape; q, k, v read and o written
        # once, QK^T and PV at 2 operations per multiply-add, one exp2 a score
        site = bound(4 * _nbytes(q), 4 * m * m * 8 * d, "bf16", exps=8 * m * m)
        nbytes, ops, exps = nbytes + 5 * 4 * _nbytes(q), ops + 5 * 4 * m * m * 8 * d, exps + 5 * 8 * m * m
        by_shape[f"{m}x{d}"] = {"ms": t[0], "earlier_variant_ms": t[1], "plain_ms": t[2], "library_ms": t[3],
                                "variant": _packed_variant(q, k, v, 8), **site}
        print(f"time bf16 (1, {m}, {8 * d}) h8 d{d}: kernel {t[0]:.4f} ms ({_packed_variant(q, k, v, 8)}; the "
              f"earlier variant {t[1]:.4f} ms), twin {t[2]:.4f} ms, scaled_dot_product_attention {t[3]:.4f} ms, "
              f"bound {site['bound_ms']:.4f} ms ({site['bound_op']})  [{name}]")
    per_run = [sum(5 * t[i] for t in times.values()) for i in range(4)]
    run_bound = bound(nbytes, ops, "bf16", exps=exps)
    print(f"one UNet run's 10 sites: kernel {per_run[0]:.4f} ms, earlier variant {per_run[1]:.4f} ms, "
          f"scaled_dot_product_attention {per_run[3]:.4f} ms, bound {run_bound['bound_ms']:.4f} ms "
          f"({run_bound['bound_op']})  [{name}]")
    # the VAE mid-block site: one launch per full decode, d = 512
    m, d = VAE_SITE
    q, k, v = (torch.randn(1, m, d, device="cuda", generator=gen, dtype=torch.bfloat16) for _ in range(3))
    vae = (device_ms(lambda: flash_attention_packed(q, k, v, 1)),
           device_ms(lambda: flash_attention_packed_reference(q, k, v, 1)), device_ms(lambda: _sdpa_packed(q, k, v, 1)))
    site = bound(4 * _nbytes(q), 4 * m * m * d, "bf16", exps=m * m)
    print(f"time bf16 (1, {m}, {d}) h1 d{d} (VAE mid-block): kernel {vae[0]:.4f} ms ({_packed_variant(q, k, v, 1)}), "
          f"twin {vae[1]:.4f} ms, scaled_dot_product_attention {vae[2]:.4f} ms, "
          f"bound {site['bound_ms']:.4f} ms ({site['bound_op']})  [{name}]")
    by_shape[f"{m}x{d}_h1"] = {"ms": vae[0], "plain_ms": vae[1], "library_ms": vae[2],
                               "variant": _packed_variant(q, k, v, 1), **site}
    return {"max_abs_err": worst_bf16, "ms": per_run[0], "earlier_variant_ms": per_run[1], "plain_ms": per_run[2],
            **run_bound, "library_ms": per_run[3], "ms_by_shape": by_shape}


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


def profile_steps(step, name: str, label: str, steps: int = 2) -> list:
    """Device time per step by kernel, and the device's busy share of the
    wall time, from a torch.profiler window over warm steps. Returns the
    (ms per step, launches per step, kernel name) rows."""
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
        return rows
    print(f"profile of {label} over {steps} warm steps [{name}]: wall {wall_ms:.2f} ms/step (profiler on), "
          f"device busy {dev_ms:.2f} ms/step = {100 * dev_ms / wall_ms:.1f}% of wall")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:8.3f} ms/step  {n:5d}x  {key[:90]}")
    return rows


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
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
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
    flash = _FlashSites(flash_attention_packed, flash_attention_packed_reference, 2e-2)
    flash_attention_packed.launches = 0
    attention_op.flash_attention_packed = flash
    results = []
    try:
        for i, req in enumerate(reqs):
            for k, v in req.items():
                s.add_tensor(k, v)
            flash.arm()
            t1 = time.perf_counter()
            out = s.run()["out_sample"]
            ms = (time.perf_counter() - t1) * 1e3
            results.append(out)
            want = 10 * (i + 1)
            print(f"request {i} (t={req['timestep'][0]:g}): {out.shape} finite={np.isfinite(out).all()} "
                  f"max|out|={np.abs(out).max():.4f} {ms:.1f} ms (the twin's check included), flash launches "
                  f"so far {flash_attention_packed.launches}")
            if out.shape != (1, 4, 64, 64) or not np.isfinite(out).all():
                raise SystemExit(f"request {i}: bad output")
            if flash_attention_packed.launches != want:
                raise SystemExit(f"request {i}: {flash_attention_packed.launches} flash launches, want {want}")
            flash.check(f"request {i}")
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    launches = flash_attention_packed.launches
    flash.check_variants("SD15 UNet path")
    print(f"first request incl. plan + weight upload: {(time.perf_counter() - t0):.1f} s since session build")
    stats = s.hbm_stats()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        s.run()
        times.append((time.perf_counter() - t1) * 1e3)
    print(f"SD15 UNet step bf16, warm: median {np.median(times):.2f} ms over 5 runs "
          f"(min {min(times):.2f}) [{name}]")
    # the armed checks reset the allocator's peak after each twin: the peak
    # before them is flash.peak
    peak = max(flash.peak, stats["peak_bytes_in_use"])
    print(f"peak device memory {peak / 2**20:.1f} MB (plan, upload and requests), weights "
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


def _flash_variant_text(q, k, v, mask=None, scale=None, k_transposed=False, causal=False) -> str:
    from onnxstream_tpu_torch.kernels.flash_attention import flash_variant

    return f"variant {flash_variant(q, k, v, mask, k_transposed=k_transposed)}"


def _flash_earlier(q, k, v, mask=None, scale=None, k_transposed=False, causal=False):
    """The same head-major call on fa_mma_kernel, the mma.sync variant the
    head-major entry took before its wgmma variant (the wgmma variants kept
    out of the dispatch); the output is allocated here, outside the timed
    call."""
    from onnxstream_tpu_torch.kernels import flash_attention as fa

    dims, strides, m4 = fa._head_major_launch(q, k, v, mask, k_transposed)
    b, m, n, h, hkv, d, dv = dims
    out = torch.empty((b, h, m, dv), dtype=q.dtype, device=q.device)
    sc = 1.0 / float(np.sqrt(d)) if scale is None else scale
    return lambda: fa._launch(q, k, v, out, m4, dims, strides, sc, causal, wgmma=False)


def _flash_cost(q, k, v, mask=None, scale=None, k_transposed=False, causal=False):
    """(bytes, operations, exponentials) of one head-major call: q, k, v and
    the mask as given read once, the output written once; QK^T and PV at 2
    operations a multiply-add; one exp2 a score."""
    b, h, m, d = q.shape
    n, dv = (k.shape[-1] if k_transposed else k.shape[-2]), v.shape[-1]
    return (_nbytes(q, k, v, mask) + b * h * m * dv * q.element_size(), 2 * b * h * m * n * (d + dv),
            b * h * m * n)


def _sdpa_library(q, k, v, mask=None, scale=None, k_transposed=False, causal=False):
    """scaled_dot_product_attention on the same operands (the yardstick):
    the mask cast to q's dtype and K transposed back outside the timed call,
    GQA through enable_gqa."""
    kk = k.transpose(-1, -2) if k_transposed else k
    am = None if mask is None else mask.to(q.dtype)
    gqa = q.shape[1] != kk.shape[1]
    return lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=am, scale=scale,
                                                  is_causal=causal and am is None, enable_gqa=gqa)


def _flash_close(got, ref) -> bool:
    return torch.allclose(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


def phase_kernel_head_major(name: str) -> dict:
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention, flash_attention_reference,
                                                              flash_variant)

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
        # the wgmma variant with Hkv < H: TinyLlama's 32 query / 4 KV heads with
        # its (1, 1, L, L) mask staged, a batched mask, a causal one, d = 128
        ("gqa_32_4_prefill", 1, 32, 4, L, L, D, "causal", False, False, None),
        ("gqa_8_2_bmn_520", 2, 8, 2, 300, 520, 64, "bmn", False, False, None),
        ("gqa_8_2_causal_f32_mask", 2, 8, 2, 300, 520, 64, "11mn", True, False, torch.float32),
        ("gqa_8_2_d128", 1, 8, 2, 256, 512, 128, "b1mn", False, False, None),
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
            print(f"head-major kernel vs twin {label} {str(dt)[6:]} ({flash_variant(q, k, v, mask, kt)}): "
                  f"max|diff| {err:.3e} (rtol=atol={tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"head-major flash kernel disagrees with its twin on {label} {dt}")
            if label == "tinyllama_prefill" and dt == torch.bfloat16:
                site_err = err
            if causal and m > n and out[:, :, : m - n].abs().max().item() != 0.0:
                raise SystemExit(f"{label}: rows with no valid key are not exactly 0")
    q, k, v, mask = (None if t is None else t.to(torch.bfloat16)
                     for t in _hm_inputs(gen, 1, 32, 32, L, L, D, "causal", False, None))
    t_k = device_ms(lambda: flash_attention(q, k, v, mask=mask))
    t_e = device_ms(_flash_earlier(q, k, v, mask=mask))
    t_p = device_ms(lambda: flash_attention_reference(q, k, v, mask=mask))
    t_l = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    b = bound(_nbytes(q, k, v, q, mask), 4 * 32 * L * L * D, "bf16", exps=32 * L * L)
    print(f"time bf16 (1, 32, {L}, {D}) with a (1, 1, {L}, {L}) bf16 mask: kernel {t_k:.4f} ms "
          f"({flash_variant(q, k, v, mask)}; the mma variant {t_e:.4f} ms), twin {t_p:.4f} ms, "
          f"scaled_dot_product_attention {t_l:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_op']})  [{name}]")
    return {"max_abs_err": site_err, "ms": t_k, "earlier_variant_ms": t_e, "plain_ms": t_p, **b, "library_ms": t_l}


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


def check_dyn_kmajor(shapes) -> None:
    """w8a8_dyn_matmul on the K-major (N, K) weight (the GEMV up to M = 16,
    the s8 wgmma pipeline above, split along K where its plan says) against
    the twin and against the (K, N) weight's variants, bit for bit, f32 and
    bf16 activations, per-tensor and per-channel scales; a second call the
    same bits."""
    from onnxstream_tpu_torch.kernels.qmatmul import dyn_plan, dyn_variant, w8a8_dyn_matmul, w8a8_dyn_matmul_reference

    gen = torch.Generator(device="cuda").manual_seed(4)
    for m, k, n in shapes:
        for dt in (torch.float32, torch.bfloat16):
            for per_channel in (False, True):
                a, w, ws = _dyn_case(gen, m, k, n, dt, per_channel)
                w_nk = w.t().contiguous()
                got = w8a8_dyn_matmul(a, w_nk, ws, weight_nk=True)
                again = w8a8_dyn_matmul(a, w_nk, ws, weight_nk=True)
                kn = w8a8_dyn_matmul(a, w, ws)
                torch.cuda.synchronize()
                ref = w8a8_dyn_matmul_reference(a, w_nk, ws, weight_nk=True)
                ok = torch.equal(got, ref) and torch.equal(got, again) and torch.equal(got, kn)
                variant = dyn_variant(m, k, n, True, w_nk.data_ptr())
                plan = f", {dyn_plan(m, k, n)[2]} K splits" if variant == "wgmma" else ""
                print(f"w8a8_dyn_matmul (N, K) weight vs twin ({m}, {k}) x ({n}, {k}) {str(dt)[6:]} "
                      f"{'per-channel' if per_channel else 'per-tensor'} [{variant}{plan}]: max|diff| "
                      f"{(got.float() - ref.float()).abs().max().item():.3e}, bit for bit with the twin, a second "
                      f"call and the (K, N) weight: {'ok' if ok else 'FAIL'}")
                if not ok or variant not in ("gemv_nk", "wgmma"):
                    raise SystemExit(f"w8a8_dyn_matmul (N, K) disagrees with its twin at ({m}, {k}, {n}) {dt}")


def phase_kernel_q(name: str) -> dict:
    from onnxstream_tpu_torch.kernels.qmatmul import (
        dyn_variant, w8_matmul, w8_matmul_reference, w8a8_dyn_matmul, w8a8_dyn_matmul_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    dyn_shapes = [(m, k, n) for m in (1, 128, 512, 1024) for k, n in LLAMA_KN]
    # ragged edges: M = 77, K off the 64-deep tile, odd N, M on both sides of the GEMV limit
    dyn_shapes += [(77, 2048, 32003), (5, 100, 300), (16, 2048, 256), (17, 100, 300), (33, 130, 33)]
    check_qkernel("w8a8_dyn_matmul", w8a8_dyn_matmul, w8a8_dyn_matmul_reference, _dyn_case,
                  dyn_shapes, 1e-5, 1e-2)
    # the K-major weight of the int8 route: every TinyLlama shape at M 1 / 16 / 17 / 128 / 512 / 1024,
    # and ragged ones (K a multiple of 16 off the 128-byte k-tile, odd N, M off the tile)
    check_dyn_kmajor([(m, k, n) for m in (1, 16, 17, 128, 512, 1024) for k, n in LLAMA_KN]
                     + [(77, 2048, 32003), (5, 176, 33), (16, 2064, 256), (17, 176, 300), (33, 2064, 33)])
    # the SD15 graph's own shapes are checked in its phase; here the ragged ones
    w8_shapes = [(100, 130, 33), (77, 768, 320), (1, 320, 1280), (64, 2048, 32003), (17, 100, 300)]
    check_qkernel("w8_matmul", w8_matmul, w8_matmul_reference, _w8_case, w8_shapes, 1e-4, 2e-2)

    # times at the TinyLlama shapes, bf16 activations, per-channel scales as the route has them, the K-major
    # weight beside the (K, N) one on the variant it replaced, in turns, each call with its quantization;
    # the weight stays in L2 between launches here (the path's replays below read it cold)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for m in (1, 1024):
        for k, n in LLAMA_KN:
            a, w, ws = _dyn_case(gen, m, k, n, torch.bfloat16, True)
            w_nk = w.t().contiguous()
            # two copies of A in turn: the wgmma form quantizes an A once for consecutive calls on it
            acts, turn = (a, a.clone()), [0]

            def new():
                turn[0] ^= 1
                return w8a8_dyn_matmul(acts[turn[0]], w_nk, ws, weight_nk=True)

            old = lambda: w8a8_dyn_matmul(a, w, ws)
            t_k1, t_e1, t_e2, t_k2 = (device_ms(f) for f in (new, old, old, new))
            t_k, t_e = min(t_k1, t_k2), min(t_e1, t_e2)
            t_p = device_ms(lambda: w8a8_dyn_matmul_reference(a, w, ws), iters=3)
            lib = _int_mm_or_none(_quantize_rows(a), w)
            t_l = device_ms(lib) if lib else None
            wb = w.to(torch.bfloat16)
            t_b = device_ms(lambda: a @ wb)
            b = bound(_nbytes(a, w, ws) + m * n * 2, 2 * m * k * n, "int8")
            variant = dyn_variant(m, k, n, True, w_nk.data_ptr())
            print(f"time w8a8_dyn_matmul bf16 ({m}, {k}) x ({k}, {n}): kernel {t_k:.4f} ms ({variant}, the (K, N) "
                  f"weight's variant {t_e:.4f} ms), twin {t_p:.4f} ms, torch._int_mm "
                  + (f"{t_l:.4f} ms" if t_l is not None else "none at this shape")
                  + f", bf16 matmul on a bf16 weight {t_b:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_op']})  [{name}]")
            out[f"{m}x{k}x{n}"] = {"variant": variant, "ms": t_k, "earlier_variant_ms": t_e, "plain_ms": t_p,
                                   "library_ms": t_l, "bf16_matmul_ms": t_b, **b}
    return out


class _GraphSiteCheck:
    """Stands in for a kernel wrapper that the port's code calls. After
    arm(), the next call's kernel output is held against the twin on the very
    operands the graph passed (with the strides the graph gave them). The
    kernel's launch count is the wrapper's own; the twin launches nothing.
    The twin's scratch is kept out of the device memory peak: ``peak`` is
    the peak before each check, and the allocator's peak is reset after it.
    While ``calls`` is a list, every call's operands are appended to it.
    ``rel``, where given, also bounds a 16-bit output's relative L2 distance
    from the twin."""

    def __init__(self, kernel, twin, tol: float, describe, rel=None):
        self.kernel, self.twin, self.tol, self.describe, self.rel = kernel, twin, tol, describe, rel
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
            about = f"max|twin| {ref.float().abs().max().item():.4f}; "
            if self.rel is not None:
                rel = _rel_l2(out, ref)
                ok = ok and (out.dtype == torch.float32 or rel <= self.rel)
                about = f"relative L2 {rel:.3e} (limit {self.rel:g}), " + about
            self.result = (ok, err, about + self.describe(*args, **kw))
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


def _qmm_cost(a, w, *scales, out_dtype=None, weight_nk=False):
    """(bytes, operations) of one quantized matmul: A, W and the scale
    vectors read once, the output written once; 2 M K N operations."""
    m = a.numel() // a.shape[-1]
    n, k = w.shape if weight_nk else w.shape[::-1]
    out_elt = torch.empty(0, dtype=out_dtype or a.dtype).element_size()
    return _nbytes(a, w, *scales) + m * n * out_elt, 2 * m * k * n


def replay_times(label: str, calls, kernel, twin, library, peak: str, name: str, cost=None, earlier=None) -> dict:
    """The recorded calls of one graph run replayed in order: the kernel,
    its twin and, where every call has one, the PyTorch yardstick (library
    maps a call to a no-argument function or None). The weights are the
    graph's resident ones, so they come from device memory as on the path.
    ``cost`` maps a call to its (bytes, operations); a quantized matmul's
    by default. ``earlier`` maps a call to a no-argument function that runs
    it on the variant the kernel took before its redesign, replayed and
    timed the same way."""
    nbytes = ops = exps = 0
    for args, kw in calls:
        b, o, *e = (cost or _qmm_cost)(*args, **kw)
        nbytes, ops, exps = nbytes + b, ops + o, exps + sum(e)
    run_all = lambda fn: [fn(*args, **kw) for args, kw in calls]
    t_k = device_ms(lambda: run_all(kernel), iters=5)
    t_e = None
    if earlier is not None:  # in turns: kernel, earlier, earlier, kernel; the better of each pair
        olds = [earlier(*args, **kw) for args, kw in calls]
        t_e = min(device_ms(lambda: [f() for f in olds], iters=5) for _ in range(2))
        del olds
        t_k = min(t_k, device_ms(lambda: run_all(kernel), iters=5))
    t_p = device_ms(lambda: run_all(twin), iters=2, warmup=1)
    libs = [library(*args, **kw) for args, kw in calls]
    t_l = None
    if all(libs):
        t_l = device_ms(lambda: [f() for f in libs], iters=5)
    b = bound(nbytes, ops, peak, exps)
    print(f"replay of {label}: {len(calls)} calls, kernel {t_k:.4f} ms"
          + (f" (earlier variant {t_e:.4f} ms)" if t_e is not None else "") + f", twin {t_p:.4f} ms, library "
          + (f"{t_l:.4f} ms" if t_l is not None else f"none ({sum(map(bool, libs))} of {len(calls)} calls have one)")
          + f", bound {b['bound_ms']:.4f} ms ({b['bound_op']}; {nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} G ops) [{name}]")
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, **b, **({"earlier_variant_ms": t_e} if t_e is not None else {})}


def site_report(label: str, calls, kernel, twin, library, cost, plan_of, tol: float, name: str,
                peak: str = "bf16", close=None, earlier=None, key=None) -> dict:
    """Every distinct shape among the recorded calls of one graph run, on the
    graph's own operands: the variant and plan the dispatcher takes
    (``plan_of`` maps a call to that text), the kernel against its twin
    (max|diff| <= tol * max(1, max|twin|), or ``close(got, twin)`` where
    given), the same bits on a second call (the K split adds its partials in
    a fixed order), and the device time of kernel, twin and library call
    beside the bound. ``earlier`` maps a call to a no-argument function that
    runs the same call on the variant the kernel took before its wgmma
    variant, timed beside it. ``key`` maps a call to its shape (default:
    the rows of A and the shape of B)."""
    by_shape = {}
    for args, kw in calls:
        a, b = args[0], args[1]
        shape = key(args, kw) if key else (a.numel() // a.shape[-1], *b.shape)
        by_shape.setdefault(shape, []).append((args, kw))
    out = {}
    for shape, group in sorted(by_shape.items()):
        args, kw = group[0]
        got, ref = kernel(*args, **kw), twin(*args, **kw)
        again = kernel(*args, **kw)
        torch.cuda.synchronize()
        err, top = (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
        agree = close(got, ref) if close else err <= tol * max(1.0, top)
        ok = bool(torch.isfinite(got.float()).all()) and agree
        same = torch.equal(got, again)
        t_k = device_ms_per_call(lambda: kernel(*args, **kw))
        t_p = device_ms(lambda: twin(*args, **kw), iters=2, warmup=1)
        t_l = device_ms_per_call(library(*args, **kw))
        t_e = device_ms_per_call(earlier(*args, **kw)) if earlier else None
        nb, no, *ne = cost(*args, **kw)
        b = bound(nb, no, peak, sum(ne))
        key = "x".join(map(str, shape))
        print(f"site {label} {key} ({len(group)} calls a run): {plan_of(*args, **kw)}; max|diff| {err:.3e} of "
              f"max|twin| {top:.3f} ({'rtol=atol' if close else 'tol'} {tol:g}) {'ok' if ok else 'FAIL'}, second call "
              f"bit-equal: {same}; kernel {t_k:.4f} ms"
              + (f" (earlier variant {t_e:.4f} ms)" if t_e is not None else "")
              + f", twin {t_p:.4f} ms, library {t_l:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_op']}) [{name}]")
        if not ok or not same:
            raise SystemExit(f"{label} at {key}: the kernel disagrees with its twin, or with itself on a second call")
        out[key] = {"calls": len(group), "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "variant": plan_of(*args, **kw),
                    **({"earlier_variant_ms": t_e} if t_e is not None else {}), **b}
    return out


# --------------------------------- the GroupNorm and small-conv routes: kernels 7, 8 and 9
# x of gn_silu: UNet sites (the second without SiLU), the VAE's 2 MB groups (128 x 512^2, 512 x 256^2) and its
# 4 MB groups (256 x 512^2): at K = 8 each CTA streams part of its piece
GN_SITES = [(1, 320, 64, 64), (1, 960, 64, 64), (1, 128, 512, 512), (1, 512, 256, 256), (1, 256, 512, 512)]
GN_KERNEL = "gn_silu_cluster_kernel"  # the one kernel a gn_silu call launches (csrc/gn_conv.cu)
GN_CONV_SITES = [(320, 64, 320), (2560, 16, 1280), (1280, 8, 1280)]          # (C, H = W, O) of gn_silu_conv
MATMUL_SITES = [(64, 11520, 1280), (256, 23040, 1280), (1024, 5760, 640)]    # (M, K, N) of matmul
CONFIG_A = dict(fuse_gn_conv=True, fuse_groupnorm=True)
# the kernels one gn_silu_conv call launches on its wgmma variant (csrc/gn_conv.cu)
GN_CONV_PASSES = ("gn_moments_kernel", "gn_finalize_kernel", "gn_apply_nhwc_kernel", "gn_conv_wgmma_kernel",
                  "gn_conv_splitk_reduce")
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


def _gn_plan_text(x, sg, sb, gamma, beta, groups, eps, silu) -> str:
    """Kernel 7's plan for this call: K, the resident bytes of a CTA, the
    clusters the card holds at once, and whether the pieces stream."""
    from onnxstream_tpu_torch.kernels.gn_silu import active_clusters, gn_silu_pieces, gn_silu_plan

    n, c = x.shape[0], x.shape[1]
    hw = x.numel() // (n * c)
    plan = gn_silu_plan(n, c, hw, groups, x.dtype)
    pieces = gn_silu_pieces(plan, c // groups * hw, 0, x.element_size())
    streams = any(res * 16 < (e - b) * x.element_size() - 32 for b, e, res in pieces)
    return (f"K {plan.cluster}, {plan.resident * 16} B resident a CTA ({plan.smem_bytes} B of shared memory), "
            f"{active_clusters(plan, x.dtype, silu)} clusters at once"
            + (", streams part of each piece" if streams else ""))


def _kernels_of(label: str, fn, calls: int, want: str, copies: int = 0) -> None:
    """The device kernels that fn launches, by name from torch.profiler over
    four calls of fn: `calls` launches a call of kernels whose names hold
    `want` (any instantiation), `copies` of PyTorch's copy kernel (a wrapper
    making a strided operand contiguous) and nothing else, or the run fails.
    As in device_ms, a warm-up step of the profiler's schedule is traced and
    dropped (the tracer can miss the first launches of a window); a window
    that still comes back short is taken again, up to five times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want_got = {"kernel": calls, "copy": copies, "other": 0}
    for _ in range(5):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=4, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
            for _ in range(5):
                fn()
                torch.cuda.synchronize()
                prof.step()
        names = {e.key: e.count for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) > 0}
        got = {"kernel": -(-sum(v for k, v in names.items() if want in k) // 4),
               "copy": -(-sum(v for k, v in names.items() if want not in k and "copy" in k) // 4),
               "other": -(-sum(v for k, v in names.items() if want not in k and "copy" not in k) // 4)}
        if got == want_got:
            break
        print(f"  launches a call of {label}: {got} in this profiler window; profiling again")
    ok = got == want_got
    print(f"  launches a call of {label}: {got['kernel']} x {want}, {got['copy']} contiguous copies, {got['other']} "
          f"other ({'ok' if ok else f'FAIL: want {calls}, {copies} and 0'})")
    if not ok:
        raise SystemExit(f"{label}: a call launched {names}")


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


def _site_times(label, name, kernel, twin, library, cost, peak="bf16", earlier=None):
    """Device ms of one call of kernel, twin and library (and of the same call
    on the kernel's earlier variant, in turns with the kernel) beside the bound."""
    t_k, t_p, t_l = device_ms_per_call(kernel), device_ms(twin, iters=3, warmup=1), device_ms_per_call(library)
    t_e = None
    if earlier is not None:
        t_e = min(device_ms_per_call(earlier) for _ in range(2))
        t_k = min(t_k, device_ms_per_call(kernel))
    b = bound(*cost, peak)
    print(f"time bf16 {label}: kernel {t_k:.4f} ms" + (f" (earlier variant {t_e:.4f} ms)" if t_e is not None else "")
          + f", twin {t_p:.4f} ms, library {t_l:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_op']})  [{name}]")
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, **b, **({"earlier_variant_ms": t_e} if t_e is not None else {})}


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of t as a view that starts one element past a 16-byte boundary:
    what the variant predicates send to the masked kernels."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _gn_conv_plan_text(x, sg, sb, gamma, beta, w9, *rest, **kw) -> str:
    """The convolution variant of csrc/gn_conv.cu the dispatcher takes for
    this call and, for the wgmma pipeline, its tile and K split."""
    from onnxstream_tpu_torch.kernels.gn_conv import gn_conv_plan, gn_conv_variant

    n, c, h, w = x.shape
    o = w9.shape[1]
    variant = gn_conv_variant(x.dtype, c, w9.data_ptr())
    if variant != "wgmma":
        return {"mma": "mma.sync 64 x 128 patches", "fma": "float32 FMA patches"}[variant]
    bm, splits = gn_conv_plan(n, c, h, w, o)
    return f"wgmma {bm} x 128 tiles, {-(-o // bm) * -(-(n * h * w) // 128)} tiles x {splits} K splits"


def phase_kernel_gn(name: str) -> dict:
    """Kernels 7, 8 and 9 against their twins at the JAX suite's ragged cases
    in three dtypes, then at the sites of the routes in bf16 with their
    times. Tolerances: gn_silu 2e-5 (f32) / 2e-2 (16-bit); gn_silu_conv 1e-4 /
    2e-2; matmul 1e-4 (f32), 1e-3 (bf16 operands, f32 output), 2e-2 (16-bit
    output); each times max(1, max|twin|)."""
    from onnxstream_tpu_torch.kernels.gn_conv import gn_silu_conv, gn_silu_conv_reference
    from onnxstream_tpu_torch.kernels.gn_silu import gn_silu, gn_silu_reference
    from onnxstream_tpu_torch.kernels.matmul import conv3x3_im2col, matmul, matmul_reference, oihw_to_w9co

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    tols = lambda f32: ((torch.float32, f32), (torch.bfloat16, 2e-2), (torch.float16, 2e-2))
    # (n, c, h, w, groups, silu): C/G = 2, 10, 5, 6 with H W = 35; batch 2; K = 2 with groups off 16-byte
    # boundaries, alone and in batch 2; the route's sites. Every call twice for equal bits, and one kernel a call
    gn_cases = [(1, 64, 8, 8, 32, True), (1, 320, 16, 16, 32, True), (2, 40, 4, 4, 8, False),
                (1, 24, 5, 7, 4, True), (1, 1892, 5, 7, 4, True), (2, 104, 37, 35, 8, False)]
    gn_cases += [(*site, 32, i != 1) for i, site in enumerate(GN_SITES)]
    for n, c, h, w, g, silu in gn_cases:
        for dt, tol in tols(2e-5):
            args = (*_gn_operands(gen, n, c, h, w, g, dt), g, 1e-5, silu)
            got = gn_silu(*args)
            _held(f"gn_silu {(n, c, h, w)} G{g} silu={silu} {str(dt)[6:]} [{_gn_plan_text(*args)}]", got,
                  gn_silu_reference(*args), tol)
            if not torch.equal(got, gn_silu(*args)):
                raise SystemExit(f"gn_silu {(n, c, h, w)} {dt}: two calls gave different bits")
            _kernels_of(f"gn_silu {(n, c, h, w)} {str(dt)[6:]}", lambda: gn_silu(*args), 1, GN_KERNEL)
    # (n, c, groups, h, w, o, bias): 5 x 7 borders, no bias and O != C, C/G = 5, ragged everything, O = 4
    # and for the wgmma variant: C % 64 != 0 (a k-tile past C), the VAE's conv_out (O = 3) and a 512 x 512 site
    conv_cases = [(2, 16, 4, 5, 7, 16, True), (1, 32, 8, 8, 8, 24, False), (1, 20, 4, 4, 4, 8, True),
                  (2, 64, 8, 33, 17, 70, True), (1, 320, 32, 64, 64, 4, True), (1, 72, 8, 9, 9, 40, True),
                  (1, 128, 32, 512, 512, 3, True), (1, 128, 32, 512, 512, 128, True)]
    conv_cases += [(1, c, 32, hw, hw, o, True) for c, hw, o in GN_CONV_SITES]
    for n, c, g, h, w, o, bias in conv_cases:
        for dt, tol in tols(1e-4):
            args = _gn_operands(gen, n, c, h, w, g, dt)
            w9, bv = _w9_operands(gen, c, o, dt, bias)
            got = gn_silu_conv(*args, w9, bv, groups=g, eps=1e-5)
            _held(f"gn_silu_conv {(n, c, h, w)} G{g} -> {o} bias={bias} {str(dt)[6:]} [{_gn_conv_plan_text(*args, w9)}]",
                  got, gn_silu_conv_reference(*args, w9, bv, g, 1e-5), tol)
            if not torch.equal(got, gn_silu_conv(*args, w9, bv, groups=g, eps=1e-5)):
                raise SystemExit(f"gn_silu_conv {(n, c, h, w)} -> {o} {dt}: two calls gave different bits")
            if dt == torch.bfloat16 and c % 8 == 0:  # the same call on the mma.sync variant, from the pointer
                w9m = _misaligned(w9)
                _held(f"gn_silu_conv {(n, c, h, w)} -> {o} bfloat16, w9 misaligned [{_gn_conv_plan_text(*args, w9m)}]",
                      gn_silu_conv(*args, w9m, bv, groups=g, eps=1e-5), gn_silu_conv_reference(*args, w9, bv, g, 1e-5),
                      tol)
    # the JAX suite's cases and a ragged one (the masked kernels), then the edges of the wgmma pipeline: a
    # ragged last K split (65 k-tiles in 13 splits of 5), M off the tile with N = 320, K % 64 != 0 with
    # N % 8 == 0 only, one short k-tile with one 8-column strip and 129 rows in 64-row tiles
    mm_cases = [(64, 1152, 128, False), (128, 2560, 256, True), (512, 1280, 640, True), (35, 100, 33, True),
                (64, 4160, 1280, True), (77, 768, 320, False), (200, 1000, 328, True), (129, 16, 8, True)]
    mm_cases += [(m, k, n, True) for m, k, n in MATMUL_SITES]
    for m, k, n, bias in mm_cases:
        for dt, odt, tol in ((torch.float32, torch.float32, 1e-4), (torch.bfloat16, torch.float32, 1e-3),
                             (torch.bfloat16, torch.bfloat16, 2e-2), (torch.float16, torch.float16, 2e-2)):
            a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
            b = (torch.randn(k, n, device="cuda", generator=gen) * 0.02).to(dt)
            bv = torch.randn(n, device="cuda", generator=gen) if bias else None
            got = matmul(a, b, bv, out_dtype=odt)
            _held(f"matmul ({m}, {k}) x ({k}, {n}) bias={bias} {str(dt)[6:]} -> {str(odt)[6:]} "
                  f"[{_matmul_plan_text(a, b)}]", got, matmul_reference(a, b, bv, out_dtype=odt), tol)
            if not torch.equal(got, matmul(a, b, bv, out_dtype=odt)):
                raise SystemExit(f"matmul ({m}, {k}, {n}) {dt}: two calls gave different bits")
    # a view that starts 2 bytes off a 16-byte boundary: the dispatcher takes the masked kernel from the pointer
    flat = torch.randn(64 * 256 + 8, device="cuda", generator=gen).to(torch.bfloat16)
    a, b = flat[1:1 + 64 * 256].view(64, 256), (torch.randn(256, 128, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    if "mma.sync" not in _matmul_plan_text(a, b) or "wgmma" not in _matmul_plan_text(flat[:64 * 256].view(64, 256), b):
        raise SystemExit("matmul: the variant predicate does not follow the pointer's alignment")
    _held(f"matmul (64, 256) x (256, 128) bfloat16, A misaligned [{_matmul_plan_text(a, b)}]", matmul(a, b),
          matmul_reference(a, b), 2e-2)
    for cin, cout, h, w, batch in [(128, 128, 8, 8, 2), (256, 128, 5, 7, 1)]:
        x = torch.randn(batch, h, w, cin, device="cuda", generator=gen)
        wt = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) * 0.05
        bv = torch.randn(cout, device="cuda", generator=gen)
        ref = F.conv2d(x.permute(0, 3, 1, 2), wt, bv, padding=1).permute(0, 2, 3, 1)
        _held(f"conv3x3_im2col NHWC {(batch, h, w, cin)} -> {cout} float32 against F.conv2d",
              conv3x3_im2col(x, oihw_to_w9co(wt), bv), ref, 1e-4)

    # times at the sites, bf16
    dt, out = torch.bfloat16, {"gn_silu": {}, "gn_silu_conv": {}, "matmul": {}}
    for i, (n, c, h, w) in enumerate(GN_SITES):
        args = (*_gn_operands(gen, n, c, h, w, 32, dt, plain_inorm=True), 32, 1e-5, i != 1)
        plan = _gn_plan_text(*args)
        out["gn_silu"][f"{c}x{h}x{w}"] = {**_site_times(
            f"gn_silu {(n, c, h, w)} silu={i != 1} [{plan}]", name, lambda: gn_silu(*args),
            lambda: gn_silu_reference(*args), _gn_library(*args), _gn_cost(*args)), "plan": plan}
    for c, hw, o in GN_CONV_SITES:
        args = _gn_operands(gen, 1, c, hw, hw, 32, dt, plain_inorm=True)
        w9, bv = _w9_operands(gen, c, o, dt)
        w9m = _misaligned(w9)
        kw = dict(groups=32, eps=1e-5)
        out["gn_silu_conv"][f"{c}x{hw}x{hw}->{o}"] = _site_times(
            f"gn_silu_conv (1, {c}, {hw}, {hw}) -> {o} [{_gn_conv_plan_text(*args, w9)}]", name,
            lambda: gn_silu_conv(*args, w9, bv, **kw), lambda: gn_silu_conv_reference(*args, w9, bv, 32, 1e-5),
            _gn_conv_library(*args, w9, bv, **kw), _gn_conv_cost(*args, w9, bv, **kw),
            earlier=lambda: gn_silu_conv(*args, w9m, bv, **kw))
    for m, k, n in MATMUL_SITES:
        a = torch.randn(m, k, device="cuda", generator=gen).to(dt)
        b = (torch.randn(k, n, device="cuda", generator=gen) * 0.02).to(dt)
        bv = torch.randn(n, device="cuda", generator=gen).to(dt)
        out["matmul"][f"{m}x{k}x{n}"] = _site_times(
            f"matmul ({m}, {k}) x ({k}, {n}) + bias", name, lambda: matmul(a, b, bv),
            lambda: matmul_reference(a, b, bv), _matmul_library_call(a, b, bv), _matmul_cost(a, b, bv))
    return out


def _matmul_plan_text(a, b, *rest, **kw) -> str:
    """The variant of csrc/matmul.cu the dispatcher takes for this call and,
    for the wgmma pipeline, its tile and K split."""
    from onnxstream_tpu_torch.kernels.matmul import matmul_plan, matmul_variant

    (m, k), n = a.shape, b.shape[1]
    variant = matmul_variant(a.dtype, m, k, n, a.data_ptr(), b.data_ptr())
    if variant != "wgmma":
        return {"mma": "mma.sync 64 x 128 tiles, masked", "fma": "float32 FMA tiles"}[variant]
    bm, bn, splits = matmul_plan(m, k, n)
    return f"wgmma {bm} x {bn} tiles, {-(-m // bm) * -(-n // bn)} tiles x {splits} K splits"


def _w8_plan_text(a, w, *rest, **kw) -> str:
    """The same for csrc/qmatmul.cu's w8_matmul."""
    from onnxstream_tpu_torch.kernels.qmatmul import w8_plan, w8_variant

    m, (k, n) = a.numel() // a.shape[-1], w.shape
    variant = w8_variant(a.dtype, m, k, n, a.data_ptr(), w.data_ptr())
    if variant != "wgmma":
        return {"mma": "mma.sync 64 x 128 tiles, masked", "fma": "float32 FMA tiles"}[variant]
    bm, bn, splits = w8_plan(m, k, n)
    return f"wgmma {bm} x {bn} tiles, {-(-m // bm) * -(-n // bn)} tiles x {splits} K splits"


def _smallconv_sites(graph, raw_text: str) -> int:
    """The ops of a fused graph that the small-conv rewrite produced
    (ostpu.conv3x3_im2col, weight under the t9co upload transform). The pass
    must have taken exactly the Convs of the raw graph that pass the route's
    gate (``smallconv_eligible``; their shapes are static in these graphs)."""
    from onnxstream_tpu_torch.ir import parse_model_txt
    from onnxstream_tpu_torch.kernels.matmul import smallconv_eligible

    n = sum(op.op_type == "ostpu.conv3x3_im2col" and op.inputs[1].transform == "t9co"
            and tuple(op.inputs[1].shape) == (9 * op.inputs[1].file_shape[1], op.inputs[1].file_shape[0])
            for op in graph.ops)
    eligible = sum(op.op_type == "Conv" and smallconv_eligible(
        op.inputs[0].shape, op.inputs[1].shape, op.attr_int("group", 1), op.attr_ints("strides", [1, 1]),
        op.attr_ints("dilations", [1, 1]), op.attr_ints("pads", [0, 0, 0, 0])) for op in parse_model_txt(raw_text).ops)
    if n != eligible:
        raise SystemExit(f"small-conv rewrite: {n} ops rewritten, {eligible} Convs of the raw graph pass the gate")
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
                           "matmul": _smallconv_sites(s.graph, text) if "use_pallas_smallconv" in cfg else 0}
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
        images, floats = {}, {}
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
            images[label], floats[label] = image_to_uint8(img_f[0]).astype(np.int32), img_f
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
                diff = (img_f.float() - floats["default"].float()).abs().max().item()
                top = floats["default"].float().abs().max().item()
                print(f"VAE_SD decode, {label} against the default, the float output: max|diff| {diff:.4e}, "
                      f"max|out| {top:.4f}, ratio {diff / top:.4e}" + (" (bound 5e-2)" if label == "A" else ""))
                if label == "A" and not diff <= 5e-2 * top:
                    raise SystemExit("VAE decode, config A: far from the default decode's output")
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
        for label in ("A", "B", "vae_fuse_groupnorm", "vae_A"):
            for site in sites.values():
                site.calls = []
            sessions[label].run(device_outputs=True)
            recorded[label] = {k: site.calls for k, site in sites.items()}
            for site in sites.values():
                site.calls = None
        # no per-run weight relayout on the small-conv route: the B operand of every matmul call of a run
        # is the resident device copy of an uploaded (9 C, O) weight itself, not a tensor made during the run
        ex = next(iter(sessions["B"]._executors.values()))
        resident = {t[0].data_ptr() for t in ex._resident.values()}
        moved = [tuple(b.shape) for (a, b, *_), _ in recorded["B"]["matmul"]
                 if b.data_ptr() not in resident or not b.is_contiguous() or b.shape[0] != a.shape[1]]
        print(f"config B: {len(recorded['B']['matmul'])} matmul calls a run, B operands that are not a resident "
              f"uploaded weight: {len(moved)} {moved[:3]}")
        if moved:
            raise SystemExit("config B: a conv weight was relayouted during the run")
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
    # kernel 8's passes (moments, the channels-last slab, the product, the split's sum) in a config-A UNet
    # run and decode: the slab pass is the write and read of the activated tensor that the TPU kernel keeps
    # on chip
    passes = {}
    for label, step in (("A", sessions["A"].run), ("vae_A", lambda: sessions["vae_A"].run(device_outputs=True))):
        rows = profile_steps(step, name, f"{'VAE_SD decode' if label == 'vae_A' else 'SD15 step'}, config A")
        passes[label] = {k: sum(ms for ms, _, key in rows if k in key) for k in GN_CONV_PASSES}
        print(f"kernel 8's passes per {'decode' if label == 'vae_A' else 'UNet run'}, config A: "
              + ", ".join(f"{k} {ms:.4f} ms" for k, ms in passes[label].items())
              + f" [{name}]")
    around = {}
    for label in ("fuse_groupnorm", "B"):
        rows = profile_steps(sessions[label].run, name, f"SD15 step, config {label}")
        around[label] = sum(ms for ms, _, key in rows if "elementwise" in key or "Copy" in key or "copy" in key)
    # config B's graph is fuse_groupnorm's but for the 34 rerouted convs: the difference in elementwise and
    # copy kernels is what the route's torch ops (the im2col concats; no weight relayout) cost a run
    print(f"elementwise and copy kernels per UNet run: config B {around['B']:.3f} ms, fuse_groupnorm "
          f"{around['fuse_groupnorm']:.3f} ms, the small-conv route's own {around['B'] - around['fuse_groupnorm']:.3f} ms [{name}]")

    specs = {"gn_silu": (gn_silu, gn_silu_reference, _gn_library, _gn_cost),
             "gn_silu_conv": (gn_silu_conv, gn_silu_conv_reference, _gn_conv_library, _gn_conv_cost),
             "matmul": (matmul, matmul_reference, _matmul_library_call, _matmul_cost)}
    # kernel 8's earlier variant (the mma.sync kernel): the same calls with misaligned copies of the weights
    w9_copies = {}

    def gn_conv_earlier(x, sg, sb, gamma, beta, w9, bias=None, **kw):
        if w9.data_ptr() not in w9_copies:
            w9_copies[w9.data_ptr()] = _misaligned(w9)
        w9m = w9_copies[w9.data_ptr()]
        return lambda: gn_silu_conv(x, sg, sb, gamma, beta, w9m, bias, **kw)

    for label, k in (("B", "gn_silu"), ("A", "gn_silu"), ("vae_fuse_groupnorm", "gn_silu"), ("A", "gn_silu_conv"),
                     ("vae_A", "gn_silu_conv"), ("B", "matmul")):
        kernel, twin, library, cost = specs[k]
        replays[(label, k)] = replay_times(f"{k} over one run under config {label} (bf16)", recorded[label][k],
                                           kernel, twin, library, "bf16", name, cost=cost,
                                           earlier=gn_conv_earlier if k == "gn_silu_conv" else None)
    mm_sites = site_report("matmul, config B", recorded["B"]["matmul"], matmul, matmul_reference, _matmul_library_call,
                           _matmul_cost, _matmul_plan_text, 2e-2, name)
    # every gn_silu_conv shape of a config-A UNet run and of a config-A VAE decode, on the graph's operands
    conv_key = lambda args, kw: (*args[0].shape, args[5].shape[1])
    gn_conv_sites = {label: site_report(f"gn_silu_conv, {label}", recorded[label]["gn_silu_conv"], gn_silu_conv,
                                        gn_silu_conv_reference, _gn_conv_library, _gn_conv_cost, _gn_conv_plan_text,
                                        2e-2, name, earlier=gn_conv_earlier, key=conv_key)
                     for label in ("A", "vae_A")}
    del w9_copies
    # every gn_silu shape of a config-B UNet run and of a fuse_groupnorm decode, on the graph's operands: one
    # launch of the cluster kernel a call (a whole run's replay too), its plan, the twin, a second call's bits
    gn_key = lambda args, kw: (*args[0].shape, args[7])
    gn_silu_sites = {}
    for label, per_run in (("B", 61), ("vae_fuse_groupnorm", 30)):
        # an x that arrives strided (config B's small-conv outputs are channels-last views) is made
        # contiguous by the wrapper first: one copy beside the one kernel
        calls = recorded[label]["gn_silu"]
        strided = lambda args: int(not args[0].is_contiguous() or args[0].data_ptr() % 16 != 0)
        _kernels_of(f"gn_silu, one run's {len(calls)} calls under {label}",
                    lambda: [gn_silu(*args, **kw) for args, kw in calls], per_run, GN_KERNEL,
                    sum(strided(args) for args, _ in calls))
        shapes = {}
        for args, kw in calls:
            shapes.setdefault((*gn_key(args, kw), strided(args)), (args, kw))
        for key, (args, kw) in sorted(shapes.items()):
            _kernels_of(f"gn_silu {key[:-1]}{' strided' if key[-1] else ''}, {label}", lambda: gn_silu(*args, **kw), 1,
                        GN_KERNEL, key[-1])
        gn_silu_sites[label] = site_report(f"gn_silu, {label}", calls, gn_silu, gn_silu_reference, _gn_library,
                                           _gn_cost, _gn_plan_text, 2e-2, name, key=gn_key)
    taken = {label: {site["variant"].split()[0] for site in sites.values()} for label, sites in gn_conv_sites.items()}
    print(f"gn_silu_conv variants over the recorded calls: {taken}")
    if taken != {"A": {"wgmma"}, "vae_A": {"wgmma"}}:
        raise SystemExit("gn_silu_conv: a call of the UNet run or the VAE decode missed the wgmma variant")
    out = {}
    for k, main in (("gn_silu", "B"), ("gn_silu_conv", "A"), ("matmul", "B")):
        out[k] = {"launches": launches[k], "max_abs_err": sites[k].worst, **replays[(main, k)],
                  "launches_per_run": {label: want[label][k] for label in ("A", "B")}}
    out["gn_silu"]["ms_by_path"] = {label: replays[(label, "gn_silu")] for label in ("A", "vae_fuse_groupnorm")}
    out["gn_silu"]["sites_of_run"] = gn_silu_sites
    out["gn_silu_conv"]["vae_decode"] = replays[("vae_A", "gn_silu_conv")]
    out["gn_silu_conv"]["passes_ms"] = passes
    out["gn_silu_conv"]["sites_of_run"] = gn_conv_sites
    out["matmul"]["sites_of_run"] = mm_sites
    out["matmul"]["around_ms"] = around["B"] - around["fuse_groupnorm"]
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
    sites = site_report("w8_matmul, uint8 step", calls, w8_matmul, w8_matmul_reference, dequantized_matmul,
                        _qmm_cost, _w8_plan_text, 2e-2, name)
    return {"launches": launches, "max_abs_err": site.worst, **times, "sites_of_step": sites}


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


def _matmul_library(a, w, a_scale, a_zero, w_scale, w_zero, weight_nk=False, **kw):
    ad, wd = _dequantized(a, a_scale, a_zero, torch.bfloat16), _dequantized(w, w_scale, w_zero, torch.bfloat16)
    if weight_nk:  # an (N, K) weight as cuBLAS takes it, a transposed view
        wd = wd.t()
    return lambda: torch.matmul(ad, wd)


def _qgemm_variant_text(a, w, *args, weight_nk=False, **kw) -> str:
    from onnxstream_tpu_torch.kernels.qmatmul import qgemm_variant

    k = a.shape[-1]
    m, n = a.numel() // k, w.numel() // k
    return (f"variant {qgemm_variant(m, k, n, weight_nk, a.data_ptr(), w.data_ptr())}, weight "
            + ("(N, K)" if weight_nk else "(K, N)"))


def _qmatmul_earlier(a, w, *args, weight_nk=False, **kw):
    """The same call on qgemm_kernel, the variant a calibrated MatMul took
    before its weight was uploaded K-major: the (K, N) weight, copied once
    here, outside the timed call."""
    from onnxstream_tpu_torch.kernels.qmatmul import qmatmul

    w_kn = w.t().contiguous() if weight_nk else w
    return lambda: qmatmul(a, w_kn, *args, **kw)


def _qconv_variant_text(x, w, *args, **kw) -> str:
    from onnxstream_tpu_torch.kernels.qconv import qconv_variant

    return f"variant {qconv_variant(x, w)}, " + ("channels-last" if x.is_contiguous(
        memory_format=torch.channels_last) and x.shape[2] * x.shape[3] > 1 else "NCHW")


def _qconv_earlier(x, w, *args, **kw):
    """The same conv on qgemm_kernel, the variant every conv took before the
    wgmma one: NCHW / OIHW copies of the operands, made once here, outside
    the timed call."""
    from onnxstream_tpu_torch.kernels.qconv import qconv

    xn, wn = x.contiguous(), w.contiguous()
    return lambda: qconv(xn, wn, *args, **kw)


def _w8a8_decoder_nchw(vae, ranges, z):
    """The W8A8 decoder built as before kernel 4's wgmma variant: the
    planner's channels-last test (qconv_takes_nhwc) answers no while the
    session plans, so no conv weight uploads channels-last and every conv
    input is quantized NCHW."""
    import onnxstream_tpu_torch.runtime.planner as planner_mod
    from onnxstream_tpu_torch.models.sd.pipeline import qu8_decoder

    keep = planner_mod.qconv_takes_nhwc
    planner_mod.qconv_takes_nhwc = lambda c: False
    try:
        sess = qu8_decoder(vae.to_text(), vae.weights, ranges, "bfloat16", torch.device("cuda:0"))
        sess.add_tensor("latent", z[None])
        sess.run(device_outputs=True)  # plans and uploads here
    finally:
        planner_mod.qconv_takes_nhwc = keep
    return sess


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
    # the wgmma variant: the weight as (N, K); M under and off the 128-row
    # tile, ragged N, K off the 128-byte k-tile and over many k-tiles; each
    # call twice for equal bits
    calls = []
    for m, k, n in [(4096, 512, 512), (1, 64, 8), (63, 48, 3), (77, 112, 257), (300, 4608, 130), (129, 16, 1000)]:
        a, w = u8(m, k), u8(n, k)
        bias = torch.randint(-5000, 5000, (n,), device="cuda", generator=gen, dtype=torch.int32)
        calls += [((a, w, 0.03, 120, 0.02, 128), dict(bias=bias, weight_nk=True, **o)) for o in outs]
    for args, kw in calls:
        if not _qgemm_variant_text(*args, **kw).startswith("variant wgmma"):
            raise SystemExit(f"qmatmul did not take the wgmma variant on {_about_qlinear(*args, **kw)}")
        if not torch.equal(qmatmul(*args, **kw), qmatmul(*args, **kw)):
            raise SystemExit(f"qmatmul's wgmma variant gave other bits on a second call: {_about_qlinear(*args, **kw)}")
    check_qlinear_calls("qmatmul", qmatmul, qmatmul_reference, calls,
                        "the wgmma variant, (N, K) weights at ragged shapes, 3 outputs, second calls bit-equal")
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
    # kernel 4's wgmma variant: channels-last operands (C % 16 == 0), padded
    # borders (za in the window), 1 x 1, stride 2, dilation, conv_out's O = 3,
    # output channels off the 128-row tile, pixel counts off and on the
    # 128-pixel tile; each call twice for equal bits, and against qgemm_kernel
    # on NCHW copies
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    calls = []
    for x, w, st, pd, dl in [((1, 512, 16, 16), (512, 512, 3, 3), (1, 1), (1, 1, 1, 1), (1, 1)),
                             ((2, 32, 9, 11), (64, 32, 3, 3), (2, 2), (0, 1, 2, 1), (1, 1)),
                             ((1, 48, 10, 13), (128, 48, 1, 1), (1, 1), (0, 0, 0, 0), (1, 1)),
                             ((1, 16, 14, 14), (64, 16, 3, 3), (1, 1), (2, 2, 2, 2), (2, 2)),
                             ((1, 128, 16, 16), (192, 128, 3, 3), (1, 1), (1, 1, 1, 1), (1, 1)),
                             ((1, 256, 32, 32), (128, 256, 1, 1), (1, 1), (0, 0, 0, 0), (1, 1)),
                             ((1, 128, 7, 9), (64, 128, 3, 3), (2, 1), (1, 0, 0, 1), (1, 1)),
                             ((1, 128, 20, 20), (3, 128, 3, 3), (1, 1), (1, 1, 1, 1), (1, 1))]:
        bias = torch.randn(w[0], device="cuda", generator=gen) * 30
        calls += [((cl(u8(*x)), cl(u8(*w)), 0.03, 120, 0.02, 128),
                   dict(bias=bias, strides=st, pads=pd, dilations=dl, **o)) for o in outs]
    for args, kw in calls:
        if not _qconv_variant_text(*args, **kw).startswith("variant wgmma"):
            raise SystemExit(f"qconv did not take the wgmma variant on {_about_qlinear(*args, **kw)}")
        got = qconv(*args, **kw)
        if not torch.equal(got, qconv(*args, **kw)) or not torch.equal(got, _qconv_earlier(*args, **kw)()):
            raise SystemExit(f"qconv's wgmma variant gave other bits on a second call or than qgemm_kernel: "
                             f"{_about_qlinear(*args, **kw)}")
    check_qlinear_calls("qconv", qconv, qconv_reference, calls,
                        "the wgmma variant, channels-last operands, 3 outputs, second calls and qgemm_kernel "
                        "bit-equal")


def _decode_image(pipe, lat, tiled: bool = False):
    """The decoder's float image (finite, checked before the cast) and the
    uint8 image, (8 h, 8 w, 3) for an (h, w) latent."""
    from onnxstream_tpu_torch.models.sd.pipeline import image_to_uint8

    img_f = pipe.decode_to_float(lat, tiled=tiled)
    if not bool(torch.isfinite(img_f).all()):
        raise SystemExit("the decoder gave a non-finite image")
    img = image_to_uint8(img_f)
    if img.shape != (8 * pipe.lath, 8 * pipe.latw, 3) or img.dtype != np.uint8:
        raise SystemExit(f"bad image {img.shape} {img.dtype}")
    return img


class _FlashSites(_GraphSiteCheck):
    """The packed flash wrapper as ops/attention.py calls it: each call's
    head dim and variant are recorded, and the armed call is held against
    the twin. A call's ``nopad=False`` (the default, which ops/attention.py
    passes) is dropped, so the recorded calls replay on the twin and the
    yardsticks too; a nopad route runs kernel 2, whose stand-in is
    _HeadMajorShapes."""

    def __init__(self, kernel, twin, tol):
        super().__init__(kernel, twin, tol,
                         lambda q, k, v, heads, **kw: f"q {tuple(q.shape)} heads {heads}, {_packed_variant(q, k, v, heads)}",
                         rel=FLASH_REL_L2)
        self.head_dims, self.variants = [], []

    def __call__(self, q, k, v, heads, **kw):
        if kw.get("nopad") is False:
            del kw["nopad"]
        self.head_dims.append(q.shape[-1] // heads)
        self.variants.append(_packed_variant(q, k, v, heads))
        return super().__call__(q, k, v, heads, **kw)

    def check_variants(self, label: str) -> None:
        """Every recorded call took a wgmma variant."""
        seen = {}
        for d, var in zip(self.head_dims, self.variants):
            seen[(d, var)] = seen.get((d, var), 0) + 1
        print(f"{label}: flash_attention_packed variants by head dim {seen}")
        if any(not var.startswith("wgmma") for _, var in seen):
            raise SystemExit(f"{label}: a flash site took a variant other than a wgmma one")


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
    flash.check_variants("SD image path")
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
    # the same W8A8 decoder with every conv on the NCHW route (qgemm_kernel,
    # the input quantized NCHW): the same bits, and the channels-last
    # quantization's cost in the profile beside it
    w8a8_nchw = _w8a8_decoder_nchw(vae, ranges, z)
    imgs = []
    for sess in (w8a8, w8a8_nchw):
        sess.clear_tensors()
        sess.add_tensor("latent", z[None])
        imgs.append(next(iter(sess.run(device_outputs=True).values())))
    same = torch.equal(imgs[0], imgs[1])
    print(f"W8A8 decode, channels-last convs (wgmma) vs NCHW convs (qgemm_kernel): bit-equal outputs: {same}")
    if not same:
        raise SystemExit("the W8A8 decode differs between its two conv routes")
    del imgs
    busy = {}
    for label, sess in (("W8A8 decode", w8a8), ("W8A8 decode, NCHW convs (qgemm_kernel)", w8a8_nchw),
                        ("bf16 decode", float_decoder)):
        sess.clear_tensors()
        sess.add_tensor("latent", z[None])
        rows = profile_steps(lambda: sess.run(device_outputs=True), name, label, steps=2)
        elementwise = sum(ms_ for ms_, _, key in rows if "elementwise" in key or "copy" in key.lower())
        busy[label] = sum(r[0] for r in rows)
        print(f"  {label}: device busy {busy[label]:.3f} ms, of which torch elementwise / copy kernels "
              f"{elementwise:.3f} ms (the activation quantization, its layout conversion included) [{name}]")
    del w8a8_nchw

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
    # kernel 4: which variant each of the decode's convs takes; every conv
    # that the wgmma variant takes by its predicate must have taken it
    from onnxstream_tpu_torch.kernels.qconv import qconv_variant
    from onnxstream_tpu_torch.kernels.qmatmul import qconv_takes_nhwc

    by_variant = {}
    for a, _ in calls["qconv"]:
        by_variant.setdefault(qconv_variant(a[0], a[1]), []).append(f"{tuple(a[0].shape)} * {tuple(a[1].shape)}")
    for var, shapes in sorted(by_variant.items()):
        print(f"qconv variant {var}: {len(shapes)} of the decode's {len(calls['qconv'])} convs: "
              + ", ".join(f"{sh} x{shapes.count(sh)}" for sh in sorted(set(shapes))))
    if any(qconv_takes_nhwc(a[0].shape[1]) != (qconv_variant(a[0], a[1]) == "wgmma")
           for a, _ in calls["qconv"]):
        raise SystemExit("a W8A8 decode conv did not take the variant its predicate names")
    nchw_calls = [((a[0].contiguous(), a[1].contiguous(), *a[2:]), k) for a, k in calls["qconv"]]
    t_e = device_ms(lambda: [qconv(*a, **k) for a, k in nchw_calls], iters=5)
    del nchw_calls
    times["qconv"]["earlier_variant_ms"] = t_e
    print(f"replay of qconv over one W8A8 decode's convs on qgemm_kernel (NCHW copies of the operands, made "
          f"outside the timed calls): {t_e:.4f} ms; the wgmma variant where it applies {times['qconv']['ms']:.4f} ms "
          f"[{name}]")
    conv_sites = site_report("qconv, W8A8 decode", calls["qconv"], qconv, qconv_reference, _conv_library,
                             _qconv_cost, _qconv_variant_text, 0.0, name, peak="int8", earlier=_qconv_earlier,
                             key=lambda a, k: (*a[0].shape, *a[1].shape))
    # kernel 3 at every shape of the decode's MatMuls, on the graph's operands
    # (the weights as uploaded, (N, K)): the variant, bit for bit, a second
    # call's bits, and the times beside the (K, N) weight on qgemm_kernel
    if not all(k.get("weight_nk") and _qgemm_variant_text(*a, **k).startswith("variant wgmma")
               for a, k in calls["qmatmul"]):
        raise SystemExit("a W8A8 decode MatMul did not take kernel 3's wgmma variant")
    sites = site_report("qmatmul, W8A8 decode", calls["qmatmul"], qmatmul, qmatmul_reference, _matmul_library,
                        _qmatmul_cost, _qgemm_variant_text, 0.0, name, peak="int8", earlier=_qmatmul_earlier)
    out = {k: {"launches": launches[k], "max_abs_err": max(errs[k], (qmm if k == "qmatmul" else qcv).worst),
               **times[k]} for k in ("qmatmul", "qconv")}
    out["qmatmul"]["sites_of_decode"] = sites
    out["qconv"]["sites_of_decode"] = conv_sites
    out["qconv"]["variants"] = {k: len(v) for k, v in by_variant.items()}
    out["w8a8_decode_busy_ms"] = busy
    out["flash_launches"] = launches["flash_attention_packed"]
    return out


# ------------------------------------------------------------ SDXL, SDXL Turbo, generate_batch
SDXL_FLASH_PER_RUN = 70  # self-attention sites a UNet run: 10 at 4096 tokens (10 heads), 60 at 1024 (20 heads), d = 64
SD15_FLASH_PER_RUN = 10  # the SD15 UNet's: 5 at 4096 tokens (d = 40), 5 at 1024 (d = 80)
SDXL_PROMPT = "a photo of an astronaut riding a horse on mars"
SDXL_NEG = "blurry, low quality"


class _FlashShapes(_FlashSites):
    """_FlashSites that holds the first call of every distinct shape against
    the twin on the graph's operands, as the graph made it (``seen``: shape
    -> (ok, max|diff|, about)); ``reset`` starts a new run."""

    def __init__(self, kernel, twin, tol):
        super().__init__(kernel, twin, tol)
        self.seen = {}

    def reset(self):
        self.seen = {}

    def __call__(self, q, k, v, heads, **kw):
        key = (tuple(q.shape), tuple(k.shape), heads)
        first = key not in self.seen
        if first:
            self.arm()
        out = super().__call__(q, k, v, heads, **kw)
        if first:
            self.seen[key] = self.result
        return out

    def check_shapes(self, label: str, want: int) -> None:
        for (qs, ks, h), (ok, err, about) in sorted(self.seen.items()):
            print(f"  {label}: first launch at q {qs} heads {h} vs twin on the graph's operands: max|diff| "
                  f"{err:.3e} {'ok' if ok else 'FAIL'}; {about}")
        if len(self.seen) != want or not all(r[0] for r in self.seen.values()):
            raise SystemExit(f"{label}: {len(self.seen)} site shapes checked (want {want}), or one disagrees")


def _packed_cost(q, k, v, heads, scale=None, causal=False):
    """(bytes, operations, exponentials) of one packed call: q, k, v read
    once, the output written once; QK^T and PV at 2 operations a
    multiply-add; one exp2 a score."""
    b, m, hd = q.shape
    n = k.shape[1]
    return _nbytes(q, k, v) + _nbytes(q), 4 * b * m * n * hd, b * heads * m * n


def _packed_library(q, k, v, heads, scale=None, causal=False):
    return lambda: _sdpa_packed(q, k, v, heads)


def _about_packed(q, k, v, heads, **kw) -> str:
    return f"q {tuple(q.shape)} heads {heads} ({_packed_variant(q, k, v, heads)})"


def _weights_of(sessions) -> int:
    """Bytes of the distinct resident device weights of the sessions."""
    seen = {}
    for s in sessions:
        for ex in s._executors.values():
            for t in ex.device_weights():
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def _plan_and_synthesize(label: str, sess, inputs: dict) -> tuple:
    """Plan sess for these inputs, then make its weights (synthesized on the
    card): (plan s, synthesis s)."""
    sess.clear_tensors()
    for k, v in inputs.items():
        sess.add_tensor(k, v)
    t0 = time.perf_counter()
    ex = sess._executor()
    t1 = time.perf_counter()
    for seg in ex.segments:
        ex._fetch_segment_weights(seg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  {label}: {len(sess.graph.ops)} ops, plan {t1 - t0:.2f} s, weights synthesized on the card in "
          f"{t2 - t1:.2f} s ({ex.weight_bytes() / 2**30:.3f} GiB)")
    return t1 - t0, t2 - t1


def _xl_unet_inputs(pipe, x: np.ndarray, t: float, branch) -> dict:
    """The SDXL UNet's inputs for one run: the sample tiled to the branch's
    rows, its context, pooled embeds and time ids."""
    from onnxstream_tpu_torch.models.sd.pipeline import SDXL_TIME_IDS

    names = pipe._unet_input_names()
    rows = branch["context"].shape[0]
    return {names["sample"]: np.repeat(x[None], rows, axis=0), names["timestep"]: np.array([t], np.float32),
            names["context"]: branch["context"], names["text_embeds"]: branch["pooled"],
            names["time_ids"]: np.tile(SDXL_TIME_IDS, (rows, 1))}


def _run_unet(sess, inputs: dict) -> np.ndarray:
    sess.clear_tensors()
    for k, v in inputs.items():
        sess.add_tensor(k, v)
    return next(v for v in sess.run().values() if v.ndim == 4)


def _tiny_xl_card_vs_cpu() -> None:
    """TINY SDXL in fp32 (the builders' weights, not synthesized: the card's
    and the CPU's generators differ) with a batch-2 UNet on the card against
    the CPU: the device loop's latents within 1e-4 * max, and Turbo's."""
    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline

    for turbo, batch in ((False, 2), (True, 1)):
        lats = {}
        for dev in ("cpu", "cuda:0"):
            pipe = StableDiffusionPipeline.from_synthetic(tiny=True, xl=True, turbo=turbo, batch=batch,
                                                          device=torch.device(dev))
            lats[dev] = pipe.generate_on_device("a photo of a cat", "dog", steps=3, seed=7, decode=False).latents
        err = float(np.abs(lats["cuda:0"] - lats["cpu"]).max())
        bound_ = 1e-4 * float(np.abs(lats["cpu"]).max())
        print(f"TINY SDXL{' Turbo' if turbo else ''} (UNet batch {batch}) fp32 card vs CPU: latents max|diff| "
              f"{err:.3e} (bound {bound_:.3e})")
        if not err <= bound_:
            raise SystemExit("the TINY SDXL pipeline on the card disagrees with the CPU run")


def _levels(a: np.ndarray, b: np.ndarray) -> tuple:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float(d.mean()), int(d.max())


def phase_sdxl(name: str) -> dict:
    """SDXL base at 1024 x 1024 in bf16 at full width with weights
    synthesized on the card: CLIP-L + CLIP-bigG, the SDXL UNet at batch 2
    (the CFG pair as one run), VAE_SD at the 128 x 128 latent and its 64 x 64
    tile decoder; then SDXL Turbo (batch-1 UNet, no uncond branch)."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.models.sd import scheduler as sched
    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline

    _tiny_xl_card_vs_cpu()
    cuda = torch.device("cuda:0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.from_synthetic(tiny=False, xl=True, batch=2, on_device=True,
                                                  compute_dtype="bfloat16", device=cuda)
    print(f"SDXL pipeline (CLIP-L, CLIP-bigG, SDXL UNet at batch 2, VAE at 128 x 128 + 64 x 64 tiles; lazy "
          f"weights) built in {time.perf_counter() - t0:.1f} s")
    names = pipe._unet_input_names()
    spec = pipe.unet.graph.inputs
    toks = np.zeros((1, pipe._clip_seq), np.int64)
    cond = {"context": np.zeros(spec[names["context"]].shape[1:], np.float32),
            "pooled": np.zeros((1, spec[names["text_embeds"]].shape[1]), np.float32)}
    both = pipe._stack_branches(cond, cond)
    z = np.zeros((1, 4, pipe.lath, pipe.latw), np.float32)
    tile = pipe._tile_size
    plan_s = synth_s = 0.0
    for label, sess, inputs in (
            ("CLIP-L", pipe.text_encoder, {"tokens": toks}),
            ("CLIP-bigG", pipe.text_encoder_2, {"tokens": toks}),
            ("SDXL UNet, batch 2", pipe.unet, _xl_unet_inputs(pipe, z[0], 999.0, both)),
            (f"VAE decoder, {pipe.lath} x {pipe.latw} latent", pipe.vae_decoder, {"latent": z}),
            (f"VAE tile decoder, {tile} x {tile} latent", pipe.vae_tile_session, {"latent": z[:, :, :tile, :tile]})):
        p, s_ = _plan_and_synthesize(label, sess, inputs)
        plan_s, synth_s = plan_s + p, synth_s + s_
    sessions = [pipe.text_encoder, pipe.text_encoder_2, pipe.unet, pipe.vae_decoder, pipe.vae_tile_session]
    wbytes = _weights_of(sessions)
    print(f"SDXL: plan {plan_s:.2f} s, weight synthesis {synth_s:.2f} s, device weight bytes {wbytes / 1e9:.3f} GB, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{name}]")

    flash = _FlashShapes(flash_attention_packed, flash_attention_packed_reference, 2e-2)
    ms, res = {}, {}
    # the path: the requests below; the count is zeroed just before it
    flash_attention_packed.launches = 0
    attention_op.flash_attention_packed = flash
    try:
        # 1. a 10-step euler_a image on the device loop: one batch-2 UNet run a step
        flash.reset()
        res["a"], ms["a"] = _timed(lambda: pipe.generate_on_device(SDXL_PROMPT, SDXL_NEG, steps=10, seed=42,
                                                                    decode=False))
        n1 = flash_attention_packed.launches
        lat = res["a"].latents
        print(f"SDXL request (a) euler_a, 10 steps, device loop, UNet batch 2: latents {lat.shape} finite="
              f"{np.isfinite(lat).all()} max|lat| {np.abs(lat).max():.3f}, {ms['a']:.1f} ms (the twin's checks "
              f"included), flash_attention_packed launches {n1} (want {10 * SDXL_FLASH_PER_RUN}) [{name}]")
        if lat.shape != (4, pipe.lath, pipe.latw) or not np.isfinite(lat).all() or n1 != 10 * SDXL_FLASH_PER_RUN:
            raise SystemExit(f"SDXL request (a): bad latents or {n1} flash launches")
        flash.check_shapes("SDXL UNet batch 2", 2)
        # the decodes of (a): whole (one launch at 16384 tokens) and tiled (9 tiles, one each at 4096)
        n0 = flash_attention_packed.launches
        flash.reset()
        img, ms["decode"] = _timed(lambda: _decode_image(pipe, lat))
        n_whole = flash_attention_packed.launches - n0
        img_tiled, ms["tiled"] = _timed(lambda: _decode_image(pipe, lat, tiled=True))
        n_tiled = flash_attention_packed.launches - n0 - n_whole
        gap = _levels(img, img_tiled)
        print(f"SDXL decode of (a): whole {img.shape} {ms['decode']:.1f} ms ({n_whole} flash launch, want 1), tiled "
              f"{ms['tiled']:.1f} ms ({n_tiled} launches, want 9); tiled vs whole: mean {gap[0]:.3f}, max {gap[1]} "
              f"levels [{name}]")
        if img_tiled.shape != img.shape or n_whole != 1 or n_tiled != 9:
            raise SystemExit("SDXL decode: bad image or flash launches")
        flash.check_shapes("SDXL VAE decodes", 2)
        # 2. the same prompt, 2 steps, host loop (generate: _denoise_cfg2) against the device loop
        n0 = flash_attention_packed.launches
        res["host"], ms["host2"] = _timed(lambda: pipe.generate(SDXL_PROMPT, SDXL_NEG, steps=2, seed=42, decode=False))
        res["dev"], ms["dev2"] = _timed(lambda: pipe.generate_on_device(SDXL_PROMPT, SDXL_NEG, steps=2, seed=42,
                                                                        decode=False))
        n2 = flash_attention_packed.launches - n0
        a, b = res["dev"].latents, res["host"].latents
        err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"SDXL 2 steps, host loop {ms['host2']:.1f} ms vs device loop {ms['dev2']:.1f} ms: latents max|diff| "
              f"{err:.4e}, max|lat| {top:.3f}, ratio {err / top:.3e} (bound 5e-2); flash launches {n2} "
              f"(want {4 * SDXL_FLASH_PER_RUN})")
        if not (np.isfinite(a).all() and err <= 5e-2 * top) or n2 != 4 * SDXL_FLASH_PER_RUN:
            raise SystemExit("SDXL: the host loop and the device loop disagree")
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    launches = flash_attention_packed.launches
    flash.check_variants("SDXL path")
    peak = max(flash.peak, torch.cuda.max_memory_allocated())
    print(f"SDXL path launches: flash_attention_packed {launches}; peak device memory {peak / 2**30:.2f} GiB [{name}]")

    # one batch-2 UNet run of step 0 of (a): flash on against off, its 70 calls recorded
    cb, ub = pipe.encode_prompt_xl(SDXL_PROMPT), pipe.encode_prompt_xl(SDXL_NEG)
    pair = pipe._stack_branches(cb, ub)
    sigma0 = float(sched.sigma_schedule(10)[0])
    from onnxstream_tpu_torch.models.sd.rng import randn_4_w_h

    x0 = np.asarray(randn_4_w_h(42, pipe.latw, pipe.lath) * sigma0 * sched.get_scalings(sigma0)[0], np.float32)
    t_0 = sched.sigma_to_t(sigma0)
    inputs2 = _xl_unet_inputs(pipe, x0, t_0, pair)
    flash.calls = []
    attention_op.flash_attention_packed = flash
    try:
        out2 = _run_unet(pipe.unet, inputs2)
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    calls, flash.calls = flash.calls, None
    pipe.unet.config.use_flash_attention = False
    try:
        off = _run_unet(pipe.unet, inputs2)
    finally:
        pipe.unet.config.use_flash_attention = True
    diff, top = float(np.abs(off - out2).max()), float(np.abs(out2).max())
    print(f"SDXL UNet batch 2, flash on vs off: max|diff| {diff:.4e}, max|out| {top:.4f}, ratio {diff / top:.4e} "
          f"(bound 5e-2); {len(calls)} flash calls recorded (want {SDXL_FLASH_PER_RUN})")
    if not (np.isfinite(out2).all() and diff <= 5e-2 * top) or len(calls) != SDXL_FLASH_PER_RUN:
        raise SystemExit("SDXL UNet: flash on and off disagree, or the run made another number of flash calls")
    unet_ms = {"batch2": busy_and_wall(lambda: pipe.unet.run(device_outputs=True), "SDXL UNet run, batch 2", name)}
    _, ms["loop10"] = _timed(lambda: pipe.generate_on_device(SDXL_PROMPT, SDXL_NEG, steps=10, seed=42, decode=False))
    _, ms["decode_warm"] = _timed(lambda: _decode_image(pipe, lat))
    _, ms["tiled_warm"] = _timed(lambda: _decode_image(pipe, lat, tiled=True))
    print(f"SDXL warm [{name}]: 10-step euler_a image loop {ms['loop10']:.1f} ms, decode whole "
          f"{ms['decode_warm']:.1f} ms, tiled {ms['tiled_warm']:.1f} ms")
    # kernel 1 over the run's 70 calls and at each of its shapes, then the VAE's sites
    fa = replay_times("flash_attention_packed over one SDXL UNet run's calls (batch 2)", calls,
                      flash_attention_packed, flash_attention_packed_reference, _packed_library, "bf16", name,
                      cost=_packed_cost)
    close = lambda got, ref: _flash_agrees(got, ref, 2e-2)[0]
    sites = site_report("flash_attention_packed, SDXL UNet batch 2", calls, flash_attention_packed,
                        flash_attention_packed_reference, _packed_library, _packed_cost, _about_packed, 2e-2, name,
                        close=close, key=lambda a, k: (*a[0].shape, a[3]))
    del calls
    vae_calls = []
    flash.calls = vae_calls
    attention_op.flash_attention_packed = flash
    try:
        _decode_image(pipe, lat)
        _decode_image(pipe, lat, tiled=True)
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
        flash.calls = None
    sites.update(site_report("flash_attention_packed, SDXL VAE decodes", vae_calls[:2], flash_attention_packed,
                             flash_attention_packed_reference, _packed_library, _packed_cost, _about_packed, 2e-2,
                             name, close=close, key=lambda a, k: (*a[0].shape, a[3])))
    del vae_calls
    del pipe, flash
    gc.collect()
    torch.cuda.empty_cache()

    # SDXL Turbo: a batch-1 UNet, no uncond branch; its UNet also runs each row of the batch-2 run
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    turbo = StableDiffusionPipeline.from_synthetic(tiny=False, xl=True, turbo=True, on_device=True,
                                                   compute_dtype="bfloat16", device=cuda)
    flash = _FlashShapes(flash_attention_packed, flash_attention_packed_reference, 2e-2)
    flash_attention_packed.launches = 0
    attention_op.flash_attention_packed = flash
    try:
        res["turbo"], ms["turbo"] = _timed(lambda: turbo.generate_on_device(SDXL_PROMPT, SDXL_NEG, steps=1, seed=42,
                                                                             decode=False))
        n_t = flash_attention_packed.launches
        flash.check_shapes("SDXL Turbo UNet batch 1", 2)
        host1 = turbo.generate(SDXL_PROMPT, "", steps=1, seed=42, decode=False).latents
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    turbo_launches = flash_attention_packed.launches
    lt = res["turbo"].latents
    err, top = float(np.abs(lt - host1).max()), float(np.abs(host1).max())
    print(f"SDXL Turbo 1 step, device loop: latents {lt.shape} finite={np.isfinite(lt).all()}, {ms['turbo']:.1f} ms "
          f"incl. build, plan and synthesis {time.perf_counter() - t0:.1f} s since the build began; flash launches "
          f"{n_t} (want {SDXL_FLASH_PER_RUN}: no uncond branch); host loop vs device loop max|diff| {err:.4e} of "
          f"max|lat| {top:.3f} (bound 5e-2) [{name}]")
    if not np.isfinite(lt).all() or n_t != SDXL_FLASH_PER_RUN or not err <= 5e-2 * top:
        raise SystemExit("SDXL Turbo: bad latents, flash launches, or host and device loops disagree")
    _decode_image(turbo, lt)
    # the batch-2 run against two batch-1 runs of the same weights (same seeds, same plan order)
    names = turbo._unet_input_names()
    for row in (0, 1):
        one = {k: (v[row:row + 1] if k != names["timestep"] else v) for k, v in inputs2.items()}
        o1 = _run_unet(turbo.unet, one)
        diff, top = float(np.abs(o1[0] - out2[row]).max()), float(np.abs(o1).max())
        print(f"SDXL UNet batch 2 row {row} ({'cond' if row == 0 else 'uncond'}) vs a batch-1 run: max|diff| "
              f"{diff:.4e}, max|out| {top:.4f}, ratio {diff / top:.4e} (bound 5e-2)")
        if not diff <= 5e-2 * top:
            raise SystemExit(f"SDXL UNet: row {row} of the batch-2 run disagrees with its batch-1 run")
    turbo.unet.clear_tensors()
    for k, v in inputs2.items():
        turbo.unet.add_tensor(k, v[:1] if k != names["timestep"] else v)
    unet_ms["batch1"] = busy_and_wall(lambda: turbo.unet.run(device_outputs=True), "SDXL UNet run, batch 1", name)
    calls1 = []
    flash.calls = calls1
    attention_op.flash_attention_packed = flash
    try:
        turbo.unet.run(device_outputs=True)
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
        flash.calls = None
    sites.update(site_report("flash_attention_packed, SDXL UNet batch 1", calls1, flash_attention_packed,
                             flash_attention_packed_reference, _packed_library, _packed_cost, _about_packed, 2e-2,
                             name, close=close, key=lambda a, k: (*a[0].shape, a[3])))
    del calls1, turbo, flash
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches + turbo_launches, "replay": fa, "ms_by_shape": sites, "unet": unet_ms, "ms": ms,
            "device_weight_bytes": wbytes}


def _sd15_unet_inputs(pipe, prompts, seeds, steps: int) -> dict:
    """The SD15 UNet's inputs for the cond branch of step 0 of each prompt,
    stacked: each row as generate would give it."""
    from onnxstream_tpu_torch.models.sd import scheduler as sched
    from onnxstream_tpu_torch.models.sd.rng import randn_4_w_h

    sigma0 = float(sched.sigma_schedule(steps)[0])
    c_in = np.float32(sched.get_scalings(sigma0)[0])
    names = pipe._unet_input_names()
    return {names["sample"]: np.stack([np.asarray(randn_4_w_h(s % 1000, pipe.latw, pipe.lath) * sigma0, np.float32)
                                       * c_in for s in seeds]),
            names["timestep"]: np.array([sched.sigma_to_t(sigma0)], np.float32),
            names["context"]: np.stack([pipe.encode_prompt(p) for p in prompts]).astype(np.float32)}


def phase_sd_batch(name: str) -> dict:
    """SD1.5 generate_batch at full width: 4 prompts through a batch-4 UNet,
    2 euler_a steps, bf16, weights synthesized on the card. The batch-4 run
    against four batch-1 runs of the same weights; then, in float32 (where a
    batch changes nothing but the order of sums), each image against a
    sequential generate with the same seed."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline

    cuda = torch.device("cuda:0")
    prompts = SD_PROMPTS + ["a red bicycle leaning on a wall"]
    seeds = [3, 5, 7, 11]
    out = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        bat = StableDiffusionPipeline.from_synthetic(tiny=False, batch=4, on_device=True, compute_dtype=dtype,
                                                     device=cuda)
        seq = StableDiffusionPipeline.from_synthetic(tiny=False, on_device=True, compute_dtype=dtype, device=cuda)
        print(f"SD1.5 pipelines, {dtype} (UNet batch 4 and batch 1, weights synthesized on the card) built in "
              f"{time.perf_counter() - t0:.1f} s")
        if dtype == "bfloat16":
            # the path: the count is zeroed just before it and read just after
            flash = _FlashShapes(flash_attention_packed, flash_attention_packed_reference, 2e-2)
            flash_attention_packed.launches = 0
            attention_op.flash_attention_packed = flash
            try:
                res, ms = _timed(lambda: bat.generate_batch(prompts, steps=2, seeds=seeds))
            finally:
                attention_op.flash_attention_packed = flash_attention_packed
            launches = flash_attention_packed.launches
            want = 4 * SD15_FLASH_PER_RUN + 4
            print(f"SD1.5 generate_batch, 4 prompts, 2 euler_a steps, UNet batch 4, bf16: {ms:.1f} ms incl. plan and "
                  f"synthesis, flash_attention_packed launches {launches} (want {want}: {SD15_FLASH_PER_RUN} a "
                  f"UNet run x 2 runs x 2 steps + 1 a decode x 4) [{name}]")
            if launches != want or any(not np.isfinite(r.latents).all() for r in res):
                raise SystemExit(f"generate_batch: {launches} flash launches, or non-finite latents")
            flash.check_shapes("SD15 generate_batch (UNet batch 4, VAE)", 3)
            flash.check_variants("SD15 generate_batch")
            if len({r.image.tobytes() for r in res}) != 4:
                raise SystemExit("generate_batch gave equal images for distinct prompts")
            # the batch-4 run against four batch-1 runs on the same inputs
            inputs = _sd15_unet_inputs(bat, prompts, seeds, 2)
            four = _run_unet(bat.unet, inputs)
            tname = bat._unet_input_names()["timestep"]
            for j in range(4):
                one = _run_unet(seq.unet, {k: (v if k == tname else v[j:j + 1]) for k, v in inputs.items()})
                diff, top = float(np.abs(one[0] - four[j]).max()), float(np.abs(one).max())
                print(f"  SD15 UNet batch 4 row {j} vs a batch-1 run: max|diff| {diff:.4e}, max|out| {top:.4f}, "
                      f"ratio {diff / top:.4e} (bound 5e-2)")
                if not diff <= 5e-2 * top:
                    raise SystemExit(f"generate_batch: row {j} of the batch-4 UNet run disagrees with its batch-1 run")
            _, ms_warm = _timed(lambda: bat.generate_batch(prompts, steps=2, seeds=seeds, decode=False))
            print(f"SD1.5 generate_batch warm, 4 images x 2 steps without decode: {ms_warm:.1f} ms [{name}]")
            out = {"launches": launches, "warm_ms": ms_warm,
                   "unet_batch4": busy_and_wall(lambda: bat.unet.run(device_outputs=True),
                                                "SD1.5 UNet run, batch 4, bf16", name)}
            seq.unet.clear_tensors()
            for k, v in inputs.items():
                seq.unet.add_tensor(k, v if k == tname else v[:1])
            out["unet_batch1"] = busy_and_wall(lambda: seq.unet.run(device_outputs=True),
                                               "SD1.5 UNet run, batch 1, bf16", name)
        else:
            res = bat.generate_batch(prompts, steps=2, seeds=seeds, decode=False)
        # each image against a sequential generate with the same seed; in
        # bf16 the batch's other library kernels round differently, which
        # CFG at scale 7 amplifies to ~5e-2 of the latents in 2 steps
        # (measured on an NVIDIA H100 80GB HBM3): printed. Bounded in
        # float32, where the same gap measured ~1.5e-5
        for j, (p, s) in enumerate(zip(prompts, seeds)):
            r = seq.generate(p, steps=2, seed=s, decode=False)
            err, top = float(np.abs(res[j].latents - r.latents).max()), float(np.abs(r.latents).max())
            print(f"  {dtype} image {j} (seed {s}) vs sequential generate: latents max|diff| {err:.4e} of max|lat| "
                  f"{top:.3f}, ratio {err / top:.3e}" + (" (bound 1e-3)" if dtype == "float32" else ""))
            if dtype == "float32" and not (np.isfinite(res[j].latents).all() and err <= 1e-3 * top):
                raise SystemExit(f"generate_batch image {j} disagrees with the sequential generate")
        del bat, seq, res
        gc.collect()
        torch.cuda.empty_cache()
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

    # kernel 2 over one prefill's calls, on the graph's operands: the variant,
    # the kernel against its twin, a second call's bits, the times beside the
    # mma variant's, SDPA's and the twin's
    site.calls = []
    attention_op.flash_attention = site
    try:
        pipe.reset()
        pipe.forward(p1, want_logits=False)
    finally:
        attention_op.flash_attention = flash_attention
    calls, site.calls = site.calls, None
    if len(calls) != 22 or any(_flash_variant_text(*a, **k) != "variant wgmma" for a, k in calls):
        raise SystemExit(f"the prefill made {len(calls)} flash calls, or not all took the wgmma variant")
    sites = site_report("flash_attention, TinyLlama prefill", calls, flash_attention, flash_attention_reference,
                        _sdpa_library, _flash_cost, _flash_variant_text, 2e-2, name, close=_flash_close,
                        earlier=_flash_earlier)
    replay = replay_times("flash_attention over one TinyLlama prefill's 22 calls (bf16)", calls, flash_attention,
                          flash_attention_reference, _sdpa_library, "bf16", name, cost=_flash_cost)
    del calls
    return {"launches": launches, "bank": pipe._weight_bank, "logits_p1": on, "logits_p1_f32": l32,
            "prompts": prompts, "flash": {"sites_of_prefill": sites, "prefill_replay": replay}}


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
    from onnxstream_tpu_torch.kernels.qmatmul import dyn_variant, w8a8_dyn_matmul, w8a8_dyn_matmul_reference
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
    # bit for bit on the graph's operands: the twin computes the kernel's arithmetic
    site = _GraphSiteCheck(w8a8_dyn_matmul, w8a8_dyn_matmul_reference, 0.0, _about_qmm)
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

    # every recorded call: the variant the dispatcher took for the graph's K-major weight, bit for bit
    # with the twin and with the (K, N) weight on the variant it replaced (copies made here, after the read
    # of the counts)
    kn = {}
    for key, calls in recorded.items():
        variants = {}
        for args, kw in calls:
            a, w = args[0], args[1]
            m, (n, k) = a.numel() // a.shape[-1], w.shape
            v = dyn_variant(m, k, n, kw.get("weight_nk", False), w.data_ptr())
            variants[v] = variants.get(v, 0) + 1
            if w.data_ptr() not in kn:
                kn[w.data_ptr()] = w.t().contiguous()
            w_kn = kn[w.data_ptr()]
            got, ref = w8a8_dyn_matmul(*args, **kw), w8a8_dyn_matmul_reference(*args, **kw)
            old = w8a8_dyn_matmul(a, w_kn, *args[2:], out_dtype=kw.get("out_dtype"))
            if not (torch.equal(got, ref) and torch.equal(got, old)):
                raise SystemExit(f"int8 {key}: w8a8_dyn_matmul differs from its twin on a recorded call "
                                 f"({m}, {k}) x ({n}, {k})")
        print(f"int8 {key}: {len(calls)} recorded calls, variants {variants}, every call bit for bit with the twin "
              f"and with the (K, N) weight's variant")
        if set(variants) != {"gemv_nk" if key == "decode" else "wgmma"}:
            raise SystemExit(f"int8 {key}: the calls did not all take the K-major form")

    def earlier(a, w, ws, out_dtype=None, weight_nk=False):
        w_kn = kn[w.data_ptr()]
        return lambda: w8a8_dyn_matmul(a, w_kn, ws, out_dtype=out_dtype)

    def int_mm(a, w, ws, out_dtype=None, weight_nk=False):
        return _int_mm_or_none(_quantize_rows(a), kn[w.data_ptr()])

    times = {k: replay_times(f"w8a8_dyn_matmul over one TinyLlama {k} run (bf16)", calls, w8a8_dyn_matmul,
                             w8a8_dyn_matmul_reference, int_mm, "int8", name, earlier=earlier)
             for k, calls in recorded.items()}

    # the library yardsticks: torch._int_mm on the quantized operands over the prefill's calls it takes
    # (the kernel timed over the same calls beside it), and cuBLAS bf16 on bf16 copies of the weights over
    # all calls of the prefill and of the decode step (a product without the activation quantization)
    pre = recorded["prefill"]
    libs = [int_mm(*a, **k) for a, k in pre]
    sub = [(c, f) for c, f in zip(pre, libs) if f is not None]
    t_sub = device_ms(lambda: [w8a8_dyn_matmul(*a, **k) for (a, k), _ in sub], iters=5)
    t_int = device_ms(lambda: [f() for _, f in sub], iters=5)
    copies = {p: w.to(torch.bfloat16) for p, w in kn.items()}
    t_bf = {}
    for key, calls in recorded.items():
        bf16 = [(a[0], copies[a[1].data_ptr()]) for a, _ in calls]
        t_bf[key] = device_ms(lambda: [torch.matmul(x, w) for x, w in bf16], iters=5)
    del copies, bf16, kn
    print(f"w8a8_dyn_matmul, one TinyLlama prefill: torch._int_mm takes {len(sub)} of {len(pre)} calls: kernel "
          f"{t_sub:.4f} ms, torch._int_mm {t_int:.4f} ms over those; over all {len(pre)}: kernel "
          f"{times['prefill']['ms']:.4f} ms, cuBLAS bf16 on bf16 copies of the weights {t_bf['prefill']:.4f} ms; "
          f"one decode step's {len(recorded['decode'])}: kernel {times['decode']['ms']:.4f} ms, cuBLAS bf16 on bf16 "
          f"copies {t_bf['decode']:.4f} ms (no activation quantization) [{name}]")
    prefill = {**times["prefill"], "int_mm_calls": len(sub), "kernel_ms_on_int_mm_calls": t_sub, "int_mm_ms": t_int,
               "bf16_matmul_ms": t_bf["prefill"]}
    times["decode"]["bf16_matmul_ms"] = t_bf["decode"]
    return {"launches": launches, "max_abs_err": site.worst, **times["decode"], "prefill": prefill}



# ------------------------------------------------------------------ Whisper base: kernel 1 at the encoder's sites
WHISPER_FLASH_PER_REQUEST = 6  # the encoder's self-attention sites: 8 heads of 64 over 1500 tokens
WHISPER_SR = 16000


def _whisper_audio(kind: str, seed: int, seconds: float = 30.0) -> np.ndarray:
    """A 16 kHz window from a seed: noise, a chirp, or 8 s of a tone then
    silence (the tone at a frequency from the seed)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(WHISPER_SR * seconds)) / WHISPER_SR
    if kind == "noise":
        return (rng.standard_normal(t.size) * 0.1).astype(np.float32)
    if kind == "chirp":
        return (0.3 * np.sin(2 * np.pi * (100 + 60 * t) * t)).astype(np.float32)
    f = 200 + 400 * rng.random()
    return np.where(t < 8.0, 0.5 * np.sin(2 * np.pi * f * t), 0.0).astype(np.float32)


WHISPER_REQUESTS = [("noise", 0), ("chirp", 1), ("tone_then_silence", 2)]


def _tiny_whisper_card_vs_cpu() -> None:
    """WHISPER_TINY_TEST in fp32 on the card against the port on the CPU: the
    encoder's cross K / V within 1e-4 * max, and equal tokens for noise, a
    300 Hz tone and silence."""
    from onnxstream_tpu_torch.models.whisper import WHISPER_TINY_TEST, WhisperPipeline

    pipes = {dev: WhisperPipeline.from_synthetic(WHISPER_TINY_TEST, device=torch.device(dev))
             for dev in ("cpu", "cuda:0")}
    t = np.arange(WHISPER_SR) / WHISPER_SR
    audio = [np.random.default_rng(0).standard_normal(WHISPER_SR).astype(np.float32) * 0.1,
             (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), np.zeros(WHISPER_SR, np.float32)]
    worst, toks = 0.0, {}
    for a in audio:
        kv = {dev: [x.float().cpu().numpy() for x in p.encode(a)] for dev, p in pipes.items()}
        for got, ref in zip(kv["cuda:0"], kv["cpu"]):
            worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
        for dev, p in pipes.items():
            toks.setdefault(dev, []).append(p.transcribe(a, max_tokens=8))
    print(f"TINY Whisper fp32 card vs CPU: cross K/V max|diff|/max {worst:.3e} (bound 1e-4); tokens card "
          f"{toks['cuda:0']} cpu {toks['cpu']}")
    if not worst <= 1e-4 or toks["cuda:0"] != toks["cpu"]:
        raise SystemExit("TINY Whisper on the card disagrees with the CPU run")


def _decoder_step(pipe, L: int, offset: int, kv: list, ck, cv):
    """One decoder run on device tensors (the pipeline's loop body): (logits
    tensor, the new self K / V)."""
    from onnxstream_tpu_torch.models.whisper.model import mangle

    s = pipe._decoder(L)
    s.clear_tensors()
    tok = list(pipe.cfg.sot_sequence) if L > 1 else [220]
    s.add_tensor(mangle("tokens"), np.asarray([tok[:L]], np.int64))
    s.add_tensor(mangle("offset"), np.asarray([offset], np.int64))
    s.add_tensor(mangle("in_n_layer_self_k_cache"), kv[0])
    s.add_tensor(mangle("in_n_layer_self_v_cache"), kv[1])
    s.add_tensor(mangle("n_layer_cross_k"), ck)
    s.add_tensor(mangle("n_layer_cross_v"), cv)
    out = s.run(device_outputs=True)
    return (out[mangle("logits")], [out[mangle("out_n_layer_self_k_cache")],
                                    out[mangle("out_n_layer_self_v_cache")]])


def _zero_kv(pipe, ck) -> list:
    """Empty self K / V buffers, as transcribe starts them."""
    cfg = pipe.cfg
    shape = (cfg.n_text_layer, 1, cfg.n_text_ctx, cfg.n_text_state)
    return [torch.zeros(shape, dtype=ck.dtype, device=ck.device) for _ in range(2)]


def _first_step(pipe, audio):
    """Encoder outputs and the first decoder step's last logits, as float32
    numpy, for one window."""
    ck, cv = pipe.encode(audio)
    logits, _ = _decoder_step(pipe, 4, 0, _zero_kv(pipe, ck), ck, cv)
    return [x.float().cpu().numpy() for x in (ck, cv, logits[0, -1])]


def _whisper_requests(pipe, label: str, site, name: str) -> list:
    """The three 30 s requests through transcribe: each must launch kernel 1
    exactly WHISPER_FLASH_PER_REQUEST times, the first held to the twin."""
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed

    outs = []
    for kind, seed in WHISPER_REQUESTS:
        before = flash_attention_packed.launches
        site.arm()
        toks, ms = _timed(lambda: pipe.transcribe(_whisper_audio(kind, seed), max_tokens=32))
        n = flash_attention_packed.launches - before
        print(f"Whisper base {label}, request {kind} (seed {seed}, 30 s): {len(toks)} tokens {toks} in {ms:.1f} ms "
              f"(the twin's check included), flash_attention_packed launches {n} (want {WHISPER_FLASH_PER_REQUEST}) "
              f"[{name}]")
        if not toks or not all(0 <= t < pipe.cfg.n_vocab for t in toks) or n != WHISPER_FLASH_PER_REQUEST:
            raise SystemExit(f"Whisper base {label}, request {kind}: bad tokens or {n} flash launches")
        site.check(f"Whisper base {label}, request {kind}")
        outs.append(toks)
    return outs


def _whisper_sessions_check(pipe, label: str) -> None:
    """One encoder plan and two decoder Sessions (L = 4 and L = 1) of one plan
    each, however far the offset went."""
    plans = {L: len(s._executors) for L, s in pipe._decoders.items()}
    print(f"Whisper base {label}: encoder plans {len(pipe.encoder._executors)}, decoder sessions by L {plans}")
    if len(pipe.encoder._executors) != 1 or plans != {4: 1, 1: 1}:
        raise SystemExit(f"Whisper base {label}: want one encoder plan and decoder sessions {{4: 1, 1: 1}}")


def _whisper_times(pipe, label: str, name: str, audio) -> dict:
    """The host's log-mel features (ms), then the encoder run, the prefill
    (L = 4) and a decode step (L = 1, offset 4 .. 35): wall and device busy
    ms."""
    from onnxstream_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from onnxstream_tpu_torch.models.whisper.model import mangle

    cfg = pipe.cfg
    mel, mel_ms = _timed(lambda: log_mel_spectrogram(audio, n_mels=cfg.n_mels, pad_to=2 * cfg.n_audio_ctx))
    enc = pipe.encoder
    enc.clear_tensors()
    enc.add_tensor(mangle("mel"), mel)
    out = {"mel_host_ms": mel_ms,
           "encoder": busy_and_wall(lambda: enc.run(device_outputs=True),
                                    f"Whisper base {label} encoder run (30 s window; log-mel on the host "
                                    f"{mel_ms:.2f} ms before it)", name)}
    ck, cv = pipe.encode(audio)
    zeros = _zero_kv(pipe, ck)
    out["prefill"] = busy_and_wall(lambda: _decoder_step(pipe, 4, 0, zeros, ck, cv),
                                   f"Whisper base {label} prefill (4 tokens)", name)
    _, kv = _decoder_step(pipe, 4, 0, zeros, ck, cv)
    state = {"kv": kv, "offset": 4}

    def step():
        _, state["kv"] = _decoder_step(pipe, 1, state["offset"], state["kv"], ck, cv)
        state["offset"] = 4 + (state["offset"] - 3) % 32

    out["decode_step"] = busy_and_wall(step, f"Whisper base {label} decode step (1 token)", name, steps=5)
    return out


def phase_whisper(name: str) -> dict:
    """Whisper base at full width: TINY card vs CPU, then WHISPER_BASE with
    host weights from seed 0 in bf16 and float32 through WhisperPipeline with
    device=None (three 30 s requests each, 32 tokens), and one bf16 request
    with weights synthesized on the card."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.models.whisper import WHISPER_BASE, WhisperPipeline

    _tiny_whisper_card_vs_cpu()
    cfg = WHISPER_BASE
    pipes, t_build = {}, {}
    for dt in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        pipes[dt] = WhisperPipeline.from_synthetic(cfg, seed=0, compute_dtype=dt)  # device=None: cuda:0
        t_build[dt] = time.perf_counter() - t0
    if pipes["bfloat16"].device != torch.device("cuda", 0):
        raise SystemExit(f"WhisperPipeline(device=None) runs on {pipes['bfloat16'].device}, want cuda:0")
    sites = {"bfloat16": _FlashSites(flash_attention_packed, flash_attention_packed_reference, 2e-2),
             "float32": _FlashSites(flash_attention_packed, flash_attention_packed_reference, 1e-4)}
    toks, t_on_device = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path: three requests in each precision and one on synthesized weights; counts zeroed just before
    flash_attention_packed.launches = 0
    try:
        for dt, pipe in pipes.items():
            attention_op.flash_attention_packed = sites[dt]
            toks[dt] = _whisper_requests(pipe, dt, sites[dt], name)
        t0 = time.perf_counter()
        synth = WhisperPipeline.from_synthetic(cfg, seed=0, compute_dtype="bfloat16", on_device=True)
        t_on_device["build_s"] = time.perf_counter() - t0
        attention_op.flash_attention_packed = sites["bfloat16"]
        before = flash_attention_packed.launches
        kind, seed = WHISPER_REQUESTS[0]
        sites["bfloat16"].arm()
        synth_toks, t_on_device["first_request_ms"] = _timed(
            lambda: synth.transcribe(_whisper_audio(kind, seed), max_tokens=32))
        sites["bfloat16"].check("Whisper base, weights synthesized on the card")
        n_synth = flash_attention_packed.launches - before
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    launches = flash_attention_packed.launches
    print(f"Whisper base, weights synthesized on the card (bf16): built in {t_on_device['build_s']:.1f} s, "
          f"request {kind}: {len(synth_toks)} tokens in {t_on_device['first_request_ms']:.1f} ms (first run: plans "
          f"and synthesis included), {n_synth} flash launches (want {WHISPER_FLASH_PER_REQUEST}) [{name}]")
    if n_synth != WHISPER_FLASH_PER_REQUEST or not synth_toks:
        raise SystemExit("Whisper base on synthesized weights: bad tokens or flash launches")
    t_on_device["encoder"] = busy_and_wall(lambda: synth.encode(_whisper_audio(kind, seed)),
                                           "Whisper base bf16 encoder on synthesized weights", name)
    sites["bfloat16"].check_variants("Whisper base bf16 encoder")
    print(f"Whisper base fp32 encoder: flash_attention_packed variants {sorted(set(sites['float32'].variants))}")
    peak = max(s.peak for s in sites.values())
    peak = max(peak, torch.cuda.max_memory_allocated())
    wbytes = {dt: _weights_of([p.encoder, *p._decoders.values()]) for dt, p in pipes.items()}
    print(f"Whisper base path: flash_attention_packed launches {launches} (3 requests x 2 precisions + 1 on "
          f"synthesized weights, {WHISPER_FLASH_PER_REQUEST} each); pipelines built in "
          f"{t_build['bfloat16']:.1f} s (bf16) and {t_build['float32']:.1f} s (fp32) (host weights from seed 0); "
          f"peak device memory {peak / 2**20:.1f} MB; device weight bytes bf16 {wbytes['bfloat16'] / 1e6:.1f} MB, "
          f"fp32 {wbytes['float32'] / 1e6:.1f} MB [{name}]")
    if launches != 7 * WHISPER_FLASH_PER_REQUEST:
        raise SystemExit(f"Whisper base path: {launches} flash launches, want {7 * WHISPER_FLASH_PER_REQUEST}")
    for dt, pipe in pipes.items():
        _whisper_sessions_check(pipe, dt)
    del synth
    gc.collect()
    torch.cuda.empty_cache()

    # float32 on the card against the port on the CPU: encoder outputs and first-step logits
    audio = _whisper_audio(*WHISPER_REQUESTS[1])
    cpu = WhisperPipeline.from_synthetic(cfg, seed=0, compute_dtype="float32", device=torch.device("cpu"))
    ref = _first_step(cpu, audio)
    del cpu
    got = _first_step(pipes["float32"], audio)
    errs = [float(np.abs(g - r).max() / np.abs(r).max()) for g, r in zip(got, ref)]
    print(f"Whisper base fp32 card vs CPU: cross K {errs[0]:.3e}, cross V {errs[1]:.3e}, first-step logits "
          f"{errs[2]:.3e} (max|diff| / max, bound 1e-3)")
    if not max(errs) <= 1e-3:
        raise SystemExit("Whisper base fp32 on the card disagrees with the CPU run")
    b16 = _first_step(pipes["bfloat16"], audio)
    nrms = _nrms(b16[2], got[2])
    print(f"Whisper base bf16 vs fp32 first-step logits on the card: nrms {nrms:.4e} (printed, not gated: "
          f"random weights)")
    # flash on against off, the bf16 encoder's cross K / V
    enc = pipes["bfloat16"].encoder
    on = [x.float() for x in pipes["bfloat16"].encode(audio)]
    enc.config.use_flash_attention = False
    try:
        off = [x.float() for x in pipes["bfloat16"].encode(audio)]
    finally:
        enc.config.use_flash_attention = True
    ratio = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(on, off))
    print(f"Whisper base bf16 encoder, flash on vs off: cross K / V max|diff| / max|out| {ratio:.4e} (bound 5e-2)")
    if not ratio <= 5e-2:
        raise SystemExit("Whisper base: the flash-on and flash-off encoders disagree")
    del on, off
    # host syncs per token: a 32-token budget against an 8-token one, on a request that made 32 tokens
    pipe = pipes["bfloat16"]
    full = [req for req, t in zip(WHISPER_REQUESTS, toks["bfloat16"]) if len(t) == 32]
    if not full:
        raise SystemExit("Whisper base bf16: no request ran to its 32-token budget; host syncs not measured")
    a = _whisper_audio(*full[0])
    n8, n32 = len(pipe.transcribe(a, max_tokens=8)), len(pipe.transcribe(a, max_tokens=32))
    s8 = _syncs_in(lambda: pipe.transcribe(a, max_tokens=8))
    s32 = _syncs_in(lambda: pipe.transcribe(a, max_tokens=32))
    per8, per_more = s8 / n8, (s32 - s8) / max(n32 - n8, 1)
    print(f"Whisper base bf16 host syncs reported in transcribe: {s8} for {n8} tokens, {s32} for {n32} tokens; "
          f"{per8:.2f} a token over the first {n8}, {per_more:.2f} a token after them")
    if n32 <= n8 or per_more > per8:
        raise SystemExit("Whisper base: host syncs a token grow with the tokens")

    times = {}
    for dt in ("bfloat16", "float32", "float32", "bfloat16"):  # in turns: the host's clock drifts
        times.setdefault(dt, []).append(_whisper_times(pipes[dt], dt, name, audio))
    profile_steps(lambda: pipes["bfloat16"].encode(audio), name, "Whisper base bf16 encoder")

    # kernel 1 at the encoder's sites, on the graph's operands: one encoder run's 6 calls in each precision
    out = {"launches": launches, "tokens": toks, "times": times, "peak_bytes": peak, "device_weight_bytes": wbytes,
           "bf16_vs_fp32_logits_nrms": nrms, "on_device": t_on_device}
    for dt, tol, peak_op in (("bfloat16", 2e-2, "bf16"), ("float32", 1e-4, "f32")):
        site = sites[dt]
        site.calls = []
        attention_op.flash_attention_packed = site
        try:
            pipes[dt].encode(audio)
        finally:
            attention_op.flash_attention_packed = flash_attention_packed
        calls, site.calls = site.calls, None
        if len(calls) != WHISPER_FLASH_PER_REQUEST:
            raise SystemExit(f"Whisper base {dt} encoder: {len(calls)} flash calls recorded")
        out[f"sites_{dt}"] = site_report(
            f"flash_attention_packed, Whisper base encoder {dt}", calls, flash_attention_packed,
            flash_attention_packed_reference, _packed_library, _packed_cost, _about_packed, tol, name, peak=peak_op,
            close=lambda g, r, tol=tol: _flash_agrees(g, r, tol)[0], key=lambda a, k: (*a[0].shape, a[3]))
        out[f"replay_{dt}"] = replay_times(
            f"flash_attention_packed over one Whisper base encoder run's 6 calls ({dt})", calls,
            flash_attention_packed, flash_attention_packed_reference, _packed_library, peak_op, name,
            cost=_packed_cost)
        del calls
    del pipes
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ the op library's ONNX ops on the card
def phase_ops(name: str) -> dict:
    """Every case of tests/test_torch_ops_card.py (the op types converted ONNX
    graphs need, Conv of rank 3) on the card against the port on the CPU, in
    float32 and bf16: floats within 1e-5 / 1e-2 of max|out|, integers and
    bools equal."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_ops_card import OP_CASES, card_agrees, run_case

    worst, bad = {}, []
    for key in sorted(OP_CASES):
        for dt in ("float32", "bfloat16"):
            ok, err = card_agrees(run_case(OP_CASES[key], dt, "cuda:0"), run_case(OP_CASES[key], dt, "cpu"), dt)
            worst[dt] = max(worst.get(dt, 0.0), err)
            if not ok:
                bad.append(f"{key} {dt} ({err:.3e})")
    print(f"op cases on the card vs the CPU: {len(OP_CASES)} cases x 2 dtypes, worst relative error float32 "
          f"{worst['float32']:.3e} (bound 1e-5), bfloat16 {worst['bfloat16']:.3e} (bound 1e-2); failing: "
          f"{bad or 'none'} [{name}]")
    if bad:
        raise SystemExit("op cases disagree on the card: " + ", ".join(bad))
    return {"cases": len(OP_CASES), "worst_rel_err": worst}


# ------------------------------------------------------------------ the YOLO pipeline around a stand-in head
def phase_yolo(name: str) -> dict:
    """YoloPipeline.detect at 640 x 640 RGBA on the card (device=None) around
    tests/yolo_standin.py's stand-in head (YOLOv8n's I/O contract, not
    YOLOv8n: the converted model is not in the repository), against the
    port on the CPU: boxes within rtol = atol = 1e-3, NMS indices equal."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from onnxstream_tpu_torch.models.yolo import YoloPipeline
    from yolo_standin import anchors, standin_image, write_standin

    model = write_standin(os.path.join(REPO, ".cache", "yolo_standin640"), size=640, seed=0)
    img = standin_image(640, seed=1)
    card = YoloPipeline.from_model_txt(model)  # device=None: cuda:0
    cpu = YoloPipeline.from_model_txt(model, device=torch.device("cpu"))
    got, ms_first = _timed(lambda: card.detect(img))
    want = cpu.detect(img)
    err = float(np.abs(got.boxes - want.boxes).max())
    excess = float((np.abs(got.boxes - want.boxes) / (1e-3 + 1e-3 * np.abs(want.boxes))).max())
    print(f"YOLO pipeline around a STAND-IN head (not YOLOv8n; images (1, 3, 640, 640) -> output0 (1, 84, "
          f"{anchors(640)})), 640 x 640 RGBA: {len(got.indices)} detections after NMS, card vs CPU boxes "
          f"max|diff| {err:.3e} px, {excess:.3f} of the bound rtol = atol = 1e-3, indices equal "
          f"{got.indices == want.indices}; first detect {ms_first:.1f} ms (plan included) [{name}]")
    if (got.boxes.shape != (anchors(640), 4) or not np.isfinite(got.boxes).all()
            or not np.allclose(got.boxes, want.boxes, rtol=1e-3, atol=1e-3)
            or got.indices != want.indices or not got.indices):
        raise SystemExit("YOLO pipeline: the card disagrees with the CPU run")
    times = busy_and_wall(lambda: card.detect(img), "YOLO stand-in detect (pre-ops, head, post-ops, host NMS)", name)
    times["session"] = busy_and_wall(lambda: card.session.run(), "YOLO stand-in session run (no NMS)", name)
    return {"detections": len(got.indices), "boxes_max_abs_err": err, **times}


# --------------------------------------------- weight streaming from disk, and the model server
STREAM_BUDGETS = (512 << 20, 128 << 20)  # hbm_budget_bytes of the streamed UNet runs
IMAGE_BUDGET = 256 << 20  # hbm_budget_bytes of the streamed image pipeline
# device memory a run may take above Executor.hbm_accounting()'s bound: the
# scratch inside an op that the bound does not count (cuDNN workspaces, fp32
# upcasts inside an op, a flash launch's split partials), set before the
# first streamed run on the card
PEAK_SLACK = 256 << 20
# from_synthetic's tiny test vocabulary, as the folder's tokenizer/vocab.json
SD_VOCAB = {**{chr(ord("a") + i) + "</w>": 10 + i for i in range(26)},
            **{w + "</w>": 40 + i for i, w in enumerate(["cat", "dog", "photo", "of", "fluffy", "horse", "astronaut",
                                                          "riding", "mars", "on", "the", "an"])}, ",</w>": 267}


def write_sd15_folder(root: str) -> str:
    """The reference's SD1.5 folder at full width, random weights from
    seeds: text_encoder_fp32/ (CLIP-L, seed 0), unet_fp16/ (SD15, seed 0,
    float16 .bin files, 1.72 GB), vae_decoder_fp16/ (VAE_SD at the 64 x 64
    latent, seed 2) and tokenizer/vocab.json, written by the port's
    GraphBuilder.save (no JAX)."""
    from onnxstream_tpu_torch.models.sd.clip import CLIP_L, build_text_encoder
    from onnxstream_tpu_torch.models.sd.unet import SD15, build_unet, param_count
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder

    t0 = time.perf_counter()
    for sub, build, half in (("text_encoder_fp32", lambda: build_text_encoder(CLIP_L, seed=0), False),
                             ("unet_fp16", lambda: build_unet(SD15, seed=0), True),
                             ("vae_decoder_fp16", lambda: build_vae_decoder(
                                 dataclasses.replace(VAE_SD, sample=64), seed=2), True)):
        b = build()
        b.save(os.path.join(root, sub), float16=half)
        if sub == "unet_fp16":
            print(f"unet_fp16: {param_count(b) / 1e6:.1f} M params")
        del b
        gc.collect()
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w") as f:
        json.dump(SD_VOCAB, f)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, files in os.walk(root) for n in files)
    unet = sum(os.path.getsize(os.path.join(d, n)) for d, _, files in os.walk(os.path.join(root, "unet_fp16"))
               for n in files)
    print(f"SD1.5 folder written in {time.perf_counter() - t0:.1f} s: {size / 1e9:.3f} GB, unet_fp16 "
          f"{unet / 1e9:.3f} GB -> {root}")
    return os.path.join(root, "unet_fp16", "model.txt")


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a: float, b: float, merged) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if y > a and x < b)


def copy_overlap(run, label: str, name: str) -> dict:
    """One warm call of run under torch.profiler (CPU and CUDA); from the
    exported trace: the kernels by stream, the host-to-device copies by
    stream, how much of the copies off the compute stream (the one most
    kernels ran on) lies under a kernel, the device busy time (the union of
    kernels and copies) and the idle share of the host wall time."""
    import tempfile
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tempfile.gettempdir(), f"ostt_trace_{os.getpid()}.json")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        kern = [e for e in events if e.get("cat") == "kernel"]
        if kern:
            break
        print("copy_overlap: the trace holds no kernel events; profiling again")
    else:
        raise SystemExit(f"{label}: three profiles without device events")
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    compute = Counter(e["args"].get("stream") for e in kern).most_common(1)[0][0]
    kmerged = _merged((e["ts"], e["ts"] + e["dur"]) for e in kern)
    off = [e for e in h2d if e["args"].get("stream") != compute]
    on = [e for e in h2d if e["args"].get("stream") == compute]
    off_us = sum(e["dur"] for e in off)
    under = sum(_overlap(e["ts"], e["ts"] + e["dur"], kmerged) for e in off)
    off_bytes = sum(e["args"].get("bytes", 0) for e in off)
    busy = sum(b - a for a, b in _merged((e["ts"], e["ts"] + e["dur"]) for e in kern + h2d)) / 1e3
    k_ms = sum(e["dur"] for e in kern) / 1e3
    out = {"wall_ms": wall, "kernel_ms": k_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
           "h2d_copy_stream_ms": off_us / 1e3, "h2d_copy_stream_bytes": off_bytes,
           "h2d_copy_stream_gb_s": off_bytes / off_us / 1e3 if off_us else 0.0,
           "h2d_compute_stream_ms": sum(e["dur"] for e in on) / 1e3,
           "copy_under_kernels_share": under / off_us if off_us else 0.0,
           "copy_streams": sorted({str(e["args"].get("stream")) for e in off}), "compute_stream": str(compute)}
    print(f"  profile of {label} (profiler on) [{name}]: wall {wall:.1f} ms, kernels {k_ms:.2f} ms on stream "
          f"{compute}, device busy {busy:.2f} ms (kernels and copies), idle {100 * out['idle_share']:.1f}% of wall; "
          f"host-to-device on stream(s) {out['copy_streams']}: {len(off)} copies, {off_bytes / 1e6:.1f} MB in "
          f"{off_us / 1e3:.2f} ms ({out['h2d_copy_stream_gb_s']:.1f} GB/s), {100 * out['copy_under_kernels_share']:.1f}% "
          f"of it under a kernel; on the compute stream {len(on)} copies, {out['h2d_compute_stream_ms']:.3f} ms")
    return out


def phase_streamed(name: str, model: str) -> dict:
    """The SD1.5 UNet (bf16) read from the folder's unet_fp16/ by a Session
    under ram+prefetch and the native prefetch, at hbm_budget_bytes 0 and
    STREAM_BUDGETS, three requests each: every output bit for bit with the
    first resident run, the allocator's peak within hbm_accounting()'s bound
    + PEAK_SLACK, warm ram+prefetch runs converting nothing on the host, 10
    flash launches a run (the first streamed launch held to the twin), the
    weight copies on a stream of their own and their share under kernels.
    Then a 4-step 512 x 512 euler_a image from the folder by from_dir under
    IMAGE_BUDGET against the resident one."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
    from onnxstream_tpu_torch.models.sd.unet import SD15

    reqs = _requests(SD15, 0)
    flash = _FlashSites(flash_attention_packed, flash_attention_packed_reference, 2e-2)
    resident, sessions, armed = None, {}, False
    flash_attention_packed.launches = 0
    attention_op.flash_attention_packed = flash
    try:
        for wp in ("ram+prefetch", "prefetch"):
            for budget in (0, *STREAM_BUDGETS):
                label = f"{wp} at hbm_budget_bytes {budget >> 20} MiB"
                s = Session(SessionConfig(compute_dtype="bfloat16", hbm_budget_bytes=budget,
                                          device=torch.device("cuda:0")), weights_provider_name=wp)
                s.read_file(model)
                row = {"walls_ms": [], "peaks": [], "conversions": []}
                outs = []
                for i, req in enumerate(reqs):
                    for k, v in req.items():
                        s.add_tensor(k, v)
                    ex = s._executor()
                    acc = ex.hbm_accounting()
                    if budget and not armed:
                        flash.arm()
                    gc.collect()
                    torch.cuda.synchronize()
                    base, n0, c0 = torch.cuda.memory_allocated(), flash_attention_packed.launches, ex.host_conversions
                    torch.cuda.reset_peak_memory_stats()
                    flash.peak = 0
                    out, ms = _timed(lambda: s.run()["out_sample"])
                    peak = max(flash.peak, torch.cuda.max_memory_allocated()) - base
                    n, conv = flash_attention_packed.launches - n0, ex.host_conversions - c0
                    row["walls_ms"].append(ms)
                    row["peaks"].append(peak)
                    row["conversions"].append(conv)
                    outs.append(out)
                    print(f"{label}, request {i}: {ms:.1f} ms, {len(ex.segments)} segments, "
                          f"{acc['weight_bytes'] / 1e6 if budget else 0:.1f} MB streamed, flash launches {n}, "
                          f"host conversions {conv}, peak {peak / 2**20:.1f} MiB above the run's start (bound "
                          f"{acc['peak_bytes'] / 2**20:.1f} + slack {PEAK_SLACK >> 20} MiB) [{name}]")
                    if out.shape != (1, 4, 64, 64) or not np.isfinite(out).all() or n != 10:
                        raise SystemExit(f"{label}, request {i}: bad output or {n} flash launches (want 10)")
                    if peak > acc["peak_bytes"] + PEAK_SLACK:
                        raise SystemExit(f"{label}, request {i}: peak {peak} B above the accounting bound + slack")
                    if wp == "ram+prefetch" and i > 0 and conv:
                        raise SystemExit(f"{label}, request {i}: {conv} host conversions on a warm run")
                    if budget and not armed:
                        armed = True
                        flash.check(f"{label}, request {i}")
                if resident is None:
                    resident = outs
                same = [np.array_equal(o, r) for o, r in zip(outs, resident)]
                print(f"{label}: outputs bit for bit with the first resident run: {same}")
                if not all(same):
                    diff = max(float(np.abs(o - r).max()) for o, r in zip(outs, resident))
                    raise SystemExit(f"{label}: outputs differ from the resident run (max|diff| {diff:.3e})")
                row.update(segments=len(ex.segments), streamed_bytes=acc["weight_bytes"] if budget else 0,
                           accounting_peak_bytes=acc["peak_bytes"], hbm_stats_peak=s.hbm_stats()["peak_bytes_in_use"])
                if budget:
                    row["profile"] = copy_overlap(lambda: s.run(), label, name)
                    prof = row["profile"]
                    if not prof["copy_streams"] or prof["h2d_copy_stream_bytes"] < 0.9 * acc["weight_bytes"]:
                        raise SystemExit(f"{label}: the weights did not cross on a copy stream")
                sessions[f"{wp}@{budget >> 20}MiB"] = row
                s.close()
                del s, ex
                gc.collect()
                torch.cuda.empty_cache()
        flash.check_variants("SD15 streamed UNet path")
        images = {}
        for budget in (0, IMAGE_BUDGET):
            pipe = StableDiffusionPipeline.from_dir(os.path.dirname(os.path.dirname(model)),
                                                    hbm_budget_bytes=budget, device=torch.device("cuda:0"))
            n0 = flash_attention_packed.launches
            res, ms = _timed(lambda: pipe.generate(SD_PROMPTS[0], "", steps=4, seed=42, sampler="euler_a"))
            n = flash_attention_packed.launches - n0
            images[budget] = res
            print(f"from_dir image at hbm_budget_bytes {budget >> 20} MiB: {res.image.shape} {res.image.dtype}, "
                  f"4 euler_a steps, {ms:.1f} ms (plan and first upload included), flash launches {n} "
                  f"(want 81: 8 UNet runs and the decoder's one) [{name}]")
            if res.image.shape != (512, 512, 3) or n != 81:
                raise SystemExit(f"from_dir image at {budget >> 20} MiB: bad image or {n} flash launches")
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
        a, b = images[0], images[IMAGE_BUDGET]
        lat_same, img_same = np.array_equal(a.latents, b.latents), np.array_equal(a.image, b.image)
        print(f"streamed image against resident: latents bit for bit {lat_same}, image bit for bit {img_same}")
        if not (lat_same and img_same):
            raise SystemExit("the streamed image differs from the resident one")
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    return {"launches": flash_attention_packed.launches, "sessions": sessions, "resident": resident}


def phase_serve(name: str, model: str, resident: list) -> dict:
    """The port's HTTP server in a thread on the card: unet_fp16/ loaded over
    HTTP (wp=prefetch, read_file enabled, use_bf16_arithmetic), three /run
    requests, each output read back as little-endian f32 and held bit for
    bit to the in-process resident Session's; then tests/data/capi_smoke.c
    compiled with gcc against libonnxstream_tpu_torch.so and run (rc 0)."""
    import struct
    import sysconfig
    import tempfile
    import threading
    import urllib.request

    from onnxstream_tpu_torch.cli.serve_main import serve
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed
    from onnxstream_tpu_torch.models.sd.unet import SD15
    from onnxstream_tpu_torch.runtime.native import exports_library

    def req(method, path, body=None):
        r = urllib.request.Request(url + path, data=body, method=method)
        with urllib.request.urlopen(r, timeout=600) as resp:
            return resp.read()

    srv = serve("127.0.0.1", 0, allow_read_file=True, device="cuda")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    latencies = []
    try:
        h = json.loads(req("POST", "/models?wp=prefetch"))["handle"]
        req("POST", f"/models/{h}/options?name=use_bf16_arithmetic&value=1")
        err = json.loads(req("POST", f"/models/{h}/read_file", model.encode()))
        if err:
            raise SystemExit(f"serve: read_file failed: {err}")
        flash_attention_packed.launches = 0
        for i, r in enumerate(_requests(SD15, 0)):
            t0 = time.perf_counter()
            for k, v in r.items():
                dims = ",".join(str(d) for d in v.shape)
                req("PUT", f"/models/{h}/tensors/{k}?type=float32&dims={dims}", v.astype(np.float32).tobytes())
            t1 = time.perf_counter()
            err = json.loads(req("POST", f"/models/{h}/run"))
            t2 = time.perf_counter()
            body = req("GET", f"/models/{h}/tensors/out_sample")
            t3 = time.perf_counter()
            latencies.append((t3 - t0) * 1e3)
            parts = f"{len(r)} PUTs {(t1 - t0) * 1e3:.1f} ms, run {(t2 - t1) * 1e3:.1f}, GET {(t3 - t2) * 1e3:.1f}"
            if err:
                raise SystemExit(f"serve: request {i}: {err}")
            nd = struct.unpack_from("<I", body)[0]
            dims = struct.unpack_from(f"<{nd}I", body, 4)
            out = np.frombuffer(body, "<f4", offset=4 + 4 * nd).reshape(dims)
            same = np.array_equal(out, resident[i])
            print(f"served request {i}: {latencies[-1]:.1f} ms ({parts}"
                  f"{'; plan and weight upload included' if i == 0 else ''}), output {tuple(dims)} bit for bit "
                  f"with the in-process session {same}, flash launches so far {flash_attention_packed.launches} "
                  f"[{name}]")
            if not same or flash_attention_packed.launches != 10 * (i + 1):
                raise SystemExit(f"serve: request {i} disagrees with the in-process session or launched "
                                 f"{flash_attention_packed.launches} flash kernels")
        launches = flash_attention_packed.launches
        req("DELETE", f"/models/{h}")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    gc.collect()
    torch.cuda.empty_cache()

    lib = exports_library()
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "capi_smoke")
        cc = subprocess.run(["gcc", "-O1", "-Wall", "-Werror", "-pthread",
                             os.path.join(REPO, "tests", "data", "capi_smoke.c"), "-o", exe, f"-L{lib.parent}",
                             "-lonnxstream_tpu_torch", f"-Wl,-rpath,{lib.parent}"],
                            capture_output=True, text=True, timeout=300)
        if cc.returncode != 0:
            raise SystemExit(f"capi_smoke.c did not compile:\n{cc.stderr}")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, sysconfig.get_paths()["purelib"]]))
        env.pop("PYTHONHOME", None)
        t0 = time.perf_counter()
        run = subprocess.run([exe], capture_output=True, text=True, timeout=300, env=env)
    print(f"capi_smoke.c against {lib.name} on the card: rc {run.returncode} in {time.perf_counter() - t0:.1f} s, "
          f"{run.stdout.strip()}")
    if run.returncode != 0 or "CAPI_C_SMOKE_OK" not in run.stdout:
        raise SystemExit(f"capi_smoke.c failed:\n{run.stdout}\n{run.stderr[-3000:]}")
    return {"launches": launches, "latency_ms": latencies}


# ------------------------------------------------------------------------------------------------
# the channel-last layout pass, flash_packed_nopad, force_fp16_storage, the ONNX converter
# ------------------------------------------------------------------------------------------------
LAYOUT_CONVERSIONS = ("nchwToNhwc", "nhwcToNchw")  # cuDNN's own layout-conversion kernels, by name
SD15_FLASH_PER_RUN = 10  # kernel 1's packed sites a SD15 UNet run at the 64 x 64 latent (d = 40 x 5, d = 80 x 5)


def _graph_counts(s) -> dict:
    kinds = [op.op_type for op in s.graph.ops]
    return {"ops": len(kinds), "ostpu.groupnorm": kinds.count("ostpu.groupnorm"),
            "ostpu.reshape": kinds.count("ostpu.reshape"), "Transpose": kinds.count("Transpose"),
            "nhwc_convs": sum(op.op_type == "Conv" and op.attr("layout") == "NHWC" for op in s.graph.ops)}


def _layout_profile(step, label: str, name: str) -> dict:
    """One profiled pair of warm calls: device busy a call, its kernel and copy launches, and the launches
    and ms of cuDNN's layout conversion kernels among them."""
    rows = profile_steps(step, name, label)
    conv = [(ms, n) for ms, n, key in rows if any(c in key for c in LAYOUT_CONVERSIONS)]
    out = {"busy_ms": sum(r[0] for r in rows), "launches": sum(r[1] for r in rows),
           "conversions": sum(n for _, n in conv), "conversion_ms": sum(ms for ms, _ in conv)}
    print(f"  {label}: device busy {out['busy_ms']:.3f} ms over {out['launches']} kernel and copy launches, cuDNN "
          f"layout conversions {out['conversions']} launches {out['conversion_ms']:.3f} ms [{name}]")
    return out


def _close(label: str, out, ref, rel: float) -> float:
    """max|out - ref| <= rel * max|ref|, printed; returns the ratio."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    ratio = float(np.abs(out - ref).max() / max(float(np.abs(ref).max()), 1e-30))
    print(f"  {label}: max|diff| / max|ref| {ratio:.4e} (bound {rel:g})")
    if not (out.shape == ref.shape and np.isfinite(out).all() and ratio <= rel):
        raise SystemExit(f"{label}: outside the bound")
    return ratio


def phase_layout(name: str, sd: dict) -> dict:
    """use_nhwc_layout on the SD15 UNet and the VAE_SD decoder at full width (module docstring, 14)."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    import onnxstream_tpu_torch.ops.standard as standard
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.kernels.gn_conv import gn_silu_conv, gn_silu_conv_reference
    from onnxstream_tpu_torch.kernels.gn_silu import gn_silu, gn_silu_reference
    from onnxstream_tpu_torch.models.sd.pipeline import image_to_uint8
    from onnxstream_tpu_torch.models.sd.unet import SD15, TINY, build_unet
    from onnxstream_tpu_torch.models.sd.vae import VAE_SD, build_vae_decoder

    gt = build_unet(TINY)
    _tiny_unet_card_vs_cpu("TINY UNet, channel-last,", gt.to_text(), gt.weights, _requests(TINY, 1)[1],
                           use_nhwc_layout=True)
    g, text, reqs = sd["graph"], sd["graph"].to_text(), _requests(SD15, 0)
    out: dict = {"graph": {}, "unet": {}, "vae": {}}
    sess = {"nchw": _session(text, g.weights, "bfloat16", "cuda:0"),
            "nhwc": _session(text, g.weights, "bfloat16", "cuda:0", use_nhwc_layout=True)}
    for label, s in sess.items():
        out["graph"][label] = _graph_counts(s)
        print(f"SD15 UNet graph, {label}: {out['graph'][label]}")
    if out["graph"]["nhwc"]["nhwc_convs"] != sum(op.op_type == "Conv" for op in sess["nchw"].graph.ops):
        raise SystemExit("channel-last UNet: a Conv kept its NCHW form")
    flash = _FlashSites(flash_attention_packed, flash_attention_packed_reference, 2e-2)
    # the path: three requests under each layout in turns, the float32 pair, the VAE decodes, config A;
    # kernel 1's count is zeroed just before it, and ``nhwc`` adds up its launches in the channel-last runs only
    flash_attention_packed.launches = 0
    attention_op.flash_attention_packed = flash
    outs, nhwc = {}, 0
    try:
        for i, req in enumerate(reqs):
            for label in (("nchw", "nhwc") if i % 2 == 0 else ("nhwc", "nchw")):
                s = sess[label]
                for k, v in req.items():
                    s.add_tensor(k, v)
                if label == "nhwc" and i == 0:
                    flash.arm()
                f0 = flash_attention_packed.launches
                o, ms = _timed(lambda: s.run()["out_sample"])
                outs[(label, i)] = o
                n = flash_attention_packed.launches - f0
                nhwc += n if label == "nhwc" else 0
                print(f"request {i}, {label}: {o.shape} finite={np.isfinite(o).all()} {ms:.1f} ms, kernel 1 launches {n}")
                if n != SD15_FLASH_PER_RUN or o.shape != (1, 4, 64, 64) or not np.isfinite(o).all():
                    raise SystemExit(f"request {i}, {label}: bad output or {n} kernel 1 launches")
                if label == "nhwc" and i == 0:
                    flash.check("channel-last request 0")
            _close(f"request {i}, channel-last vs NCHW (bf16)", outs[("nhwc", i)], outs[("nchw", i)], 5e-2)
        flash.check_variants("channel-last SD15 UNet")
        s32 = {label: _session(text, g.weights, "float32", "cuda:0", use_nhwc_layout=label == "nhwc")
               for label in ("nchw", "nhwc")}
        o32 = {}
        for label, s in s32.items():
            for k, v in reqs[0].items():
                s.add_tensor(k, v)
            f0 = flash_attention_packed.launches
            o32[label] = s.run()["out_sample"]
            n = flash_attention_packed.launches - f0
            nhwc += n if label == "nhwc" else 0
            if n != SD15_FLASH_PER_RUN:
                raise SystemExit(f"float32 {label}: {n} kernel 1 launches")
        out["float32_ratio"] = _close("request 0, channel-last vs NCHW (float32)", o32["nhwc"], o32["nchw"], 1e-3)
        del s32, o32
        # the VAE_SD decoder, one 64 x 64 latent -> 512 x 512, as phase_gn_routes decodes it
        vae = build_vae_decoder(dataclasses.replace(VAE_SD, sample=64), seed=2)
        z = np.random.default_rng(3).standard_normal((1, 4, 64, 64)).astype(np.float32)
        vsess, vouts = {}, {}
        for label in ("nchw", "nhwc"):
            s = vsess[label] = _session(vae.to_text(), vae.weights, "bfloat16", "cuda:0", use_nhwc_layout=label == "nhwc")
            s.add_tensor("latent", z)
            f0 = flash_attention_packed.launches
            vouts[label] = next(iter(s.run(device_outputs=True).values()))
            n = flash_attention_packed.launches - f0
            nhwc += n if label == "nhwc" else 0
            out["graph"][f"vae_{label}"] = _graph_counts(s)
            print(f"VAE_SD decode, {label}: graph {out['graph'][f'vae_{label}']}, kernel 1 launches {n}")
            if n != 1:
                raise SystemExit(f"VAE decode, {label}: kernel 1 did not run at the mid-block site")
        _close("VAE_SD decode, channel-last vs NCHW (bf16, the float output)", vouts["nhwc"].float().cpu(),
               vouts["nchw"].float().cpu(), 5e-2)
        d = np.abs(image_to_uint8(vouts["nhwc"][0]).astype(np.int32) - image_to_uint8(vouts["nchw"][0]).astype(np.int32))
        print(f"  VAE_SD image, channel-last vs NCHW: mean |diff| {d.mean():.4f}, max {d.max()} levels (bound: mean < 1)")
        if not d.mean() < 1.0:
            raise SystemExit("VAE decode: the channel-last image drifted from the NCHW one")
        # config A with the layout pass: its fused ops take NCHW through the pass's fallback
        a_nchw = _session(text, g.weights, "bfloat16", "cuda:0", **CONFIG_A)
        for k, v in reqs[0].items():
            a_nchw.add_tensor(k, v)
        want_a = a_nchw.run()["out_sample"]
        a_nhwc = _session(text, g.weights, "bfloat16", "cuda:0", use_nhwc_layout=True, **CONFIG_A)
        out["graph"]["nhwc_config_a"] = _graph_counts(a_nhwc)
        kinds = [op.op_type for op in a_nhwc.graph.ops]
        want_gn = {"gn_silu": kinds.count("ostpu.gn_silu"), "gn_silu_conv": kinds.count("ostpu.gn_silu_conv")}
        for k, v in reqs[0].items():
            a_nhwc.add_tensor(k, v)
        sites = {"gn_silu": _GraphSiteCheck(gn_silu, gn_silu_reference, 2e-2,
                                            lambda x, *r, **kw: f"x {tuple(x.shape)} strides {x.stride()}"),
                 "gn_silu_conv": _GraphSiteCheck(gn_silu_conv, gn_silu_conv_reference, 2e-2,
                                                 lambda x, *r, **kw: f"x {tuple(x.shape)} strides {x.stride()}")}
        standard.gn_silu, standard.gn_silu_conv = sites["gn_silu"], sites["gn_silu_conv"]
        gn_silu.launches = gn_silu_conv.launches = 0
        for site in sites.values():
            site.arm()
        f0 = flash_attention_packed.launches
        o = a_nhwc.run()["out_sample"]
        n = flash_attention_packed.launches - f0
        nhwc += n
        if n != SD15_FLASH_PER_RUN:
            raise SystemExit(f"channel-last config A: {n} kernel 1 launches")
        got_gn = {"gn_silu": gn_silu.launches, "gn_silu_conv": gn_silu_conv.launches}
        print(f"SD15 UNet, channel-last under config A: graph {out['graph']['nhwc_config_a']}, launches {got_gn} "
              f"(want {want_gn}: 16 and 45)")
        if got_gn != want_gn or want_gn != {"gn_silu": 16, "gn_silu_conv": 45}:
            raise SystemExit(f"channel-last config A: launches {got_gn}, want 16 and 45")
        for k, site in sites.items():
            site.check(f"channel-last config A, {k}")
        _close("channel-last config A vs NCHW config A (bf16)", o, want_a, 5e-2)
        out["config_a_launches"] = got_gn
        out["launches"] = nhwc
        print(f"channel-last runs: kernel 1 launches {nhwc} (NCHW runs in the same window "
              f"{flash_attention_packed.launches - nhwc}), kernels 7 / 8 under config A {got_gn}")
        # one channel-last run's calls of kernel 1 and of kernels 7 / 8 under config A (after the read)
        flash.calls = []
        sess["nhwc"].run()
        recorded = {"flash": flash.calls}
        flash.calls = None
        for site in sites.values():
            site.calls = []
        a_nhwc.run()
        for k, site in sites.items():
            recorded[k], site.calls = site.calls, None
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
        standard.gn_silu, standard.gn_silu_conv = gn_silu, gn_silu_conv
    out["replay"] = {
        "flash_attention_packed": replay_times(
            "flash_attention_packed over one channel-last UNet run (bf16)", recorded["flash"], flash_attention_packed,
            flash_attention_packed_reference, _packed_library, "bf16", name, cost=_packed_cost),
        "gn_silu": replay_times("gn_silu over one channel-last config-A run (bf16)", recorded["gn_silu"], gn_silu,
                                gn_silu_reference, _gn_library, "bf16", name, cost=_gn_cost),
        "gn_silu_conv": replay_times("gn_silu_conv over one channel-last config-A run (bf16)",
                                     recorded["gn_silu_conv"], gn_silu_conv, gn_silu_conv_reference,
                                     _gn_conv_library, "bf16", name, cost=_gn_conv_cost)}
    # device busy, wall and cuDNN's conversions per run, in turns (after the read of the counts)
    for label in ("nchw", "nhwc", "nhwc", "nchw"):
        bw = busy_and_wall(sess[label].run, f"SD15 UNet run, {label}", name, steps=5)
        prof = _layout_profile(sess[label].run, f"SD15 UNet run, {label}", name)
        out["unet"].setdefault(label, []).append({**bw, **prof})
    for label in ("nchw", "nhwc", "nhwc", "nchw"):
        step = lambda s=vsess[label]: s.run(device_outputs=True)
        bw = busy_and_wall(step, f"VAE_SD decode, {label}", name)
        prof = _layout_profile(step, f"VAE_SD decode, {label}", name)
        out["vae"].setdefault(label, []).append({**bw, **prof})
    for label, s in (("nchw_config_a", a_nchw), ("nhwc_config_a", a_nhwc), ("nhwc_config_a", a_nhwc),
                     ("nchw_config_a", a_nchw)):
        bw = busy_and_wall(s.run, f"SD15 UNet run, {label}", name, steps=5)
        out["unet"].setdefault(label, []).append({**bw, **_layout_profile(s.run, f"SD15 UNet run, {label}", name)})
    return out


class _HeadMajorShapes(_GraphSiteCheck):
    """Stands in for kernels/flash_attention.py's flash_attention, which the
    nopad route calls: the first call at every (shape, head dim) is held
    against the twin on the operands the route passed (head-major views of
    the packed tensors); ``seen`` maps the shape to (ok, max|diff|, about)."""

    def __init__(self, kernel, twin):
        # the twin returns a fresh tensor where the route passes ``out``
        super().__init__(kernel, lambda *a, out=None, **kw: twin(*a, **kw), 2e-2,
                         lambda *a, out=None, **kw: _about_flash(*a, **kw), rel=FLASH_REL_L2)
        self.seen = {}

    def __call__(self, q, k, v, *args, **kw):
        key = (tuple(q.shape), tuple(k.shape))
        first = key not in self.seen
        if first:
            self.arm()
        out = super().__call__(q, k, v, *args, **kw)
        if first:
            self.seen[key] = self.result
        return out


def _nopad_times(label: str, qh, kh, vh, kw: dict, name: str) -> dict:
    """Kernel 2 on head-major views, the whole nopad route (with its output
    copy), kernel 1 on the packed operands, SDPA, the twin and the bound, at
    one shape."""
    from onnxstream_tpu_torch.kernels import flash_attention as fa

    heads = qh.shape[1]
    kw = {k: v for k, v in kw.items() if k != "out"}  # each call below makes its own output
    q, k, v = (t.transpose(1, 2).flatten(2) for t in (qh, kh, vh))  # the packed tensors the views came from
    calls = {"kernel2_ms": lambda: fa.flash_attention(qh, kh, vh, **kw),
             "route_ms": lambda: fa.flash_attention_packed(q, k, v, heads, nopad=True, **kw),
             "kernel1_ms": lambda: fa.flash_attention_packed(q, k, v, heads, **kw),
             "sdpa_ms": lambda: _sdpa_packed(q, k, v, heads)}
    # one or two kernels a call: per-kernel mean durations (device_ms_per_call), in turns, the lower of two
    t = {}
    for key in list(calls) + list(reversed(calls)):
        ms = device_ms_per_call(calls[key])
        t[key] = min(t.get(key, ms), ms)
    t["plain_ms"] = device_ms(lambda: fa.flash_attention_reference(qh, kh, vh, **kw), iters=2, warmup=1)
    nbytes, ops, exps = _packed_cost(q, k, v, heads)
    t.update(bound(nbytes, ops, "bf16", exps))
    t["variant"] = fa.flash_variant(qh, kh, vh)
    print(f"  {label} {tuple(qh.shape)} ({t['variant']}): kernel 2 {t['kernel2_ms']:.4f} ms, the nopad route "
          f"{t['route_ms']:.4f}, kernel 1 {t['kernel1_ms']:.4f}, SDPA {t['sdpa_ms']:.4f}, twin {t['plain_ms']:.4f}, "
          f"bound {t['bound_ms']:.4f} ({t['bound_op']}) [{name}]")
    return t


def phase_nopad(name: str, sd: dict) -> dict:
    """flash_packed_nopad on the SD15 UNet, bf16 (module docstring, 15)."""
    from onnxstream_tpu_torch.kernels import flash_attention as fa
    from onnxstream_tpu_torch.models.sd.unet import SD15

    g, text, reqs = sd["graph"], sd["graph"].to_text(), _requests(SD15, 0)
    s = _session(text, g.weights, "bfloat16", "cuda:0", flash_packed_nopad=True)
    kernel2 = fa.flash_attention
    site = _HeadMajorShapes(kernel2, fa.flash_attention_reference)
    # the path: three requests; both flash counts zeroed just before it
    fa.flash_attention_packed.launches = 0
    kernel2.launches = 0
    fa.flash_attention = site
    packed = 0
    try:
        for i, req in enumerate(reqs):
            for k, v in req.items():
                s.add_tensor(k, v)
            k1, k2 = fa.flash_attention_packed.launches, kernel2.launches
            o, ms = _timed(lambda: s.run()["out_sample"])
            d1, d2 = fa.flash_attention_packed.launches - k1, kernel2.launches - k2
            packed += d1
            print(f"request {i}, flash_packed_nopad: {ms:.1f} ms, kernel 2 launches {d2}, kernel 1 launches {d1}")
            if (d1, d2) != (0, SD15_FLASH_PER_RUN):
                raise SystemExit(f"request {i}: kernel 1 / kernel 2 launches {d1} / {d2}, want 0 / 10")
            _close(f"request {i}, nopad vs the default run", o, sd["outs"][i], 5e-2)
        launches = kernel2.launches
        site.calls = []
        s.run()
        calls = site.calls
        site.calls = None
    finally:
        fa.flash_attention = kernel2
    for (qs, ks), (ok, err, about) in sorted(site.seen.items()):
        print(f"  kernel 2, first launch at q {qs} vs twin on the route's operands: max|diff| {err:.3e} "
              f"{'ok' if ok else 'FAIL'}; {about}")
    dims = sorted({qs[-1] for qs, _ in site.seen})
    if dims != [40, 80] or not all(r[0] for r in site.seen.values()):
        raise SystemExit(f"nopad path: kernel 2 met head dims {dims} (want 40, 80), or disagreed with its twin")
    out = {"launches": launches, "packed_launches": packed, "max_abs_err": max(r[1] for r in site.seen.values()),
           "by_shape": {}}
    shapes = {}
    for args, kw in calls:
        shapes.setdefault(tuple(args[0].shape), (args, kw))
    for shape, (args, kw) in sorted(shapes.items()):
        out["by_shape"][f"d{shape[-1]}"] = _nopad_times("nopad site", *args[:3], kw, name)
    # d = 160: the UNet's 16 x 16 level (256 tokens) is below the flash size predicate's 512 keys, so the
    # path does not reach it; kernel 2 at that site's shape on head-major views of packed operands
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn(1, 256, 8 * 160, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    qh, kh, vh = (t.unflatten(-1, (8, 160)).transpose(1, 2) for t in (q, k, v))
    got = kernel2(qh, kh, vh)
    ok, err, rel = _flash_agrees(got, fa.flash_attention_reference(qh, kh, vh), 2e-2)
    print(f"  kernel 2 at (1, 8, 256, 160) on head-major views ({fa.flash_variant(qh, kh, vh)}; not on the path): "
          f"max|diff| {err:.3e}, relative L2 {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("kernel 2 at d = 160 disagrees with its twin")
    out["max_abs_err"] = max(out["max_abs_err"], err)
    out["by_shape"]["d160"] = _nopad_times("d = 160 (not on the path)", qh, kh, vh, {}, name)
    default = _session(text, g.weights, "bfloat16", "cuda:0")
    for k, v in reqs[0].items():
        default.add_tensor(k, v)
    out["unet"] = {}
    for label, sess in (("default", default), ("nopad", s), ("nopad", s), ("default", default)):
        out["unet"].setdefault(label, []).append(busy_and_wall(sess.run, f"SD15 UNet run, {label}", name, steps=5))
    return out


def phase_fp16_storage(name: str, sd: dict) -> dict:
    """force_fp16_storage on the SD15 UNet in float32 compute (module docstring, 16)."""
    import onnxstream_tpu_torch.ops.attention as attention_op
    from onnxstream_tpu_torch.kernels.flash_attention import (flash_attention_packed,
                                                              flash_attention_packed_reference)
    from onnxstream_tpu_torch.models.sd.unet import SD15

    g, text, reqs = sd["graph"], sd["graph"].to_text(), _requests(SD15, 0)
    out: dict = {}
    flash = _FlashSites(flash_attention_packed, flash_attention_packed_reference, 1e-4)
    # the path: three requests with float16 storage, then three on the pre-rounded float32 weights, then the
    # streamed run; kernel 1's count is zeroed just before it, and out["launches"] adds up its launches in the
    # float16-storage runs only
    flash_attention_packed.launches = 0
    out["launches"] = 0
    attention_op.flash_attention_packed = flash
    try:
        runs = {}
        for label, opts in (("fp16_storage", dict(force_fp16_storage=True)), ("float32_rounded", {})):
            weights = g.weights
            if label == "float32_rounded":
                # the weights the float16 session stores rounded: its streamed arguments (a scalar that a
                # fusion pass folds into an op's attributes stays float32 in both)
                args = {w.name for w in runs["fp16_storage"]["session"]._executor().plan.arg_weights}
                weights = {k: (v.astype(np.float16).astype(np.float32) if k in args and v.dtype == np.float32
                               else v) for k, v in g.weights.items()}
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            flash.peak = 0
            s = _session(text, weights, "float32", "cuda:0", **opts)
            res = []
            for i, req in enumerate(reqs):
                for k, v in req.items():
                    s.add_tensor(k, v)
                if i == 0:
                    flash.arm()
                f0 = flash_attention_packed.launches
                o, ms = _timed(lambda: s.run()["out_sample"])
                res.append(o)
                n = flash_attention_packed.launches - f0
                out["launches"] += n if label == "fp16_storage" else 0
                print(f"request {i}, {label}: {ms:.1f} ms, kernel 1 launches {n}")
                if n != SD15_FLASH_PER_RUN or not np.isfinite(o).all():
                    raise SystemExit(f"{label} request {i}: bad output or kernel 1 launch count")
                if i == 0:
                    flash.check(f"{label} request 0")
            acc = s._executor().hbm_accounting()
            peak = max(flash.peak, torch.cuda.max_memory_allocated()) - a0
            runs[label] = {"session": s, "outs": res, "allocated": torch.cuda.memory_allocated() - a0,
                           "weight_bytes": acc["weight_bytes"], "peak": peak, "bound": acc["peak_bytes"]}
            print(f"{label}: resident weight bytes {acc['weight_bytes'] / 1e9:.4f} GB (hbm_accounting), allocator "
                  f"{runs[label]['allocated'] / 1e9:.4f} GB held after the runs, peak {peak / 2**20:.1f} MiB vs bound "
                  f"{acc['peak_bytes'] / 2**20:.1f} MiB + {PEAK_SLACK >> 20} [{name}]")
            if peak > acc["peak_bytes"] + PEAK_SLACK:
                raise SystemExit(f"{label}: peak above hbm_accounting()'s bound")
        # one run's 10 calls of kernel 1 (its float32 fma form), after the read of the count
        flash.calls = []
        runs["fp16_storage"]["session"].run()
        calls, flash.calls = flash.calls, None
    finally:
        attention_op.flash_attention_packed = flash_attention_packed
    out["replay"] = replay_times("flash_attention_packed over one float32 run with fp16 storage", calls,
                                 flash_attention_packed, flash_attention_packed_reference, _packed_library, "f32",
                                 name, cost=_packed_cost)
    for i in range(len(reqs)):
        _close(f"request {i}, fp16 storage vs float32 storage of float16-rounded weights",
               runs["fp16_storage"]["outs"][i], runs["float32_rounded"]["outs"][i], 1e-4)
    for key in ("weight_bytes", "allocated"):
        r = runs["fp16_storage"][key] / runs["float32_rounded"][key]
        print(f"  {key}: fp16 storage / float32 storage = {r:.4f} (bound 0.45-0.55)")
        if not 0.45 <= r <= 0.55:
            raise SystemExit(f"fp16 storage: {key} not about half of float32 storage's")
        out[f"{key}_ratio"] = r
    out.update({k: {kk: v for kk, v in runs[k].items() if kk not in ("session", "outs")} for k in runs})
    s32 = runs["float32_rounded"].pop("session")
    # request 0's outputs: the streamed run below takes request 0's inputs
    want0 = {k: runs[k]["outs"][0] for k in ("fp16_storage", "float32_rounded")}
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    # the streamed run at 512 MiB: segments, bytes, peak against the bound
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = _session(text, g.weights, "float32", "cuda:0", force_fp16_storage=True, hbm_budget_bytes=STREAM_BUDGETS[0])
    for k, v in reqs[0].items():
        st.add_tensor(k, v)
    flash_attention_packed.launches = 0
    o = st.run()["out_sample"]
    n = flash_attention_packed.launches
    out["launches"] += n
    if n != SD15_FLASH_PER_RUN:
        raise SystemExit(f"fp16 storage streamed: {n} kernel 1 launches")
    acc = st._executor().hbm_accounting()
    peak = torch.cuda.max_memory_allocated() - a0
    print(f"fp16 storage streamed at {STREAM_BUDGETS[0] >> 20} MiB: {acc['segments']} segments, "
          f"{acc['weight_bytes'] / 1e9:.4f} GB a run, peak {peak / 2**20:.1f} MiB vs bound "
          f"{acc['peak_bytes'] / 2**20:.1f} MiB + {PEAK_SLACK >> 20} [{name}]")
    if acc["segments"] < 2 or peak > acc["peak_bytes"] + PEAK_SLACK:
        raise SystemExit("fp16 storage streamed: one segment, or the peak above the bound")
    _close("streamed fp16 storage vs the resident one, request 0", o, want0["fp16_storage"], 1e-4)
    _close("streamed fp16 storage vs float32 storage of float16-rounded weights, request 0", o,
           want0["float32_rounded"], 1e-4)
    print(f"fp16 storage path: kernel 1 launches {out['launches']} (3 resident requests and the streamed run)")
    out["streamed"] = {"segments": acc["segments"], "weight_bytes": acc["weight_bytes"], "peak": peak,
                       "bound": acc["peak_bytes"]}
    s16 = _session(text, g.weights, "float32", "cuda:0", force_fp16_storage=True)
    for k, v in reqs[0].items():
        s16.add_tensor(k, v)
        s32.add_tensor(k, v)
    out["times"] = {}
    for label, sess in (("float32_rounded", s32), ("fp16_storage", s16), ("fp16_storage", s16),
                        ("float32_rounded", s32), ("fp16_storage_streamed", st)):
        out["times"].setdefault(label, []).append(busy_and_wall(sess.run, f"SD15 UNet run float32, {label}", name))
    return out


def _export_onnx_fp16(model, lat: int = 64, ctx_len: int = 77, ctx_d: int = 768) -> bytes:
    """torch.onnx.export (TorchScript exporter) of a float16 module on its
    device, to bytes: the 860 M UNet's 1.72 GB stays under protobuf's 2 GiB,
    where float32's 3.44 GB does not. Opset 17, so that LayerNorm exports as
    LayerNormalization: at opset 14 the exporter casts a float16 LayerNorm's
    input to float64, a dtype both converters refuse. The exporter's last
    step adds onnxscript functions through the `onnx` package; the model has
    none, so that step is made the identity where the exporter's module is
    found."""
    import importlib
    import importlib.util
    import io

    for parent in ("torch.onnx._internal.torchscript_exporter", "torch.onnx._internal"):
        if importlib.util.find_spec(parent) is not None and importlib.util.find_spec(parent + ".onnx_proto_utils"):
            importlib.import_module(parent + ".onnx_proto_utils")._add_onnxscript_fn = lambda b, _opsets: b
            break
    p = next(model.parameters())
    sample = torch.zeros(1, 4, lat, lat, device=p.device, dtype=p.dtype)
    timestep = torch.zeros(1, device=p.device, dtype=p.dtype)
    context = torch.zeros(1, ctx_len, ctx_d, device=p.device, dtype=p.dtype)
    buf = io.BytesIO()
    torch.onnx.export(model.eval(), (sample, timestep, context), buf,
                      input_names=["sample", "timestep", "encoder_hidden_states"],
                      output_names=["out_sample"], opset_version=17, dynamo=False)
    return buf.getvalue()


def _device_time_embedding(model) -> None:
    """SDUNet's sinusoidal embedding made on the timestep's device, its
    frequencies rounded to float16 as the float16 export holds them: the
    exported graph and the float32 oracle then compute the same function."""
    import math

    half = model.ch[0] // 2

    def time_embedding(t):
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        ang = t[:, None] * freqs.half().to(t.dtype)[None]
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)

    model.time_embedding = time_embedding


def phase_convert(name: str) -> dict:
    """tools/torch_sd_unet.py SDUNet(width=1.0) exported in float16 on the card, converted by the port's
    onnx2txt, run through the port's Session in float32 (module docstring, 17)."""
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.convert.onnx2txt import convert, mangle_name
    from onnxstream_tpu_torch.kernels.flash_attention import flash_attention_packed
    from onnxstream_tpu_torch.runtime.executor import reference_precision

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from torch_sd_unet import SDUNet, param_count

    out: dict = {}
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = SDUNet(width=1.0).eval()
    out["params_m"] = param_count(model) / 1e6
    model = model.half().cuda()
    _device_time_embedding(model)
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        onnx_bytes = _export_onnx_fp16(model)
    out["export_s"], out["onnx_bytes"] = time.perf_counter() - t0, len(onnx_bytes)
    print(f"SDUNet {out['params_m']:.1f} M params (built in {out['build_s']:.1f} s): float16 export on the card "
          f"{out['export_s']:.1f} s, {out['onnx_bytes'] / 1e9:.3f} GB [{name}]")
    folder = tempfile.mkdtemp(prefix="ostt_convert_")
    try:
        t0 = time.perf_counter()
        text = convert(onnx_bytes, os.path.join(folder, "unet"))
        out["convert_s"] = time.perf_counter() - t0
        del onnx_bytes
        out["model_txt_ops"] = len(text.splitlines())
        print(f"converted by the port's onnx2txt in {out['convert_s']:.1f} s: {out['model_txt_ops']} ops")
        s = Session(SessionConfig(compute_dtype="float32"), weights_provider_name="ram+prefetch")
        s.read_file(os.path.join(folder, "unet", "model.txt"))
        kinds = [op.op_type for op in s.graph.ops]
        out["fused_ops"], out["sdpa"] = len(kinds), kinds.count("ostpu.sdpa")
        out["softmax_left"] = kinds.count("Softmax")
        print(f"  Session graph: {out['fused_ops']} ops after fusion, {out['sdpa']} ostpu.sdpa, "
              f"{out['softmax_left']} Softmax left unfused")
        rng = np.random.RandomState(1)
        inputs = {"sample": rng.randn(1, 4, 64, 64).astype(np.float32), "timestep": np.array([500.0], np.float32),
                  "encoder_hidden_states": rng.randn(1, 77, 768).astype(np.float32)}
        for k, v in inputs.items():
            s.add_tensor(mangle_name(k), v)
        flash_attention_packed.launches = 0
        ours, ms1 = _timed(lambda: s.run()[mangle_name("out_sample")])
        ours2, ms2 = _timed(lambda: s.run()[mangle_name("out_sample")])
        out["launches"] = flash_attention_packed.launches
        out["first_run_ms"], out["second_run_ms"] = ms1, ms2
        print(f"  first run (plan, weights read and uploaded) {ms1:.0f} ms, second {ms2:.1f} ms, kernel 1 launches "
              f"{out['launches']} [{name}]")
        if not np.array_equal(ours, ours2):
            raise SystemExit("converted UNet: two runs disagree")
        s.close()
        del s
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    # the oracle: the same module, its float16-rounded weights in float32, on the card, TF32 off
    model = model.float()
    with torch.no_grad(), reference_precision():
        ref = model(*(torch.from_numpy(v).cuda() for v in inputs.values())).cpu().numpy()
    del model
    rel = float(np.abs(ours - ref).max() / np.abs(ref).max())
    out["rel"] = rel
    print(f"  converted 860 M UNet vs the torch oracle: max|diff| {np.abs(ours - ref).max():.4e}, max|ref| "
          f"{np.abs(ref).max():.4f}, rel {rel:.4e} (bound 5e-3) [{name}]")
    if not (ours.shape == (1, 4, 64, 64) and np.isfinite(ours).all() and rel < 5e-3):
        raise SystemExit("converted UNet: outside the bound of the torch oracle")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    name = phase_device()
    phase_build()
    kernel = phase_kernel(name)
    kernel_hm = phase_kernel_head_major(name)
    q_sites = phase_kernel_q(name)
    phase_kernel_qlinear(name)
    gn_sites = phase_kernel_gn(name)
    sd = phase_slice(name)
    launches_sd = sd["launches"]
    gn = phase_gn_routes(name, sd)
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    layout = phase_layout(name, sd)
    gc.collect()
    torch.cuda.empty_cache()
    nopad = phase_nopad(name, sd)
    gc.collect()
    torch.cuda.empty_cache()
    fp16 = phase_fp16_storage(name, sd)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase_layout, phase_nopad, phase_fp16_storage: {time.perf_counter() - t_new:.1f} s")
    sd_u8 = phase_sd_u8(name, sd)
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    sd_image = phase_sd_image(name)
    gc.collect()
    torch.cuda.empty_cache()
    sdxl = phase_sdxl(name)
    sd_batch = phase_sd_batch(name)
    llm = phase_llm(name)
    launches_llm = llm["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    llm_int8 = phase_llm_int8(name, llm)
    gc.collect()
    torch.cuda.empty_cache()
    whisper = phase_whisper(name)
    ops = phase_ops(name)
    yolo = phase_yolo(name)
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    convert = phase_convert(name)
    print(f"phase_convert: {time.perf_counter() - t_new:.1f} s")
    folder = tempfile.mkdtemp(prefix="ostt_sd15_")
    try:
        model = write_sd15_folder(folder)
        streamed = phase_streamed(name, model)
        served = phase_serve(name, model, streamed.pop("resident"))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"streaming: {json.dumps(streamed['sessions'])}")
    print(f"serving: {json.dumps(served)}")
    print(f"whisper: {json.dumps({k: v for k, v in whisper.items() if k.startswith(('tokens', 'peak', 'device_w', 'bf16'))})}")
    print(f"op cases: {json.dumps(ops)}; yolo stand-in: {json.dumps(yolo)}")
    print(f"channel-last: {json.dumps({k: layout[k] for k in ('graph', 'unet', 'vae', 'float32_ratio')})}")
    print(f"fp16 storage: {json.dumps({k: v for k, v in fp16.items() if k not in ('launches', 'replay')})}")
    print(f"converted 860 M UNet: {json.dumps(convert)}")
    print(f"card: {name}")
    fa_src = "onnxstream_tpu_torch/kernels/csrc/flash_attention.cu"
    q_src = "onnxstream_tpu_torch/kernels/csrc/qmatmul.cu"
    ql_src = "onnxstream_tpu_torch/kernels/csrc/qlinear.cu"
    gn_src = "onnxstream_tpu_torch/kernels/csrc/gn_conv.cu"
    q_py = "onnxstream_tpu/kernels/qmatmul.py"
    print(json.dumps({"kernels": [
        {"name": "flash_attention_packed", "route": "cuda", "source": fa_src,
         "replaces": "onnxstream_tpu/kernels/flash_attention.py:260", **kernel,
         "launches": (sd_image["flash_launches"] + sdxl["launches"] + sd_batch["launches"] + whisper["launches"]
                      + streamed["launches"] + served["launches"] + layout["launches"] + fp16["launches"]
                      + nopad["packed_launches"] + convert["launches"]),
         "launches_by_path": {"sd15_step": launches_sd, "sd15_image": sd_image["flash_launches"],
                              "sdxl_image_and_turbo": sdxl["launches"], "sd15_generate_batch4": sd_batch["launches"],
                              "whisper": whisper["launches"], "sd15_streamed": streamed["launches"],
                              "sd15_served": served["launches"], "sd15_nhwc": layout["launches"],
                              "sd15_fp16_storage": fp16["launches"], "sd15_nopad": nopad["packed_launches"],
                              "sd15_converted": convert["launches"]},
         "whisper": {k: whisper[k] for k in ("sites_bfloat16", "replay_bfloat16", "sites_float32", "replay_float32",
                                             "times", "on_device")},
         "sdxl": {"unet_run_replay": sdxl["replay"], "ms_by_shape": sdxl["ms_by_shape"], "unet": sdxl["unet"],
                  "device_weight_bytes": sdxl["device_weight_bytes"]},
         "sd15_batch4": sd_batch, "sd15_nhwc_replay": layout["replay"]["flash_attention_packed"],
         "sd15_fp16_storage_replay": fp16["replay"]},
        {"name": "flash_attention", "route": "cuda", "source": fa_src,
         "replaces": "onnxstream_tpu/kernels/flash_attention.py:366", **kernel_hm,
         "launches": launches_llm + nopad["launches"],
         "launches_by_path": {"tinyllama": launches_llm, "sd15_nopad": nopad["launches"]},
         "sd15_nopad": {k: nopad[k] for k in ("by_shape", "unet", "max_abs_err")}, **llm["flash"]},
        {"name": "w8a8_dyn_matmul", "route": "cuda", "source": q_src, "replaces": f"{q_py}:332", **llm_int8,
         "ms_by_shape": q_sites},
        {"name": "w8_matmul", "route": "cuda", "source": q_src, "replaces": f"{q_py}:186", **sd_u8},
        {"name": "qmatmul", "route": "cuda", "source": ql_src, "replaces": f"{q_py}:73", **sd_image["qmatmul"]},
        {"name": "qconv", "route": "cuda", "source": ql_src, "replaces": "onnxstream_tpu/kernels/qconv.py:68",
         **sd_image["qconv"]},
        {"name": "gn_silu", "route": "cuda", "source": gn_src, "replaces": "onnxstream_tpu/kernels/gn_silu.py:121",
         **gn["gn_silu"], "ms_by_shape": gn_sites["gn_silu"],
         "launches": gn["gn_silu"]["launches"] + layout["config_a_launches"]["gn_silu"],
         "sd15_nhwc_config_a_replay": layout["replay"]["gn_silu"],
         "launches_by_path": {"gn_routes": gn["gn_silu"]["launches"],
                              "sd15_nhwc_config_a": layout["config_a_launches"]["gn_silu"]}},
        {"name": "gn_silu_conv", "route": "cuda", "source": gn_src,
         "replaces": "onnxstream_tpu/kernels/gn_conv.py:178", **gn["gn_silu_conv"],
         "ms_by_shape": gn_sites["gn_silu_conv"],
         "launches": gn["gn_silu_conv"]["launches"] + layout["config_a_launches"]["gn_silu_conv"],
         "sd15_nhwc_config_a_replay": layout["replay"]["gn_silu_conv"],
         "launches_by_path": {"gn_routes": gn["gn_silu_conv"]["launches"],
                              "sd15_nhwc_config_a": layout["config_a_launches"]["gn_silu_conv"]}},
        {"name": "matmul", "route": "cuda", "source": "onnxstream_tpu_torch/kernels/csrc/matmul.cu",
         "replaces": "onnxstream_tpu/kernels/matmul.py:74", **gn["matmul"], "ms_by_shape": gn_sites["matmul"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stable Diffusion pipeline: prompt -> latents -> image.

Counterpart of ``onnxstream_tpu/models/sd/pipeline.py`` for SD1.5, SDXL and
SDXL Turbo, building the port's ``Session`` (reference src/sd.cpp):

  * prompt_solve: per-77-token-chunk CLIP runs with A1111 weighting and mean
    renormalization (sd.cpp:2035-2230); SDXL's two encoders (CLIP-L and
    CLIP-bigG), their penultimate states concatenated and encoder 2's pooled
    output (``encode_prompt_xl``, sd.cpp:2543-2663);
  * the diffusion loop: the CompVis CFG denoiser (c_in / c_out scalings,
    sigma_to_t, eps -> denoised, uncond + scale * (cond - uncond), each SDXL
    branch with its own pooled embeds; Turbo runs the cond branch alone;
    sd.cpp:1397-1558) with any of the 22 samplers on the host (``generate``),
    or, for euler and euler_a, on the device (``generate_on_device``, JAX's
    ``lax.scan``): a step (the UNet runs, CFG, the update) is one
    ``DeviceProgram`` over static buffers read at a device step counter, the
    per-step scalars and the ancestral noise computed on the host as the JAX
    package does; on a card it is captured into one CUDA graph and replayed
    once a step. No step waits for the host. A pipeline built with
    a batch-2 UNet (``from_synthetic(batch=2)``) runs the CFG pair as ONE
    batch-2 UNet run a step, row 0 cond and row 1 uncond, in both loops;
    otherwise two batch-1 runs a step;
  * ``generate_batch``: N prompts through a batch-N UNet, each image's
    sampler on its own seed; multi-stage samplers run in N threads in
    lockstep and a barrier stacks their denoiser calls into one batched run;
  * the VAE decode: plain (1 / 0.18215 scaling, SDXL 1 / 0.13025) or tiled
    with linear blend ramps (sd.cpp:1258-1346), the tile grid, the blend and
    the uint8 mapping one ``DeviceProgram`` (one CUDA graph on a card); a
    ``vae_decoder_qu8`` folder with its ``range_data.txt`` runs the
    calibrated W8A8 decoder (``decoder_solver``, sd.cpp:1214-1241);
  * latents save / load (--save-latents / --decode-latents) and the 4x3
    latent -> RGB previews (sd.cpp:910-1029).

``from_synthetic(on_device=True)`` keeps the builders' big weights as
``LazyArray`` placeholders and has every session generate them on the device
(``SessionConfig.synthetic_device_weights``): the full-size SDXL pipeline
never materializes on the host. Timing-valid, numerically meaningless.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from onnxstream_tpu_torch.models.sd import samplers as S
from onnxstream_tpu_torch.models.sd import scheduler as sched
from onnxstream_tpu_torch.models.sd.rng import randn_4_w_h
from onnxstream_tpu_torch.models.sd.tokenizer import ClipTokenizer, apply_multipliers
from onnxstream_tpu_torch.runtime.config import SessionConfig
from onnxstream_tpu_torch.runtime.executor import (CapturedGraph, Executor, capture_graph, capture_problem,
                                                   segment_fn_problem)
from onnxstream_tpu_torch.runtime.quantization import RangeData
from onnxstream_tpu_torch.runtime.session import Session, share_graph_pool
from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

SD_LATENT_RGB_PROJ = np.array(
    [
        [0.3512, 0.2297, 0.3227],
        [0.3250, 0.4974, 0.2350],
        [-0.2829, 0.1762, 0.2721],
        [-0.2120, -0.2616, -0.7177],
    ],
    np.float32,
)
# reference sdxl_preview (src/sd.cpp:975-979, from ComfyUI latent_formats)
SDXL_LATENT_RGB_PROJ = np.array(
    [
        [0.3651, 0.4232, 0.4341],
        [-0.2533, -0.0042, 0.1068],
        [0.1076, 0.1111, -0.0362],
        [-0.3165, -0.2492, -0.2188],
    ],
    np.float32,
)
SDXL_TIME_IDS = np.array([[1024, 1024, 0, 0, 1024, 1024]], np.float32)
VAE_SCALE = 0.18215  # 1/5.48998 (reference src/sd.cpp:2359)
VAE_SCALE_XL = 0.13025  # 1/7.67754 (reference src/sd.cpp:2360)

Latents = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class GenerationResult:
    image: Optional[np.ndarray]  # (H, W, 3) uint8
    latents: np.ndarray  # (4, h, w) float32
    previews: List[np.ndarray]
    # full per-step VAE decodes (--decode-steps, reference src/sd.cpp:1745-1768)
    step_images: List[np.ndarray] = dataclasses.field(default_factory=list)


def latent_to_rgb(sample: np.ndarray, proj: np.ndarray = SD_LATENT_RGB_PROJ) -> np.ndarray:
    """(4,h,w) latents -> (h,w,3) uint8 preview (reference sd_preview,
    src/sd.cpp:910-1029)."""
    rgb = np.einsum("chw,ck->hwk", sample.astype(np.float32), proj)
    rgb = (rgb + 1.0) * 127.5
    return np.clip(rgb, 0, 255).astype(np.uint8)


def upscale8x(img: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(img, 8, axis=0), 8, axis=1)


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    x = (img.float().permute(1, 2, 0) + 1.0) * 127.5
    return x.clamp_(0, 255).to(torch.uint8)


def image_to_uint8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) float32 decoder output in [-1, 1] -> (H, W, 3) uint8, as the
    JAX pipeline maps it: ``(x + 1) * 127.5``, clipped, truncated."""
    return _to_uint8(img).cpu().numpy()


def _first4d(out: Dict[str, object]):
    return next(v for v in out.values() if v.ndim == 4)


def step_stack(steps: int, seed: int, sampler: str, turbo: bool, latw: int,
               lath: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The starting latents and the per-step stack of ``generate_on_device``,
    as the JAX package builds them (``generate_on_device``): for each step
    the timestep ``ts``, the scalings ``c_in`` and ``c_out``, the update's
    ``slope`` and ``up`` as (steps,) float32 and the ancestral ``noise`` as
    (steps, 4, h, w) float32 (zeros for euler), exactly as the host sampler
    consumes them (``samplers.py`` euler / euler_a)."""
    sigma = sched.sigma_schedule(steps)
    x0 = np.asarray(randn_4_w_h(seed % 1000, latw, lath) * sigma[0], np.float32)
    state = S.SamplerState(sampler, steps, seed=seed, turbo=turbo)
    rows: Dict[str, list] = {k: [] for k in ("ts", "c_in", "c_out", "slope", "up", "noise")}
    for i in range(steps):
        s_cur = float(sigma[i])
        c_in, c_out = sched.get_scalings(s_cur)
        rows["c_in"].append(c_in)
        rows["c_out"].append(c_out)
        rows["ts"].append(sched.sigma_to_t(s_cur))
        if sampler == "euler_a":
            up, down = S._ancestral_sigmas(s_cur, float(sigma[i + 1]))
            rows["noise"].append(state.noise(latw, lath))
            rows["slope"].append((down - s_cur) / s_cur)
            rows["up"].append(up)
        else:
            si1 = S._reshaper(float(sigma[i + 1]), i, steps, turbo)
            rows["noise"].append(np.zeros_like(x0))
            rows["slope"].append((si1 - s_cur) / s_cur)
            rows["up"].append(0.0)
    stack = {k: np.asarray(v, np.float32) for k, v in rows.items() if k != "noise"}
    stack["noise"] = np.stack(rows["noise"]).astype(np.float32)
    return x0, stack


def program_problem(ex: Executor) -> Optional[str]:
    """Why a device program whose body runs ``ex`` is not captured into one
    CUDA graph, or None: ``capture_problem`` (the CPU, a mesh, the per-op
    interpreter), then ``segment_fn_problem`` (streamed weights, pipeline
    stages: the body then calls ``Session.run``, whose segment graphs a
    graph around it cannot hold, and whose weights the host refills between
    them)."""
    return capture_problem(ex) or segment_fn_problem(ex)


class DeviceProgram:
    """A pipeline's device program: ``body()`` over static device buffers,
    the counterpart of a JAX program jitted around ``Executor._segment_fn``
    (``generate_on_device``'s scan step, ``_decode_tiled``'s tile grid). It
    runs as an executor runs its segment: the first run goes op by op (the
    warm-up: kernels built, plans chosen, constants uploaded); where
    ``program_problem(ex)`` is None (``ex``: the executor whose segment
    function the body calls) the second captures the body into one CUDA
    graph (``capture_graph``, the pipeline's shared pool), and later runs
    replay it. A change of the executor's scalar options drops the graph, as
    the executor drops its own. ``what`` and ``segment`` name the program
    and the model in a failed capture, which raises."""

    def __init__(self, what: str, segment: str, sess: Session, ex: Executor, body: Callable[[], Any],
                 static: Dict[str, torch.Tensor], holds: tuple = ()):
        self.what, self.segment, self.sess, self.ex, self.body = what, segment, sess, ex, body
        self.static, self.holds = static, holds
        self.graph: Optional[CapturedGraph] = None
        self.captures = 0
        self._warm_key: Optional[tuple] = None
        self._graph_key: Optional[tuple] = None

    def run(self, eager: bool = False):
        """One run of the body: a replay, the capture and a replay, or (with
        ``eager``, or where the executor cannot be captured) op by op."""
        key = self.ex._dispatch_key()
        if self.graph is not None and self._graph_key != key:
            self.graph = None  # captured under other options: warm up again
        if not eager and self.graph is None and self._warm_key == key and program_problem(self.ex) is None:
            self.ex._dispatching = None
            self.graph = capture_graph(self.body, self.ex.device, self.ex.graph_pool, self.what, self._failed_at,
                                       static=self.static.values(), holds=self.holds)
            self._graph_key, self.captures = key, self.captures + 1
        if not eager and self.graph is not None:
            self.graph.replay()
            return self.graph.outputs
        out = self.body()
        self._warm_key = key
        return out

    def alive(self) -> bool:
        """Whether the session still runs the executor (a changed option
        drops its plans)."""
        return any(e is self.ex for e in self.sess._executors.values())

    def _failed_at(self) -> str:
        site = self.ex.dispatch_site()
        return f"outside {self.segment}'s ops" if site is None else f"in {self.segment} {site}"


def _segment_caller(ex: Executor, in_dims: Optional[Dict[str, int]] = None
                    ) -> Tuple[Callable[[Dict[str, torch.Tensor]], torch.Tensor], tuple]:
    """``acts -> the first 4-D output as float32``, through
    ``ex.segment_fn(0)`` over the executor's resident weights (uploaded
    here, on the first call): what ``Session.run(device_outputs=True)``
    computes for an executor without a ``segment_fn_problem``; and what a
    graph of it reads (the weights, their quantization vectors). With
    ``in_dims`` the segment function is vmapped over those inputs
    (``ex.vmap_segment_fn``, JAX's ``jax.vmap``): the examples' outputs come
    stacked, (V, 1, C, H, W)."""
    fn = ex.segment_fn(0) if in_dims is None else ex.vmap_segment_fn(in_dims)
    rank = 4 if in_dims is None else 5
    seg = ex.segments[0]
    resident = ex._fetch_segment_weights(seg, 0)
    weights = [resident[w.name] for w in seg.weight_args]

    def call(acts: Dict[str, torch.Tensor]) -> torch.Tensor:
        return next(v for v in fn(weights, acts).values() if v.ndim == rank).float()

    return call, (weights, [w.quant for w in seg.weight_args])


def _run_device(sess: Session, device: torch.device) -> torch.Tensor:
    """The session's 4-D output as a float32 tensor on ``device``: a device
    output as it is, or the host array of an eager run (ops_printf,
    ops_times_printf and calibration run eagerly) moved there."""
    out = _first4d(sess.run(device_outputs=True))
    return torch.as_tensor(out).to(device).float()


class StableDiffusionPipeline:
    def __init__(
        self,
        text_encoder: Session,
        unet: Session,
        vae_decoder: Optional[Session],
        tokenizer: ClipTokenizer,
        latent_hw: Tuple[int, int] = (64, 64),
        context_dim: int = 768,
        vae_tile_session: Optional[Session] = None,
        device: Optional[torch.device] = None,
        turbo: bool = False,
        text_encoder_2: Optional[Session] = None,
        xl: bool = False,
    ):
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.unet = unet
        self.vae_decoder = vae_decoder
        self.vae_tile_session = vae_tile_session
        self.tokenizer = tokenizer
        self.lath, self.latw = latent_hw
        self.context_dim = context_dim
        self.turbo = turbo
        self.xl = xl
        self.vae_scale = VAE_SCALE_XL if xl else VAE_SCALE
        self.device = torch.device(unet.config.device) if device is None else torch.device(device)
        # the sessions run one at a time: their captured graphs share one pool
        share_graph_pool((text_encoder, text_encoder_2, unet, vae_decoder, vae_tile_session), self.device)

    # ----------------------------------------------------------- constructors
    @classmethod
    def from_synthetic(cls, tiny: bool = True, seed: int = 0, compute_dtype: str = "float32",
                       device: Optional[torch.device] = None, xl: bool = False, turbo: bool = False,
                       batch: int = 1, on_device: bool = False):
        """Architecture-faithful graphs with random weights from ``seed``:
        CLIP-L, the SD15 UNet and VAE_SD, or for ``xl`` CLIP-L + CLIP-bigG
        and the SDXL UNet (``tiny``: their TINY configs), the VAE at the
        UNet's latent and its half-size tile decoder: the same graphs and
        weights as the JAX package's ``from_synthetic``. ``batch``: the UNet's
        batch (2 runs the CFG pair as one run, N serves ``generate_batch``).
        ``on_device``: the big weights stay ``LazyArray`` placeholders and are
        generated on the device (``synthetic_device_weights``, each session
        seeded from its builder's seed). ``device=None`` is the first CUDA
        card."""
        from onnxstream_tpu_torch.models.sd.clip import CLIP_BIGG, CLIP_L, CLIP_TINY, CLIP_TINY_G, build_text_encoder
        from onnxstream_tpu_torch.models.sd.unet import SD15, SDXL, TINY, TINY_XL, build_unet
        from onnxstream_tpu_torch.models.sd.vae import VAE_SD, VAE_TINY, build_vae_decoder

        ccfg = CLIP_TINY if tiny else CLIP_L
        ccfg2 = (CLIP_TINY_G if tiny else CLIP_BIGG) if xl else None
        ucfg = (TINY_XL if tiny else SDXL) if xl else (TINY if tiny else SD15)
        vcfg = VAE_TINY if tiny else VAE_SD

        def mk(build, builder_seed, *args, **kw):
            builder = build(*args, seed=builder_seed, lazy_weights=on_device, **kw)
            s = Session(
                config=SessionConfig(compute_dtype=compute_dtype, fuse_ops_in_attention=True, device=device,
                                     synthetic_device_weights=on_device),
                weights_provider=DictWeightsProvider(params_from_numpy(builder.weights)),
            )
            s.read_string(builder.to_text())
            return s

        te = mk(build_text_encoder, seed, ccfg)
        te2 = mk(build_text_encoder, seed + 7, ccfg2) if ccfg2 else None
        un = mk(build_unet, seed + 1, ucfg, batch=batch)
        lat = ucfg.sample_size
        vd = mk(build_vae_decoder, seed + 2, dataclasses.replace(vcfg, sample=lat))
        # tile decoder: same weights (identical builder stream), tile-sized
        # input: the synthetic analog of the reference's *_l32 model
        tile_sz = max(lat // 2, 4)
        vt = mk(build_vae_decoder, seed + 2, dataclasses.replace(vcfg, sample=tile_sz))
        # tiny test vocab: a-z single letters plus common words (ids < 1000)
        vocab = {chr(ord("a") + i) + "</w>": 10 + i for i in range(26)}
        for i, w in enumerate(["cat", "dog", "photo", "of", "fluffy", "horse", "astronaut", "riding", "mars",
                               "on", "the", "an"]):
            vocab[w + "</w>"] = 40 + i
        vocab[",</w>"] = 267
        tok = ClipTokenizer(vocab, merges=None)
        pipe = cls(te, un, vd, tok, latent_hw=(lat, lat), context_dim=ucfg.cross_attention_dim,
                   vae_tile_session=vt, turbo=turbo, text_encoder_2=te2, xl=xl)
        pipe._tile_size = tile_sz
        pipe._clip_seq = ccfg.seq
        return pipe

    @classmethod
    def from_dir(
        cls,
        path: str,
        xl: bool = False,
        turbo: bool = False,
        compute_dtype: str = "bfloat16",
        res: Tuple[int, int] = (512, 512),
        provider: str = "ram+prefetch",
        hbm_budget_bytes: int = 0,
        device: Optional[torch.device] = None,
    ):
        """The reference's model folders. SD1.5: text_encoder_fp32/,
        unet_fp16/ (or unet_fp32/), vae_decoder_fp16/ (or vae_decoder_qu8/
        with its range_data.txt, or vae_decoder_fp32/), vae_decoder_fp16_l32/
        for the tiles, and the tokenizer files. SDXL (``xl``):
        sdxl_text_encoder_1_fp32/, sdxl_text_encoder_2_fp32/, sdxl_unet_fp16/
        (or the anyshape form), sdxl_vae_decoder_fp16/ (or anyshape),
        sdxl_vae_decoder_32x32_fp16/ and sdxl_tokenizer/."""

        def mk(sub, dynamic=False):
            p = os.path.join(path, sub, "model.txt")
            if not os.path.exists(p):
                return None
            cfg = SessionConfig(compute_dtype=compute_dtype, fuse_ops_in_attention=True,
                                support_dynamic_shapes=dynamic, hbm_budget_bytes=hbm_budget_bytes,
                                device=device)
            # calibrated quantized decoder: load ranges and enable W8A8
            # (reference decoder_solver, src/sd.cpp:1214-1241)
            ranges = os.path.join(path, sub, "range_data.txt")
            if sub.endswith("_qu8") and os.path.exists(ranges):
                cfg.range_data = RangeData.read(ranges).data
                cfg.use_uint8_arithmetic = True
            s = Session(config=cfg, weights_provider_name=provider)
            s.read_file(p)
            return s

        if xl:
            # reference SDXL folder names (src/sd.cpp:2586-2587, 1676-1680,
            # 2379-2434, 3040-3046)
            te = mk("sdxl_text_encoder_1_fp32")
            te2 = mk("sdxl_text_encoder_2_fp32")
            un = mk("sdxl_unet_fp16") or mk("sdxl_unet_anyshape_fp16", dynamic=True)
            vd = mk("sdxl_vae_decoder_fp16") or mk("sdxl_vae_decoder_anyshape_fp16", dynamic=True)
            tile = mk("sdxl_vae_decoder_32x32_fp16")
            # penultimate hidden states come via extra outputs (sd.cpp:2597-2601)
            if te is not None:
                te.add_extra_output("out_5F_13")
            if te2 is not None:
                te2.add_extra_output("out_5F_33")
            tok_dir = os.path.join(path, "sdxl_tokenizer")
        else:
            te, te2 = mk("text_encoder_fp32"), None
            un = mk("unet_fp16") or mk("unet_fp32")
            vd = mk("vae_decoder_fp16") or mk("vae_decoder_qu8") or mk("vae_decoder_fp32")
            tile = mk("vae_decoder_fp16_l32")
            tok_dir = os.path.join(path, "tokenizer")
        if un is None:
            raise FileNotFoundError(f"no UNet model.txt under {path} (xl={xl})")
        tok = ClipTokenizer.from_dir(tok_dir) if os.path.exists(tok_dir) else ClipTokenizer.from_dir(path)
        lat = (res[1] // 8, res[0] // 8)
        return cls(te, un, vd, tok, latent_hw=lat, context_dim=2048 if xl else 768, vae_tile_session=tile,
                   turbo=turbo, text_encoder_2=te2, xl=xl)

    # -------------------------------------------------------------- prompts
    _clip_seq = 77

    def encode_prompt(self, prompt: str) -> np.ndarray:
        """(77, d) conditioning for one prompt (last chunk on multi-chunk
        prompts, matching reference behavior sd.cpp:2216-2218)."""
        chunks = self.tokenizer.encode_with_weights(prompt)
        cond = None
        for toks, mults in chunks:
            toks = toks.copy()
            toks[76] = 49407  # reference sd.cpp:2175 ("todo")
            L = self._clip_seq
            if L != 77:  # tiny test configs use a shorter context
                toks = np.remainder(toks[:L], 999)
                mults = mults[:L]
            if self.text_encoder is None:
                raise RuntimeError("no text encoder loaded")
            self.text_encoder.clear_tensors()
            name = next(iter(self.text_encoder.graph.inputs))
            self.text_encoder.add_tensor(name, toks.reshape(1, L))
            hidden = next(v for v in self.text_encoder.run().values() if v.ndim == 3)
            cond = apply_multipliers(hidden.reshape(L, -1), np.asarray(mults, np.float32))
        return cond

    def encode_prompt_xl(self, prompt: str) -> Dict[str, np.ndarray]:
        """SDXL dual-encoder conditioning (reference src/sd.cpp:2543-2663):
        raw tokens (no weighting) through both encoders; the context is the
        per-token concat of their penultimate hidden states (768 + 1280 ->
        2048), the (1, 1280) pooled embeds come from encoder 2."""
        toks, _ = self.tokenizer.encode_with_weights(prompt)[-1]
        L = self._clip_seq
        if L != 77:
            toks = np.remainder(toks[:L], 999)
        toks = toks.reshape(1, L).astype(np.int64)

        def run(sess):
            sess.clear_tensors()
            sess.add_tensor(next(iter(sess.graph.inputs)), toks)
            return sess.run()

        def pick(out, names, ndim):
            # converted graphs give out_5F_13 / out_5F_33 (penultimate, as
            # extra outputs) and out_5F_0 (pooled); the builder names them
            for n in names:
                if n in out:
                    return out[n]
            return next(v for v in out.values() if v.ndim == ndim)

        o1, o2 = run(self.text_encoder), run(self.text_encoder_2)
        h1 = pick(o1, ("penultimate_hidden_state", "out_5F_13"), 3)
        h2 = pick(o2, ("penultimate_hidden_state", "out_5F_33"), 3)
        pooled = pick(o2, ("pooled_output", "out_5F_0"), 2)
        context = np.concatenate([h1[0].astype(np.float32), h2[0].astype(np.float32)], axis=-1)
        return {"context": context, "pooled": pooled.astype(np.float32).reshape(1, -1)}

    def _encode(self, prompt: str):
        return self.encode_prompt_xl(prompt) if self.xl else self.encode_prompt(prompt)

    # -------------------------------------------------------------- denoiser
    def _unet_input_names(self) -> Dict[str, str]:
        names = {}
        for n in self.unet.graph.inputs:
            key = n.replace("_5F_", "_").lower()
            if "sample" in key and "latent" not in key:
                names["sample"] = n
            elif "timestep" in key or key == "t":
                names["timestep"] = n
            elif "hidden" in key or key == "cc":
                names["context"] = n
            elif "time_ids" in key:
                names["time_ids"] = n
            elif "text_embeds" in key or "add_embeds" in key:
                names["text_embeds"] = n
        return names

    def _unet_batch(self) -> int:
        """The batch the UNet graph declares on its sample input."""
        return self.unet.graph.inputs[self._unet_input_names()["sample"]].shape[0]

    def _context(self, branch) -> torch.Tensor:
        """A (77, d) or stacked (B, 77, d) conditioning as a (B, 77, d)
        float32 tensor on the device: moved once per generation, not once
        per step."""
        t = torch.as_tensor(np.asarray(branch, np.float32)).to(self.device)
        return t[None] if t.ndim == 2 else t

    def _device_branch(self, branch):
        """A CFG branch's loop-invariant conditioning on the device: the
        context as ``_context`` gives it and, for an SDXL dict, its (B, p)
        pooled embeds beside it."""
        if branch is None or isinstance(branch, torch.Tensor):
            return branch
        if isinstance(branch, dict):
            if isinstance(branch["context"], torch.Tensor):
                return branch
            return {"context": self._context(branch["context"]),
                    "pooled": torch.as_tensor(np.asarray(branch["pooled"], np.float32)).to(self.device)}
        return self._context(branch)

    def _feed(self, names: Dict[str, str], sample, timestep, branch, time_ids=None) -> None:
        """Push one UNet run's inputs: the sample, the timestep, the branch's
        context and, for SDXL, the time ids (tiled to the batch unless given)
        and the branch's pooled embeds."""
        branch = self._device_branch(branch)
        self.unet.clear_tensors()
        self.unet.add_tensor(names["sample"], sample)
        self.unet.add_tensor(names["timestep"], timestep)
        ctx = branch["context"] if isinstance(branch, dict) else branch
        self.unet.add_tensor(names["context"], ctx)
        if "time_ids" in names:
            self.unet.add_tensor(names["time_ids"],
                                 np.tile(SDXL_TIME_IDS, (ctx.shape[0], 1)) if time_ids is None else time_ids)
        if "text_embeds" in names and isinstance(branch, dict):
            self.unet.add_tensor(names["text_embeds"], branch["pooled"])

    def denoise(self, x: np.ndarray, sigma: float, cond, uncond, cfg_scale: float = 7.0) -> np.ndarray:
        """CompVis CFG denoiser (reference src/sd.cpp:1397-1558) on host
        latents: two batch-1 UNet runs. cond / uncond are (77, d) contexts
        (SD1.5) or {'context', 'pooled'} dicts (SDXL, each branch carrying
        its own pooled embeds, sd.cpp:1500-1516), on the host or as
        ``_device_branch`` gives them; Turbo (or uncond None) runs cond
        alone."""
        return self._denoise_batch(x[None], sigma, cond, uncond, cfg_scale)[0]

    @staticmethod
    def _stack_branches(*branches):
        """Stack host branches into one batched branch, row i from branch i:
        (cond, uncond) gives the CFG pair, row 0 cond and row 1 uncond."""
        if isinstance(branches[0], dict):
            return {"context": np.stack([np.asarray(b["context"], np.float32) for b in branches]),
                    "pooled": np.concatenate([np.asarray(b["pooled"], np.float32) for b in branches], axis=0)}
        return np.stack([np.asarray(b, np.float32) for b in branches])

    def _denoise_cfg2(self, x: np.ndarray, sigma: float, both, cfg_scale: float) -> np.ndarray:
        """CFG with ONE batch-2 UNet run: row 0 cond, row 1 uncond (JAX
        ``_denoise_cfg2``). The reference runs the two branches one after the
        other (src/sd.cpp:1519-1556); a batch-2 run reads the weights once
        for both. The rows never mix."""
        den = self._denoise_batch(np.repeat(x[None], 2, axis=0), sigma, both, None, cfg_scale)
        return den[1] + np.float32(cfg_scale) * (den[0] - den[1])

    def _branches(self, prompt: str, neg_prompt: str):
        """(cond, uncond, both) conditionings on the device for one
        generation: uncond is None for Turbo; ``both`` is the stacked
        batch-2 branch when the UNet runs the CFG pair as one run, else
        None."""
        cond = self._encode(prompt)
        uncond = None if self.turbo else self._encode(neg_prompt)
        both = None
        if uncond is not None and self._unet_batch() == 2:
            both = self._device_branch(self._stack_branches(cond, uncond))
        return self._device_branch(cond), self._device_branch(uncond), both

    # -------------------------------------------------------------- generate
    def generate(
        self,
        prompt: str,
        neg_prompt: str = "",
        steps: int = 10,
        seed: int = 42,
        sampler: str = "euler_a",
        cfg_scale: float = 7.0,
        decode: bool = True,
        tiled_decode: bool = False,
        preview_steps: bool = False,
        decode_steps: bool = False,
        init_latents: Optional[np.ndarray] = None,
    ) -> GenerationResult:
        """The host loop: any of the 22 samplers, latents on the host between
        steps (JAX ``generate``). A batch-2 UNet runs both CFG branches in
        one run a step (``_denoise_cfg2``); otherwise two batch-1 runs, as
        the reference does."""
        cond, uncond, both = self._branches(prompt, neg_prompt)
        sigma = sched.sigma_schedule(steps)
        x = init_latents if init_latents is not None else randn_4_w_h(seed % 1000, self.latw, self.lath) * sigma[0]
        x = np.asarray(x, np.float32)
        state = S.SamplerState(sampler, steps, seed=seed, turbo=self.turbo)
        proj = SDXL_LATENT_RGB_PROJ if self.xl else SD_LATENT_RGB_PROJ
        previews: List[np.ndarray] = []
        step_images: List[np.ndarray] = []

        def denoise_fn(xx, s):
            if both is not None:
                return self._denoise_cfg2(xx, float(s), both, cfg_scale)
            return self.denoise(xx, float(s), cond, uncond, cfg_scale)

        for i in range(steps):
            x = S.prescale_sample(x, sampler, steps, i, sigma, self.turbo)
            den = denoise_fn(x, float(sigma[i]))
            x = S.sampler_step(state, x, den, sigma, i, denoise_fn)
            if preview_steps:
                previews.append(latent_to_rgb(x, proj))
            if decode_steps and i < steps - 1 and self.vae_decoder is not None:
                # full decode of the in-progress latent; the last step's decode
                # is the normal output image (reference src/sd.cpp:1745-1746)
                step_images.append(self.decode(x, tiled=tiled_decode))

        image = self.decode(x, tiled=tiled_decode) if decode and self.vae_decoder is not None else None
        return GenerationResult(image=image, latents=x, previews=previews, step_images=step_images)

    def generate_on_device(
        self,
        prompt: str,
        neg_prompt: str = "",
        steps: int = 10,
        seed: int = 42,
        sampler: str = "euler_a",
        cfg_scale: float = 7.0,
        decode: bool = True,
        tiled_decode: bool = False,
    ) -> GenerationResult:
        """The euler / euler_a loop on the device (JAX ``generate_on_device``,
        one ``lax.scan``): one step (the UNet runs, CFG, the update ``x + (x -
        den) * slope + noise * up`` in float32) is a ``DeviceProgram`` over
        static buffers, the latents ``x`` written in place and step i's
        scalars and noise read from the per-step stack (``step_stack``, made
        on the host first and copied in once) at a device step counter, so no
        step waits for the host. A batch-2 UNet takes the CFG pair as one run,
        row 0 cond and row 1 uncond; a batch-1 UNet runs once over the pair
        as JAX's does, its segment function vmapped over the stacked contexts
        (and SDXL's pooled embeds) with the latents, the timestep and the
        time ids closed over (``Executor.vmap_segment_fn``); Turbo runs the
        cond branch alone. Where the segment function cannot stand for
        ``Session.run`` (``segment_fn_problem``: streamed, a mesh, stages,
        the per-op interpreter) a batch-1 UNet runs twice a step, through
        the UNet's own segment graphs on a card. On a card the step is
        captured into one CUDA graph and replayed once a step
        (``loop_capture_problem``: where not); its programs are cached under
        JAX's key, the UNet executor and the form. The latents come back to
        the host once, after the last step."""
        if sampler not in ("euler", "euler_a"):
            raise ValueError(f"generate_on_device supports euler/euler_a, not {sampler!r}")
        cond, uncond, both = self._branches(prompt, neg_prompt)
        prog = self._step_program(steps, float(np.float32(cfg_scale)), uncond is not None, both is not None)
        b = prog.static
        for k, branch in (("c", both if both is not None else cond), ("u", None if both is not None else uncond)):
            if branch is not None:
                b["ctx_" + k].copy_(branch["context"] if isinstance(branch, dict) else branch)
                if "pool_" + k in b:
                    b["pool_" + k].copy_(branch["pooled"])
        x0, stack = step_stack(steps, seed, sampler, self.turbo, self.latw, self.lath)
        b["x"].copy_(torch.as_tensor(x0))
        for k, v in stack.items():
            b[k].copy_(torch.as_tensor(v))
        b["counter"].zero_()
        for _ in range(steps):
            prog.run(eager=self._eager_programs)
        x = b["x"].clone()
        image = self.decode(x, tiled=tiled_decode) if decode and self.vae_decoder is not None else None
        return GenerationResult(image=image, latents=x.cpu().numpy(), previews=[])

    # ------------------------------------------------------ device programs
    _eager_programs = False
    _programs: Dict[tuple, DeviceProgram] = None

    @contextlib.contextmanager
    def eager(self):
        """The device programs (``generate_on_device``'s step, the tiled
        decode) run op by op inside, as their first runs do (a reference for
        the replays); their graphs stay and replay again after."""
        self._eager_programs = True
        try:
            yield
        finally:
            self._eager_programs = False

    @property
    def device_programs(self) -> Dict[tuple, DeviceProgram]:
        """The cached device programs by key: JAX's ``("gen", steps,
        no_uncond, cfg_scale)`` and ``(id(session), tile, stride, ramp, lh,
        lw)`` (the latter after ``"tile"``), each followed by the executor's
        identity (and for the step, its form: ``"pair"``, a batch-2 UNet
        over the CFG pair; ``"vmap"``, a batch-1 UNet vmapped over it;
        ``"two runs"``; ``"cond"``) and whether the body calls its segment
        function (``segment_fn_problem`` None; the tile grid's then vmapped
        over the tiles) or ``Session.run``."""
        if self._programs is None:
            self._programs = {}
        return self._programs

    def _program(self, key: tuple, make: Callable[[], DeviceProgram]) -> DeviceProgram:
        """The program cached under key, made first when there is none.
        Programs whose executor its session dropped (a rebuilt plan) go."""
        progs = self.device_programs
        for k in [k for k, p in progs.items() if not p.alive()]:
            del progs[k]
        if key not in progs:
            progs[key] = make()
        return progs[key]

    def _loop_executor(self, rows: int) -> Executor:
        """The UNet executor generate_on_device runs: planned for the loop's
        inputs, device tensors (so no value is pinned into the plan)."""
        names = self._unet_input_names()
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        u = self.unet
        u.clear_tensors()
        u.add_tensor(names["sample"], zeros(rows, 4, self.lath, self.latw))
        u.add_tensor(names["timestep"], zeros(1))
        u.add_tensor(names["context"], zeros(rows, self._clip_seq, self.context_dim))
        if "time_ids" in names:
            u.add_tensor(names["time_ids"], zeros(rows, SDXL_TIME_IDS.shape[1]))
        if "text_embeds" in names and self.xl:
            u.add_tensor(names["text_embeds"], zeros(rows, self._pooled_dim()))
        return u._executor()

    def _pooled_dim(self) -> int:
        dim = self.unet.graph.inputs[self._unet_input_names()["text_embeds"]].shape[-1]
        return dim if dim and dim > 0 else 1280

    def loop_capture_problem(self) -> Optional[str]:
        """Why generate_on_device's step is not captured into a CUDA graph,
        or None: ``program_problem`` of the UNet executor the loop runs (a
        CPU device, a mesh, the per-op interpreter; streamed weights,
        pipeline stages). There the same step runs op by op, through
        ``Session.run`` where ``segment_fn_problem`` names a reason, whose
        segments replay graphs of their own on a card."""
        pair = not self.turbo and self._unet_batch() == 2
        return program_problem(self._loop_executor(2 if pair else 1))

    def tile_capture_problem(self) -> Optional[str]:
        """Why the tiled decode is not captured into one CUDA graph, or
        None: ``program_problem`` of the tile decoder's executor at the
        default tile size."""
        return program_problem(self._tile_executor(self._tile_size)[1])

    def _step_program(self, steps: int, cfg: float, has_uncond: bool, pair: bool) -> DeviceProgram:
        """generate_on_device's step (JAX ``step`` in ``generate_on_device``)
        over static buffers: ``x`` (4, h, w) float32, the per-step stack
        (``ts``, ``c_in``, ``c_out``, ``slope``, ``up``: (steps,), ``noise``:
        (steps, 4, h, w)), the conditioning (``ctx_c`` / ``pool_c``: the
        cond branch, or the stacked pair; ``ctx_u`` / ``pool_u``: the uncond
        branch of a batch-1 UNet), SDXL's time ids and ``counter``, one
        int64 read with ``index_select`` and advanced by one at the end."""
        rows = 2 if pair else 1
        ex = self._loop_executor(rows)
        direct = segment_fn_problem(ex) is None
        form = "pair" if pair else "cond" if not has_uncond else "vmap" if direct else "two runs"
        key = ("gen", steps, not has_uncond, cfg, id(ex), form, direct)
        return self._program(key, lambda: self._make_step_program(ex, steps, cfg, form, direct))

    def _make_step_program(self, ex: Executor, steps: int, cfg: float, form: str, direct: bool) -> DeviceProgram:
        names = self._unet_input_names()
        pair = form == "pair"
        rows = 2 if pair else 1
        dev = self.device
        f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        b = {"x": f32(4, self.lath, self.latw), "noise": f32(steps, 4, self.lath, self.latw),
             "counter": torch.zeros(1, dtype=torch.int64, device=dev)}
        for k in ("ts", "c_in", "c_out", "slope", "up"):
            b[k] = f32(steps)
        branches = ("c", "u") if form in ("vmap", "two runs") else ("c",)
        for k in branches:
            b["ctx_" + k] = f32(rows, self._clip_seq, self.context_dim)
            if "text_embeds" in names and self.xl:
                b["pool_" + k] = f32(rows, self._pooled_dim())
        if "time_ids" in names:
            b["time_ids"] = torch.as_tensor(np.tile(SDXL_TIME_IDS, (rows, 1))).to(dev)
        ctx_name, pool_name = names["context"], names["text_embeds"] if "pool_c" in b else None
        mapped = {ctx_name: 0, **({pool_name: 0} if pool_name else {})}
        call, holds = _segment_caller(ex, mapped if form == "vmap" else None) if direct else (None, ())

        def eps(sample: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
                pooled: Optional[torch.Tensor]) -> torch.Tensor:
            if call is None:  # streamed, a mesh, stages, the per-op interpreter: Session.run
                self._feed(names, sample, t, ctx if pooled is None else {"context": ctx, "pooled": pooled},
                           b.get("time_ids"))
                return _run_device(self.unet, dev)
            acts = {names["sample"]: sample, names["timestep"]: t, ctx_name: ctx}
            if "time_ids" in names:
                acts[names["time_ids"]] = b["time_ids"]
            if pooled is not None:
                acts[pool_name] = pooled
            return call(acts)

        def branch(k: str, sample: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            return eps(sample, t, b["ctx_" + k], b.get("pool_" + k))

        def step() -> torch.Tensor:
            i, x = b["counter"], b["x"]
            t, c_in, c_out, slope, up = (b[k].index_select(0, i) for k in ("ts", "c_in", "c_out", "slope", "up"))
            # float32 input: the executor casts it to the compute dtype at entry
            x_in = (x * c_in)[None]
            if pair:
                den2 = branch("c", x_in.repeat(2, 1, 1, 1), t) * c_out + x
                den = den2[1] + cfg * (den2[0] - den2[1])
            elif form == "cond":
                den = branch("c", x_in, t)[0] * c_out + x
            else:
                if form == "vmap":  # one UNet call over the stacked pair (JAX: jax.vmap over ctxs, pools)
                    pools = torch.stack([b["pool_c"], b["pool_u"]]) if pool_name else None
                    eps_c, eps_u = eps(x_in, t, torch.stack([b["ctx_c"], b["ctx_u"]]), pools)[:, 0]
                else:
                    eps_c, eps_u = branch("c", x_in, t)[0], branch("u", x_in, t)[0]
                den_u = eps_u * c_out + x
                den = den_u + cfg * ((eps_c * c_out + x) - den_u)
            x.copy_(x + (x - den) * slope + b["noise"].index_select(0, i)[0] * up)
            i.add_(1)
            return x

        what = {"pair": "batch-2 UNet, the CFG pair", "vmap": "batch-1 UNet vmapped over the CFG pair",
                "two runs": "batch-1 UNet, two runs", "cond": "cond only"}[form]
        return DeviceProgram(f"the SD step ({steps} steps, {what}, cfg {cfg:g})", "the UNet", self.unet, ex, step, b,
                             holds)

    # -------------------------------------------------------- batched generate
    def _denoise_batch(self, xb: np.ndarray, sigma: float, conds, unconds, cfg_scale: float) -> np.ndarray:
        """CFG denoise over a real batch (N, 4, h, w) (JAX ``_denoise_batch``):
        one batch-N UNet run per branch instead of N sequential runs (the
        reference's N-coroutine batch replay, src/sd.cpp:1031-1161). conds /
        unconds are the N branches stacked (``_stack_branches``), or one
        branch when N is 1 (``denoise``)."""
        c_in, c_out = sched.get_scalings(sigma)
        t = np.array([sched.sigma_to_t(sigma)], np.float32)
        names = self._unet_input_names()

        def run(branch) -> np.ndarray:
            self._feed(names, (xb * np.float32(c_in)).astype(np.float32), t, branch)
            return _first4d(self.unet.run()) * np.float32(c_out) + xb

        den_c = run(conds)
        if self.turbo or unconds is None:
            return den_c
        den_u = run(unconds)
        return den_u + np.float32(cfg_scale) * (den_c - den_u)

    def generate_batch(
        self,
        prompts: List[str],
        neg_prompts: Optional[List[str]] = None,
        steps: int = 10,
        seeds: Optional[List[int]] = None,
        sampler: str = "euler_a",
        cfg_scale: float = 7.0,
        decode: bool = True,
        tiled_decode: bool = False,
    ) -> List[GenerationResult]:
        """len(prompts) images through one batch-N UNet (JAX
        ``generate_batch``). The sampler math stays per image (own seed, own
        history), so image i is a sequential ``generate`` with seed i.
        Multi-stage samplers call the denoiser again per image: the N images
        run the same sampler at the same step, and the sampler's control flow
        never depends on tensor values, so N threads make those calls in
        lockstep and a barrier stacks them into one batched run per call
        site, made by one thread (the barrier's leader) while the others
        wait."""
        N = len(prompts)
        batch_in = self._unet_batch()
        if batch_in != N:
            raise ValueError(
                f"unet session has batch {batch_in}; build the pipeline with batch={N} "
                f"(from_synthetic(batch=N)) or generate sequentially")
        seeds = seeds if seeds is not None else list(range(42, 42 + N))
        neg_prompts = neg_prompts if neg_prompts is not None else [""] * N
        conds = self._device_branch(self._stack_branches(*(self._encode(p) for p in prompts)))
        unconds = None if self.turbo else self._device_branch(
            self._stack_branches(*(self._encode(p) for p in neg_prompts)))

        sigma = sched.sigma_schedule(steps)
        xs = [np.asarray(randn_4_w_h(seeds[i] % 1000, self.latw, self.lath) * sigma[0], np.float32)
              for i in range(N)]
        states = [S.SamplerState(sampler, steps, seed=seeds[i], turbo=self.turbo) for i in range(N)]

        for i in range(steps):
            xb = np.stack([S.prescale_sample(x, sampler, steps, i, sigma, self.turbo) for x in xs])
            den = self._denoise_batch(xb, float(sigma[i]), conds, unconds, cfg_scale)
            xs = self._lockstep(N, lambda j, fn: S.sampler_step(states[j], xb[j], den[j], sigma, i, fn),
                                lambda xst, s: self._denoise_batch(xst, s, conds, unconds, cfg_scale))

        results = []
        for j in range(N):
            img = self.decode(xs[j], tiled=tiled_decode) if decode and self.vae_decoder is not None else None
            results.append(GenerationResult(image=img, latents=xs[j], previews=[]))
        return results

    @staticmethod
    def _lockstep(n: int, step, batched) -> List[np.ndarray]:
        """Run ``step(j, denoise_fn)`` for j < n in n threads. Each thread's
        ``denoise_fn(x, s)`` waits at a barrier until all n have called it;
        the barrier's leader then runs ``batched(stack of the n x, s)`` once
        and every thread takes its row. An error in one thread breaks the
        barrier and is raised here."""
        slot: List[Optional[np.ndarray]] = [None] * n
        shared = {"res": None, "s": None}
        barrier = threading.Barrier(n)

        def mk_denoise_fn(j):
            def fn(x2, s):
                slot[j] = x2
                shared["s"] = float(s)
                if barrier.wait() == 0:
                    shared["res"] = batched(np.stack(slot), shared["s"])
                barrier.wait()
                return shared["res"][j]
            return fn

        outs: List[Optional[np.ndarray]] = [None] * n
        errs: List[Optional[BaseException]] = [None] * n

        def run_j(j):
            try:
                outs[j] = step(j, mk_denoise_fn(j))
            except BaseException as e:  # noqa: BLE001 - relayed below
                errs[j] = e
                barrier.abort()

        threads = [threading.Thread(target=run_j, args=(j,)) for j in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        first = next((e for e in errs if e is not None and not isinstance(e, threading.BrokenBarrierError)), None)
        if first is not None:
            raise first
        return list(outs)

    # ------------------------------------------------------------ calibration
    def _decoder_sessions(self) -> List[Session]:
        return [s for s in (self.vae_decoder, self.vae_tile_session) if s is not None]

    def calibrate_decoder(self, on: bool = True) -> None:
        """--decoder-calibrate: the decoder sessions (full and tile) run
        eagerly and record every op's activation range while ``on``; turning
        it on drops the ranges recorded before."""
        for s in self._decoder_sessions():
            s.config.range_data_calibrate = on
            if on:
                for ex in s._executors.values():
                    ex.range_data = RangeData()

    def calibration_ranges(self) -> RangeData:
        """The ranges recorded by the decodes since ``calibrate_decoder``,
        merged over the decoder sessions (what ``range_data.txt`` holds)."""
        rd = RangeData()
        for s in self._decoder_sessions():
            for ex in s._executors.values():
                for name, (lo, hi) in ex.range_data.data.items():
                    rd.update(name, lo, hi)
        return rd

    # ----------------------------------------------------------------- decode
    def decode(self, latents: Latents, tiled: bool = False) -> np.ndarray:
        """(4,h,w) latents (host or device) -> (8h,8w,3) uint8 image."""
        if tiled:
            return self._decode_tiled(latents)
        return image_to_uint8(self.decode_to_float(latents))

    def decode_to_float(self, latents: Latents, tiled: bool = False) -> torch.Tensor:
        """(4,h,w) latents -> the decoder's (3, 8h, 8w) float32 output on the
        device, before the uint8 mapping."""
        z = self._scaled(latents)
        if tiled:
            return self._tiled(z)[0]
        self.vae_decoder.clear_tensors()
        self.vae_decoder.add_tensor(next(iter(self.vae_decoder.graph.inputs)), z[None])
        return _run_device(self.vae_decoder, self.device)[0]

    def _scaled(self, latents: Latents) -> torch.Tensor:
        return torch.as_tensor(latents).to(self.device).float() / np.float32(self.vae_scale)

    _tile_size = 32

    @staticmethod
    def _tile_grid(lh: int, lw: int, tile: int, stride: int) -> Tuple[List[int], List[int]]:
        # max(0, ...): a latent smaller than the tile gets ONE tile at origin 0
        def axis(n):
            out, y = [], 0
            while True:
                out.append(max(0, min(y, n - tile)))
                if y >= n - tile:
                    return out
                y += stride

        return axis(lh), axis(lw)

    @staticmethod
    def _blend_factor(dy: int, dx: int, th: int, tw: int, ramp: int) -> np.ndarray:
        """Linear 25%-overlap blend ramp (reference blend, src/sd.cpp:1300-1326)."""
        fy = np.ones((th, 1), np.float32)
        if dy:
            fy[: min(ramp, th), 0] = np.arange(min(ramp, th), dtype=np.float32) / ramp
        fx = np.ones((1, tw), np.float32)
        if dx:
            fx[0, : min(ramp, tw)] = np.arange(min(ramp, tw), dtype=np.float32) / ramp
        return fy * fx

    def _tile_executor(self, tile: int, z: Optional[torch.Tensor] = None) -> Tuple[Session, Executor]:
        """The tile decoder's session and its executor at the tile size,
        planned for z's top-left tile (zeros on the pipeline's device where
        z is None)."""
        sess = self.vae_tile_session or self.vae_decoder
        if z is None:
            z = torch.zeros((4, tile, tile), dtype=torch.float32, device=self.device)
        sess.clear_tensors()
        sess.add_tensor(next(iter(sess.graph.inputs)), z[None, :, :tile, :tile].contiguous())
        return sess, sess._executor()

    def _decode_tiled(self, latents: Latents, tile: Optional[int] = None, stride: Optional[int] = None,
                      ramp: Optional[int] = None) -> np.ndarray:
        """Tiled decode of (4, h, w) latents -> (8h, 8w, 3) uint8 (JAX
        ``_decode_tiled``)."""
        return self._tiled(self._scaled(latents), tile, stride, ramp)[1].cpu().numpy()

    def _tiled(self, z: torch.Tensor, tile: Optional[int] = None, stride: Optional[int] = None,
               ramp: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tiled decode with linear overlap blending (reference
        sd_tiled_decoder src/sd.cpp:1258-1346) of a scaled (4, h, w) latent
        on the device: the (3, H, W) float32 image and its (H, W, 3) uint8
        mapping, both fresh tensors. Where the tile decoder has no
        ``segment_fn_problem``, the whole grid is one ``DeviceProgram`` (JAX
        jits it as one program): the tiles static slices of a latent buffer,
        stacked and decoded by one call of the decoder's segment function
        vmapped over them (JAX's ``jax.vmap``), the blend factors device
        constants, the blend and the uint8 mapping inside; on a card its
        second run captures it into one CUDA graph. Elsewhere (streamed, a
        mesh, stages, the per-op interpreter: JAX's segmented decoder) a tile
        is one ``Session.run``, whose segments replay graphs of their own on
        a card (``tile_capture_problem``). A latent smaller than the tile
        decodes as one clamped tile."""
        tile = min(tile or self._tile_size, z.shape[1], z.shape[2])
        sess, ex = self._tile_executor(tile, z)
        # upscale factor from the tile model's declared output shape
        out_spec = sess.graph.produced[sess.graph.output_names()[0]]
        in_spec = next(iter(sess.graph.inputs.values()))
        scale = out_spec.shape[-1] // in_spec.shape[-1] if out_spec.shape and in_spec.shape[-1] else 8
        stride = min(stride if stride is not None else max(tile * 3 // 4, 1), tile)  # 25% overlap (sd.cpp:1330)
        ramp = ramp if ramp is not None else (tile - stride) * scale
        lh, lw = z.shape[1], z.shape[2]
        ys, xs = self._tile_grid(lh, lw, tile, stride)
        name = next(iter(sess.graph.inputs))
        th = tw = tile * scale
        direct = segment_fn_problem(ex) is None
        factors = lambda: torch.as_tensor(np.stack(
            [self._blend_factor(sy * scale, sx * scale, th, tw, ramp) for sy in ys for sx in xs])).to(z.device)

        def blend(decoded, factors_t: torch.Tensor) -> torch.Tensor:
            res = torch.zeros((3, lh * scale, lw * scale), dtype=torch.float32, device=z.device)
            t = 0
            for sy in ys:
                for sx in xs:
                    img = decoded(t, sy, sx)
                    dy, dx = sy * scale, sx * scale
                    f = factors_t[t]
                    region = res[:, dy:dy + th, dx:dx + tw]
                    res[:, dy:dy + th, dx:dx + tw] = img * f + region * (1.0 - f)
                    t += 1
            return res

        if not direct:
            def run_tile(t: int, sy: int, sx: int) -> torch.Tensor:
                sess.clear_tensors()
                sess.add_tensor(name, z[None, :, sy:sy + tile, sx:sx + tile].contiguous())
                return _run_device(sess, z.device)[0]

            res = blend(run_tile, factors())
            return res, _to_uint8(res)

        def make() -> DeviceProgram:
            call, holds = _segment_caller(ex, {name: 0})
            b = {"z": torch.zeros((4, lh, lw), dtype=torch.float32, device=z.device), "factors": factors()}

            def grid() -> Tuple[torch.Tensor, torch.Tensor]:
                # the tiles stacked, (T, 1, 4, tile, tile), through one vmapped decoder call (JAX: jax.vmap)
                tiles = torch.stack([b["z"][None, :, sy:sy + tile, sx:sx + tile] for sy in ys for sx in xs])
                imgs = call({name: tiles})[:, 0]
                res = blend(lambda t, sy, sx: imgs[t], b["factors"])
                return res, _to_uint8(res)

            what = (f"the tiled decode ({len(ys)} x {len(xs)} tiles of {tile} x {tile}, stride {stride}, ramp {ramp}, "
                    f"one vmapped decoder call)")
            return DeviceProgram(what, "the tile decoder", sess, ex, grid, b, holds)

        prog = self._program(("tile", id(sess), tile, stride, ramp, lh, lw, id(ex), direct), make)
        prog.static["z"].copy_(z)
        res, img8 = prog.run(eager=self._eager_programs)
        return res.clone(), img8.clone()

    # ------------------------------------------------------------- latents IO
    @staticmethod
    def save_latents(path: str, latents: np.ndarray) -> None:
        np.asarray(latents, np.float32).tofile(path)

    @staticmethod
    def load_latents(path: str, lath: int, latw: int) -> np.ndarray:
        return np.fromfile(path, np.float32).reshape(4, lath, latw)


def qu8_decoder(text: str, weights: Dict[str, np.ndarray], range_data: Dict[str, tuple],
                compute_dtype: str = "float32", device: Optional[torch.device] = None) -> Session:
    """The calibrated W8A8 decoder made from a float decoder graph, as a
    ``vae_decoder_qu8`` folder holds it: weights through the converter's
    ``quantize_graph_weights`` (per-tensor ``uint8[scale,zp]``, its
    exclusions), ``range_data`` and ``use_uint8_arithmetic`` as ``from_dir``
    sets them."""
    from onnxstream_tpu_torch.convert.quantize import quantize_graph_weights

    qtext, qweights = quantize_graph_weights(text, weights)
    cfg = SessionConfig(compute_dtype=compute_dtype, fuse_ops_in_attention=True, device=device,
                        use_uint8_arithmetic=True, range_data=dict(range_data))
    s = Session(config=cfg, weights_provider=DictWeightsProvider(params_from_numpy(qweights)))
    s.read_string(qtext)
    return s


def save_image(img: np.ndarray, path: str, parameters: Optional[str] = None) -> None:
    """PNG/JPEG writer with optional embedded generation parameters
    (reference --embed-parameters, src/sd.cpp:447-509)."""
    from PIL import Image
    from PIL.PngImagePlugin import PngInfo

    im = Image.fromarray(img)
    if path.lower().endswith(".png") and parameters:
        info = PngInfo()
        info.add_text("parameters", parameters)
        im.save(path, pnginfo=info)
    elif parameters:
        im.save(path, comment=parameters.encode())
    else:
        im.save(path)

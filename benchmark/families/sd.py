"""Stable Diffusion text-to-image through onnxstream_tpu_torch.

Builds the port's ``StableDiffusionPipeline`` from a configuration file (the
published text-encoder, UNet and VAE configs, at full width and depth): the
port's graph builders give the graphs, the benchmark's weights
(``harness/weights.py``) fill every parameter, and each graph runs in its own
``Session`` in the configuration's compute dtype, with the configuration's
session options (``session_config``), fed by a ``DictWeightsProvider``. A request is one ``generate_on_device`` call, the
prompt strings in and the uint8 image on the host out. The same weights and
requests go to the plain reference (``benchmark/reference``) to judge the
outputs."""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Tuple

import numpy as np

import torch

from benchmark.harness import weights as bench_weights
from benchmark.harness.roofline import AttentionSite
from benchmark.harness.trace import Spans
from benchmark.reference import clip as ref_clip
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import unet as ref_unet
from benchmark.reference import vae as ref_vae
from benchmark.reference.ops import PRECISIONS, Weights, for_config

CONTEXT = 77


def builders(config: dict) -> Dict[str, object]:
    """model -> the port's graph builder (big weights left as placeholders)."""
    from onnxstream_tpu_torch.models.sd.clip import ClipConfig, build_text_encoder
    from onnxstream_tpu_torch.models.sd.unet import UNetConfig, build_unet
    from onnxstream_tpu_torch.models.sd.vae import VaeConfig, build_vae_decoder

    lat = int(config["latent_size"])
    out: Dict[str, object] = {}
    encoders = config["text_encoders"]
    for k, te in enumerate(encoders):
        cc = ClipConfig(vocab_size=int(te["vocab_size"]), width=int(te["hidden_size"]),
                        layers=int(te["num_hidden_layers"]), heads=int(te["num_attention_heads"]),
                        seq=int(te["max_position_embeddings"]), activation=te["hidden_act"],
                        pooled=k == 1, proj_dim=int(te.get("projection_dim", 0)) if k == 1 else 0)
        out["text_encoder" if k == 0 else "text_encoder_2"] = build_text_encoder(cc, lazy_weights=True)
    u = config["unet"]
    text_time = u.get("addition_embed_type") == "text_time"
    tdim = int(u.get("addition_time_embed_dim", 256))
    heads = ref_unet.heads(u)
    uc = UNetConfig(in_channels=int(u["in_channels"]), out_channels=int(u["out_channels"]), sample_size=lat,
                    block_out_channels=tuple(int(c) for c in u["block_out_channels"]),
                    layers_per_block=int(u["layers_per_block"]), cross_attention_dim=int(u["cross_attention_dim"]),
                    attention_head_dim=tuple(heads), attn_levels=tuple("CrossAttn" in t for t in u["down_block_types"]),
                    transformer_layers=tuple(ref_unet.layers(u)), norm_groups=int(u["norm_num_groups"]),
                    context_len=CONTEXT,
                    pooled_dim=int(u["projection_class_embeddings_input_dim"]) - 6 * tdim if text_time else 0,
                    time_fourier_dim=tdim, head_dim_is_count=True)
    out["unet"] = build_unet(uc, batch=1, lazy_weights=True)
    v = config["vae"]
    chans = [int(c) for c in v["block_out_channels"]]
    vc = VaeConfig(latent_channels=int(v["latent_channels"]), base=chans[0], mult=tuple(c // chans[0] for c in chans),
                   blocks=int(v["layers_per_block"]) + 1, norm_groups=int(v["norm_num_groups"]), sample=lat)
    out["vae_decoder"] = build_vae_decoder(vc, lazy_weights=True)
    return out


def session_options(config: dict, model: str) -> Dict[str, object]:
    """``SessionConfig`` options of one model's session: the configuration's
    ``session`` (every model) updated by ``session_models[model]``, each
    under its ``SessionConfig`` field name (a list stands for a set field).
    A name that ``SessionConfig`` lacks is refused."""
    from onnxstream_tpu_torch.runtime.config import SessionConfig

    fields = {f.name: f for f in dataclasses.fields(SessionConfig)}
    opts = {**config.get("session", {}), **config.get("session_models", {}).get(model, {})}
    unknown = sorted(set(opts) - set(fields) | set(opts) & {"compute_dtype", "device"})
    if unknown:
        raise ValueError(f"session options {unknown} of {model!r}: not SessionConfig options the configuration sets")
    sets = {n for n, f in fields.items() if f.default_factory is not dataclasses.MISSING
            and isinstance(f.default_factory(), set)}
    return {k: set(v) if k in sets else v for k, v in opts.items()}


def parameter_specs(graphs: Dict[str, object]) -> Dict[str, Dict[str, tuple]]:
    return {m: {n: tuple(int(d) for d in a.shape) for n, a in g.weights.items() if bench_weights.is_parameter(n)}
            for m, g in graphs.items()}


class System:
    """The program under test, built for one cell and seeded weights."""

    def __init__(self, cell, seed: int, device: torch.device, spans: Spans):
        from onnxstream_tpu_torch.models.sd.pipeline import StableDiffusionPipeline
        from onnxstream_tpu_torch.models.sd.tokenizer import ClipTokenizer
        from onnxstream_tpu_torch.runtime.config import SessionConfig
        from onnxstream_tpu_torch.runtime.session import Session
        from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

        from benchmark.harness.traffic import vocabulary

        self.cell, self.device, self.spans = cell, device, spans
        cfg = cell.config
        graphs = builders(cfg)
        self.specs = parameter_specs(graphs)
        with spans.span("weights"):
            self.weights = bench_weights.generate(self.specs, seed, device, getattr(torch, cfg["dtype"]))
        sessions = {}
        for model, g in graphs.items():
            consts = params_from_numpy({n: a for n, a in g.weights.items() if not bench_weights.is_parameter(n)})
            s = Session(config=SessionConfig(compute_dtype=cfg["dtype"], device=device, **session_options(cfg, model)),
                        weights_provider=DictWeightsProvider({**consts, **self.weights[model]}))
            s.read_string(g.to_text())
            sessions[model] = s
        self.vocab = vocabulary(cell.traffic)
        tok = ClipTokenizer({w + "</w>": i for w, i in self.vocab.items()}, merges=None)
        lat = int(cfg["latent_size"])
        self.pipe = StableDiffusionPipeline(
            sessions["text_encoder"], sessions["unet"], sessions["vae_decoder"], tok, latent_hw=(lat, lat),
            context_dim=int(cfg["unet"]["cross_attention_dim"]), device=device,
            turbo=bool(cell.traffic.get("turbo", False)), text_encoder_2=sessions.get("text_encoder_2"),
            xl="text_encoder_2" in sessions)
        p = self.pipe
        p._encode = spans.wrap("encode", p._encode)
        p.decode = spans.wrap("decode", p.decode)
        p.decode_to_float = spans.wrap("vae", p.decode_to_float)
        step_program = p._step_program

        def spanned_program(*args, **kw):
            prog = step_program(*args, **kw)
            if not getattr(prog, "spanned", False):
                prog.run, prog.spanned = spans.wrap("step", prog.run), True
            return prog

        p._step_program = spanned_program

    def serve(self, req: dict) -> dict:
        """One request through ``generate_on_device``: the latents and the
        uint8 image, both on the host."""
        r = self.pipe.generate_on_device(req["prompt"], req["negative_prompt"], steps=req["steps"], seed=req["seed"],
                                         sampler=req["sampler"], cfg_scale=req["cfg_scale"], decode=True)
        return {"latents": r.latents, "image": r.image}

    def captures(self) -> int:
        """Device programs captured so far."""
        return sum(prog.captures for prog in self.pipe.device_programs.values())

    def release(self) -> None:
        """Free the program's device state (its sessions, graphs and
        weights); the benchmark's host weights stay."""
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ reference
def reference_weights(host: Dict[str, Dict[str, torch.Tensor]], device) -> Dict[str, Weights]:
    """The benchmark's weights as float32 on the device, for the reference."""
    return {m: Weights({n: t.to(device).float() for n, t in w.items()}, device) for m, w in host.items()}


def reference(cell, host: Dict[str, Dict[str, torch.Tensor]], requests: List[dict], vocab: Dict[str, int],
              device, precision: str = "reference", served: List[dict] = ()) -> Tuple[List[dict], List[np.ndarray]]:
    """The plain reference's latents and image for each request, in
    ``precision`` (by default the configuration's reference,
    ``reference/ops.py for_config``), and the float32 decoder's image of each
    ``served`` answer's latents (the decode stage judged on the latents it
    was given); TF32 off."""
    P = for_config(cell.config) if precision == "reference" else PRECISIONS[precision]
    W = reference_weights(host, device)
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            outs = [ref_pipeline.text_to_image(W, cell.config, r, vocab, device, P) for r in requests]
            images = [ref_pipeline.decode(W, cell.config, s["latents"]) for s in served]
        return outs, images
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
        del W
        if device.type == "cuda":
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ counts
def kernel1_sites(cell) -> List[AttentionSite]:
    """The attention calls of one request that the port routes to its flash
    kernel (kernel 1): self-attention over at least 512 keys whose bf16
    scores would take at least 8 MiB a batch row (the port's gate,
    ``ops/attention.py``), which are the UNet's long self-attentions and the
    VAE's mid-block attention. Cross-attention (77 keys) and the text
    encoders (77 positions) stay off it. A CFG pair runs as one call over
    batch 2 (the vmapped UNet)."""
    cfg, t = cell.config, cell.traffic
    u, lat, steps = cfg["unet"], int(cfg["latent_size"]), int(t["steps"])
    rows = 1 if t.get("turbo") else 2
    chans = [int(c) for c in u["block_out_channels"]]
    heads, layers = ref_unet.heads(u), ref_unet.layers(u)
    lpb = int(u["layers_per_block"])
    sites = []

    def add(tokens: int, h: int, d: int, calls: int, b: int) -> None:
        if calls and tokens >= 512 and 2 * h * tokens * tokens >= (8 << 20):
            sites.append(AttentionSite(b=b, h=h, m=tokens, n=tokens, d=d, calls=calls))

    for lvl, c in enumerate(chans):
        tokens = (lat >> lvl) ** 2
        add(tokens, heads[lvl], c // heads[lvl], steps * layers[lvl] * (2 * lpb + 1), rows)
    mid_tokens = (lat >> (len(chans) - 1)) ** 2
    add(mid_tokens, heads[-1], chans[-1] // heads[-1], steps * ref_unet.depths(u)[-1], rows)
    v = cfg["vae"]
    add(lat * lat, 1, int(v["block_out_channels"][-1]), 1, 1)
    return sites


def flops_per_request(cell, specs: Dict[str, Dict[str, tuple]]) -> Dict[str, object]:
    """The model's floating-point operations for one request, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference at
    the cell's shapes on the meta device: the text encoders once a prompt,
    the UNet once a step and branch, the decoder once. Also the parameter
    names the reference read, model by model."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, t = cell.config, cell.traffic
    meta = torch.device("meta")
    W = {m: Weights({n: torch.empty(s, device=meta) for n, s in spec.items()}) for m, spec in specs.items()}
    lat, u = int(cfg["latent_size"]), cfg["unet"]
    prompts = 1 if t.get("turbo") else 2
    total = 0
    tok = torch.zeros((1, CONTEXT), dtype=torch.int64, device=meta)

    def count(fn) -> int:
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()

    encoders = cfg["text_encoders"]
    total += prompts * count(lambda: ref_clip.encode(W["text_encoder"], encoders[0], tok))
    if len(encoders) > 1:
        total += prompts * count(lambda: ref_clip.encode(W["text_encoder_2"], encoders[1], tok,
                                                        pool_at=CONTEXT - 1))
    ctx_dim = int(u["cross_attention_dim"])
    extra = {}
    if u.get("addition_embed_type") == "text_time":
        pooled = int(u["projection_class_embeddings_input_dim"]) - 6 * int(u["addition_time_embed_dim"])
        extra = {"pooled": torch.empty((1, pooled), device=meta), "time_ids": torch.empty((1, 6), device=meta)}
    unet_once = count(lambda: ref_unet.eps(W["unet"], u, torch.empty((1, int(u["in_channels"]), lat, lat), device=meta),
                                           500.0, torch.empty((1, CONTEXT, ctx_dim), device=meta), **extra))
    total += unet_once * int(t["steps"]) * prompts
    v = cfg["vae"]
    total += count(lambda: ref_vae.decode(W["vae_decoder"], v,
                                          torch.empty((1, int(v["latent_channels"]), lat, lat), device=meta)))
    return {"flops": float(total), "read": {m: set(w.read) for m, w in W.items()}}

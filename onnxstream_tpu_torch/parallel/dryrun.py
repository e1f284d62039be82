"""The multi-rank dry run: the train step and the sharded serving paths
against one device.

Counterpart of ``__graft_entry__.py dryrun_multichip``. On n ranks
(``launch.spawn``):

  * one AdamW step of the TINY UNet (float32, batch max(2, n // 2),
    ``use_flash_attention=False``) under ``make_mesh(n, dp=2)``
    (``sharding.make_train_step``): tp-sharded weights, the batch over dp;
  * the TINY UNet (float32, batch max(2, n // 2)) through ``Session`` under
    ``make_mesh(n, dp=2[, sp=2])``: tp-sharded weights, the batch over dp,
    with sp a 16-token context over sp;
  * the same UNet on pipeline stages (``pp_devices``, in this process);
  * LLAMA_TINY tensor-parallel (tp = 2) prefill, stepwise decode and
    ``generate_on_device`` with the KV cache sharded on its heads;

each held to the one-device run, and one line printed for each.

    python -m onnxstream_tpu_torch.parallel.dryrun 4                                 # NCCL, a card a rank
    python -m onnxstream_tpu_torch.parallel.dryrun 8 --device cpu --backend gloo     # CPU
    python -m onnxstream_tpu_torch.parallel.dryrun 2 --device cuda:0 --backend gloo  # two ranks on one card

The rank-side functions (``rank_cases`` and the cases it runs) serve the
tests and ``chip_smoke.py`` too.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LLM_BUCKETS = [8, 16, 32]
LLM_PROMPT = [3, 17, 101, 9]


def tiny_unet_inputs(batch: int, context_len: int = 7) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    return {"sample": rng.rand(batch, 4, 16, 16).astype(np.float32), "timestep": np.array([500.0], np.float32),
            "encoder_hidden_states": rng.rand(batch, context_len, 32).astype(np.float32)}


def tiny_unet(batch: int, context_len: int = 7) -> Tuple[str, Dict[str, np.ndarray]]:
    """The TINY UNet's model.txt and numpy weights (seed 0). A context of
    16 tokens or more is what ``sp = 2`` shards (8 a rank at least)."""
    import dataclasses

    from onnxstream_tpu_torch.models.sd.unet import TINY, build_unet

    g = build_unet(dataclasses.replace(TINY, context_len=context_len), batch=batch)
    return g.to_text(), dict(g.weights)


def _session(text: str, weights, inputs, device, **config):
    from onnxstream_tpu_torch.runtime.config import SessionConfig
    from onnxstream_tpu_torch.runtime.session import Session
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    s = Session(SessionConfig(device=torch.device(device), **config),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s


def run_session(text: str, weights, inputs: Dict[str, np.ndarray], device, **config) -> Tuple[np.ndarray, Any]:
    """One run of a graph through the port's Session: its first output as
    float32 numpy and the session."""
    s = _session(text, weights, inputs, device, **config)
    out = s.run()
    return next(iter(out.values())), s


def unet_case(rank: int, device, text: str, weights, inputs, mesh: Dict[str, int], return_weights: bool = False,
              **config) -> Dict[str, Any]:
    """The graph under ``make_mesh(world, **mesh)`` on this rank: the
    output, the rank's weight accounting, the gathers of the run, and the
    placements the pass gave the weights."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.sharding import make_mesh

    m = make_mesh(dist.get_world_size(), **mesh)
    comm.STATS.reset()
    y, s = run_session(text, weights, inputs, device, mesh=m, **config)
    ex = s._executor()
    out = {"out": y, "mesh": dict(zip(m.mesh_dim_names, m.shape)), "coordinate": list(m.get_coordinate()),
           "hbm": {k: v for k, v in s.hbm_stats()["accounting"].items() if not isinstance(v, list)},
           "gathers": comm.STATS.snapshot(),
           "gather_ops": sum(op.op_type == "ostpu.all_gather" for op in ex.graph.ops),
           "weight_placements": dict(ex.mesh_info.weight_placements),
           "weight_shards": {w.name: w.shard for w in ex.plan.arg_weights}}
    if return_weights:
        held = ex._fetch_segment_weights(ex.segments[0])  # resident: the weights of the run
        out["weights"] = {name: t.float().cpu().numpy() for name, t in held.items()}
        # the quantized ones' (scale, zero): per channel as float32 numpy
        out["quant"] = {w.name: tuple(v.cpu().numpy() if isinstance(v, torch.Tensor) else v for v in w.quant)
                        for w in ex.plan.arg_weights if w.quant is not None}
    return out


def session_case(rank: int, device, text: str, weights, inputs, mesh: Dict[str, int], **config) -> Dict[str, Any]:
    """One run of a graph under ``make_mesh(world, **mesh)`` with the
    options in ``config`` (the calibrated W8A8 and QDQ routes, calibration,
    a budget, pipeline stages): every output as float32 / int64 numpy, the
    quantized ops' routes, the ranges a calibration recorded, the segments,
    this rank's accounting, the run's gathers and whether the sharding pass
    ran (pipeline stages take its place)."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.sharding import make_mesh

    m = make_mesh(dist.get_world_size(), **mesh)
    s = _session(text, weights, inputs, device, mesh=m, **config)
    comm.STATS.reset()
    out = s.run()
    gathers = comm.STATS.snapshot()
    ex = s._executor()
    return {"out": out, "routes": ex.quant_routes, "ranges": dict(ex.range_data.data),
            "segments": len(ex.segments), "sharded": ex.mesh_info is not None, "gathers": gathers,
            "hbm": {k: v for k, v in ex.hbm_accounting().items() if not isinstance(v, list)}}


def streamed_case(rank: int, device, text: str, weights, inputs, mesh: Dict[str, int], budget: int,
                  **config) -> Dict[str, Any]:
    """The graph under ``make_mesh(world, **mesh)`` resident, then streamed
    at ``budget`` bytes a rank, twice (a second streamed run reads its
    weights again): the three outputs, the streamed run's segments and
    accounting, and per weight that crosses (not one made on the device)
    this rank's shard, its staged and upload bytes and whether its file's
    bytes cross as they are."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel.sharding import make_mesh
    from onnxstream_tpu_torch.runtime.executor import upload_bytes

    m = make_mesh(dist.get_world_size(), **mesh)
    resident = run_session(text, weights, inputs, device, mesh=m, **config)[0]
    s = _session(text, weights, inputs, device, mesh=m, hbm_budget_bytes=budget, **config)
    first, second = s.run(), s.run()
    ex = s._executor()
    crossed = {w.name: {"shard": w.shard, "staged": ex._staged_bytes(w), "upload": upload_bytes(w),
                        "file_bytes": ex._crosses_as_file_bytes(w)}
               for w in ex.plan.arg_weights if ex._synth_kind(w) is None}
    return {"resident": resident, "out": next(iter(first.values())), "again": next(iter(second.values())),
            "segments": len(ex.segments), "crossed": crossed,
            "hbm": {k: v for k, v in ex.hbm_accounting().items() if not isinstance(v, list)}}


def pp_mesh_case(rank: int, device, text: str, weights, inputs, mesh: Dict[str, int], budget: int,
                 stages: int, **config) -> Dict[str, Any]:
    """The graph on ``stages`` pipeline stages of ``device`` at ``budget``
    (and the options in ``config``), under ``make_mesh(world, **mesh)`` and
    without a mesh, on this rank: both outputs, whether the sharding pass
    ran, the segments' stages and the gathers of the meshed run."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.sharding import make_mesh

    pp = [torch.device(device)] * stages
    plain = run_session(text, weights, inputs, device, hbm_budget_bytes=budget, pp_devices=pp, **config)[0]
    comm.STATS.reset()
    out, s = run_session(text, weights, inputs, device, mesh=make_mesh(dist.get_world_size(), **mesh),
                         hbm_budget_bytes=budget, pp_devices=pp, **config)
    ex = s._executor()
    return {"out": out, "plain": plain, "sharded": ex.mesh_info is not None, "gathers": comm.STATS.snapshot(),
            "stages": [ex.seg_stage(i) for i in range(len(ex.segments))]}


def train_case(rank, device, text: str, weights, inputs, mesh: Optional[Dict[str, int]], target=None,
               **config) -> Dict[str, Any]:
    """One ``make_train_step`` step of a graph's "out_sample" (MSE against
    ``target``, zeros by default) under ``make_mesh(world, **mesh)``, or on
    one device for ``mesh=None``: the loss, and per weight this rank's
    gradient, updated weight and AdamW moments (float32 numpy), its shard
    and whether tp slices it."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.sharding import make_mesh, make_train_step

    m = make_mesh(dist.get_world_size(), **mesh) if mesh is not None else None
    s = _session(text, weights, inputs, device, mesh=m, use_flash_attention=False, **config)
    ex = s._executor()
    step, init, placements = make_train_step(ex, "out_sample", m)
    params, opt = init(weights)
    if target is None:
        target = np.zeros(ex.mesh_info.global_avals["out_sample"].shape if m else ex.plan.avals["out_sample"].shape,
                          np.float32)
    comm.STATS.reset()
    params, opt, loss = step(params, opt, inputs, target)
    names = [w.name for w in ex.plan.arg_weights]

    def host(t):
        return t.detach().float().cpu().numpy()

    tp = m.mesh_dim_names.index("tp") if m is not None else None
    return {"loss": float(loss), "names": names,
            "grads": {n: host(p.grad) for n, p in zip(names, params)},
            "weights": {n: host(p) for n, p in zip(names, params)},
            "exp_avg": {n: host(opt.state[p]["exp_avg"]) for n, p in zip(names, params)},
            "exp_avg_sq": {n: host(opt.state[p]["exp_avg_sq"]) for n, p in zip(names, params)},
            "weight_shards": {w.name: w.shard for w in ex.plan.arg_weights},
            "tp_sharded": sum(not pl[tp].is_replicate() for pl in placements) if tp is not None else 0,
            "comm": comm.STATS.snapshot(), "mesh": dict(zip(m.mesh_dim_names, m.shape)) if m is not None else {}}


def collective_grad_case(rank, device, broken: bool = False) -> Dict[str, Any]:
    """The chain rule through the pass's collectives on a tp group, as the
    train step uses them: a weight W sharded on its columns (this rank's
    W_r), h_r = x @ W_r gathered into y = x @ W; a replicated weight V used
    whole (a = y @ V, replicated) and through this rank's column slice
    (e_r = y @ V[:, r], sharded); the global loss sum(a^2) + sum(e). Each
    rank's loss is its share (a counted once over the group), the gradient
    of V is summed over the group. Returns this rank's gradients of W_r and
    V. ``broken``: the gather's backward keeps this rank's block of its own
    gradient instead of the reduce-scatter (gradients then come out wrong)."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.ops import collective
    from onnxstream_tpu_torch.parallel import comm

    group, r, n = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    x, W, V = collective_grad_operands()
    cols, vcols = W.shape[1] // n, V.shape[1] // n
    w_r = W[:, r * cols:(r + 1) * cols].clone().to(device).requires_grad_(True)
    v = V.clone().to(device).requires_grad_(True)
    reduce_scatter = comm.reduce_scatter
    if broken:
        comm.reduce_scatter = lambda g, axis, group, dim="tp": g.narrow(axis, r * g.shape[axis] // n,
                                                                     g.shape[axis] // n)
    try:
        y = collective._Gather.apply(x.to(device) @ w_r, 1, group, "tp")
        a = y @ v
        e_r = y @ v.narrow(1, r * vcols, vcols)
        (a.square().sum() / n + e_r.sum()).backward()
    finally:
        comm.reduce_scatter = reduce_scatter
    gv = comm.all_reduce(v.grad, group, "tp")
    return {"grad_w": w_r.grad.cpu().numpy(), "grad_v": gv.cpu().numpy()}


def collective_grad_operands():
    """x, W, V of ``collective_grad_case`` (seeded)."""
    rng = np.random.RandomState(3)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32)) for shape in ((4, 8), (8, 6), (6, 4)))


def _graph_weight_bytes(pipe) -> int:
    """The weight bytes one (L, P) graph of the pipeline holds on the
    device (the largest: every graph reads the same weights)."""
    return max(ex.weight_bytes() for s in pipe._sessions.values() for ex in s._executors.values())


def llm_case(rank: int, device, mesh: Dict[str, int], decode_steps: int = 5, new_tokens: int = 6,
             compute_dtype: str = "float32", prompt: Sequence[int] = LLM_PROMPT, cfg=None,
             synthetic_on_device: bool = False, int8_weights: bool = False) -> Dict[str, Any]:
    """LLAMA_TINY (or ``cfg``; seed 0, buckets [8, 16, 32]) under
    ``make_mesh(world, **mesh)``: prefill, ``decode_steps`` stepwise decodes
    (the cache crosses bucket 8 -> 16), then ``generate_on_device`` after a
    reset."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.sharding import make_mesh

    m = make_mesh(dist.get_world_size(), **mesh)
    pipe = LlamaPipeline(cfg or LLAMA_TINY, buckets=list(LLM_BUCKETS), compute_dtype=compute_dtype, mesh=m,
                         device=torch.device(device), synthetic_on_device=synthetic_on_device,
                         int8_weights=int8_weights)
    comm.STATS.reset()
    steps = [pipe.forward(list(prompt))]
    kv_shape = tuple(pipe.kv[0].shape)
    for _ in range(decode_steps):
        steps.append(pipe.forward([steps[-1][0]]))
    out = {"steps": steps, "kv_shape": kv_shape, "cache_len": pipe.cache_len,
           "weight_bytes": _graph_weight_bytes(pipe), "gathers": comm.STATS.snapshot(),
           "mesh": dict(zip(m.mesh_dim_names, m.shape))}
    pipe.reset()
    out["generated"] = pipe.generate_on_device(list(prompt), max_new_tokens=new_tokens)
    out["generated_cache_len"] = pipe.cache_len
    return out


def llm_single(device, decode_steps: int = 5, new_tokens: int = 6, compute_dtype: str = "float32",
               prompt: Sequence[int] = LLM_PROMPT, cfg=None, synthetic_on_device: bool = False,
               int8_weights: bool = False) -> Dict[str, Any]:
    """``llm_case`` on one device, no mesh."""
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    pipe = LlamaPipeline(cfg or LLAMA_TINY, buckets=list(LLM_BUCKETS), compute_dtype=compute_dtype,
                         device=torch.device(device), synthetic_on_device=synthetic_on_device,
                         int8_weights=int8_weights)
    steps = [pipe.forward(list(prompt))]
    for _ in range(decode_steps):
        steps.append(pipe.forward([steps[-1][0]]))
    out = {"steps": steps, "cache_len": pipe.cache_len, "weight_bytes": _graph_weight_bytes(pipe)}
    pipe.reset()
    out["generated"] = pipe.generate_on_device(list(prompt), max_new_tokens=new_tokens)
    out["generated_cache_len"] = pipe.cache_len
    return out


def graphs_case(rank: int, device, graphs: List[Tuple[str, str, Dict[str, Any], Dict[str, Any]]],
                mesh: Dict[str, int]) -> Dict[str, Dict[str, Any]]:
    """(label, model.txt, weights, inputs) graphs under one
    ``make_mesh(world, **mesh)``: per label, every output ("out") and the
    run's gathers per mesh dim ("gathers")."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel import comm

    from onnxstream_tpu_torch.runtime.config import SessionConfig
    from onnxstream_tpu_torch.runtime.session import Session
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy
    from onnxstream_tpu_torch.parallel.sharding import make_mesh

    m = make_mesh(dist.get_world_size(), **mesh)
    out = {}
    for label, text, weights, inputs in graphs:
        s = Session(SessionConfig(device=torch.device(device), mesh=m),
                    weights_provider=DictWeightsProvider(params_from_numpy(weights)))
        s.read_string(text)
        for k, v in inputs.items():
            s.add_tensor(k, v)
        comm.STATS.reset()
        out[label] = {"out": s.run(), "gathers": comm.STATS.snapshot()}
    return out


def mesh_case(rank: int, device) -> Dict[str, Any]:
    """``make_mesh`` over this group: the default factorization's shape
    and the errors for a world size that is not the group's."""
    import torch.distributed as dist

    from onnxstream_tpu_torch.parallel.sharding import make_mesh

    n = dist.get_world_size()
    errors = []
    for wrong in (2 * n, n + 1):
        try:
            make_mesh(wrong, dp=1, tp=wrong)
        except ValueError as e:
            errors.append(str(e))
    m = make_mesh()
    return {"default": dict(zip(m.mesh_dim_names, m.shape)), "coordinate": list(m.get_coordinate()),
            "errors": errors}


CASES = {"unet": unet_case, "llm": llm_case, "graphs": graphs_case, "mesh": mesh_case, "train": train_case,
         "collective_grad": collective_grad_case, "session": session_case, "streamed": streamed_case,
         "pp_mesh": pp_mesh_case}


def rank_cases(rank: int, device, cases: List[Tuple[str, str, Dict[str, Any]]]) -> Dict[str, Any]:
    """Run (label, case, kwargs) in order on this rank: ``launch.spawn``'s
    function for a group that runs several cases."""
    return {label: CASES[case](rank, device, **kw) for label, case, kw in cases}


def dryrun_multichip(n_devices: int = 8, device: str = "cuda", backend: str = "nccl",
                     timeout_s: float = 300.0) -> Dict[str, float]:
    """Run the four paths on n ranks against one device and print a line
    for each; raise if one deviates (float32: only reassociation of the
    gathered products is tolerated, 1e-3 as the JAX dry run; the train
    step's loss within 1e-5 of one rank's). By default each rank drives a
    card of its own over NCCL."""
    from onnxstream_tpu_torch.parallel.launch import spawn

    if backend == "nccl":
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"dryrun_multichip: nccl needs CUDA devices, not {device!r} (--backend gloo)")
        cards = torch.cuda.device_count()
        if (dev.index is not None and n_devices > 1) or n_devices > cards:
            raise ValueError(f"dryrun_multichip: nccl needs a card a rank ({n_devices} ranks, {cards} cards, "
                             f"device {device!r}); ranks sharing a card need --backend gloo")
    batch = max(2, n_devices // 2)
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = dict(dp=dp, sp=2) if n_devices % 8 == 0 else dict(dp=dp)
    context_len = 16 if "sp" in mesh else 7
    text, weights = tiny_unet(batch, context_len)
    inputs = tiny_unet_inputs(batch, context_len)
    y0, _ = run_session(text, weights, inputs, device)
    tp_llm = 2 if n_devices % 2 == 0 else 1
    # the train step: JAX's mesh and its 7-token context
    text7, weights7 = (text, weights) if context_len == 7 else tiny_unet(batch)
    inputs7 = tiny_unet_inputs(batch)
    cases = [("train", "train", dict(text=text7, weights=weights7, inputs=inputs7, mesh=dict(dp=dp))),
             ("unet", "unet", dict(text=text, weights=weights, inputs=inputs, mesh=mesh)),
             ("llm", "llm", dict(mesh=dict(tp=tp_llm)))]
    ranks = spawn(rank_cases, n_devices, backend, device, timeout_s, args=(cases,))
    one = train_case(0, device, text7, weights7, inputs7, None)
    t0 = ranks[0]["train"]
    losses = [r["train"]["loss"] for r in ranks]
    print(f"dryrun_multichip: train step mesh={t0['mesh']} loss={t0['loss']:.6f} (one rank {one['loss']:.6f}) "
          f"tp-sharded weights: {t0['tp_sharded']}/{len(t0['names'])} dp batch={batch}")
    if not (np.isfinite(losses).all() and max(abs(x - one["loss"]) for x in losses) <= 1e-5 * abs(one["loss"])):
        raise AssertionError(f"train step: losses {losses} against one rank's {one['loss']}")
    r0 = ranks[0]["unet"]
    dev_sharded = max(float(np.abs(r["unet"]["out"] - y0).max()) for r in ranks)
    print(f"dryrun_multichip: sharded inference mesh={r0['mesh']} out={r0['out'].shape} "
          f"max|y|={np.abs(r0['out']).max():.4f} max|sharded-single|={dev_sharded:.2e} "
          f"(rank 0: {r0['hbm']['weight_bytes']} of {r0['hbm']['one_device_weight_bytes']} weight bytes, "
          f"{sum(g['calls'] for g in r0['gathers'].values())} gathers)")
    if not (np.isfinite(r0["out"]).all() and dev_sharded < 1e-3):
        raise AssertionError(f"sharded inference deviates from single-device: {dev_sharded}")
    if "sp" in mesh and not r0["gathers"].get("sp", {}).get("calls"):
        raise AssertionError("sequence parallelism sharded nothing: no gather over sp")

    stages = min(4, max(2, n_devices))
    y2, s2 = run_session(text, weights, inputs, device, hbm_budget_bytes=1 << 20,
                         pp_devices=[torch.device(device)] * stages)
    ex2 = s2._executor()
    used = {ex2.seg_stage(i) for i in range(len(ex2.segments))}
    dev_pp = float(np.abs(y2 - y0).max())
    print(f"dryrun_multichip: pipeline-parallel {len(ex2.segments)} segments over {len(used)} stages, "
          f"max|y|={np.abs(y2).max():.4f} max|pp-single|={dev_pp:.2e}")
    if not (np.isfinite(y2).all() and len(used) > 1 and dev_pp < 1e-3):
        raise AssertionError(f"pipeline-parallel deviates from single-device: {dev_pp}")

    ref = llm_single(device)
    got = ranks[0]["llm"]
    dev_llm = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(ref["steps"], got["steps"]))
    same = [a[0] for a in ref["steps"]] == [b[0] for b in got["steps"]] and ref["generated"] == got["generated"]
    print(f"dryrun_multichip: LLM tensor-parallel mesh={got['mesh']} kv shard {got['kv_shape']} "
          f"prefill + {len(got['steps']) - 1} decode steps max|logits-single|={dev_llm:.2e}, "
          f"tokens {'equal' if same else 'DIFFER'}, on-device decode {got['generated']}")
    if not (same and dev_llm < 2e-4):
        raise AssertionError(f"tensor-parallel LLM deviates from single-device: {dev_llm}, tokens equal {same}")
    return {"train_loss": t0["loss"], "sharded": dev_sharded, "pp": dev_pp, "llm": dev_llm}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda (a card a rank), cuda:0 (every rank on one card) or cpu")
    ap.add_argument("--backend", default="nccl", help="nccl (a card a rank), or gloo")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend, args.timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

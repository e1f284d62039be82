"""The multi-rank dry run: the sharded serving paths against one device.

Counterpart of ``__graft_entry__.py dryrun_multichip`` without its train
step (not ported yet). On n ranks (``launch.spawn``):

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


def run_session(text: str, weights, inputs: Dict[str, np.ndarray], device, **config) -> Tuple[np.ndarray, Any]:
    """One run of a graph through the port's Session: its first output as
    float32 numpy and the session."""
    from onnxstream_tpu_torch.runtime.config import SessionConfig
    from onnxstream_tpu_torch.runtime.session import Session
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    s = Session(SessionConfig(device=torch.device(device), **config),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, v in inputs.items():
        s.add_tensor(k, v)
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
    return out


def _graph_weight_bytes(pipe) -> int:
    """The weight bytes one (L, P) graph of the pipeline holds on the
    device (the largest: every graph reads the same weights)."""
    return max(ex.weight_bytes() for s in pipe._sessions.values() for ex in s._executors.values())


def llm_case(rank: int, device, mesh: Dict[str, int], decode_steps: int = 5, new_tokens: int = 6,
             compute_dtype: str = "float32", prompt: Sequence[int] = LLM_PROMPT, cfg=None,
             synthetic_on_device: bool = False) -> Dict[str, Any]:
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
                         device=torch.device(device), synthetic_on_device=synthetic_on_device)
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
               prompt: Sequence[int] = LLM_PROMPT, cfg=None, synthetic_on_device: bool = False) -> Dict[str, Any]:
    """``llm_case`` on one device, no mesh."""
    from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
    from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline

    pipe = LlamaPipeline(cfg or LLAMA_TINY, buckets=list(LLM_BUCKETS), compute_dtype=compute_dtype,
                         device=torch.device(device), synthetic_on_device=synthetic_on_device)
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


CASES = {"unet": unet_case, "llm": llm_case, "graphs": graphs_case, "mesh": mesh_case}


def rank_cases(rank: int, device, cases: List[Tuple[str, str, Dict[str, Any]]]) -> Dict[str, Any]:
    """Run (label, case, kwargs) in order on this rank: ``launch.spawn``'s
    function for a group that runs several cases."""
    return {label: CASES[case](rank, device, **kw) for label, case, kw in cases}


def dryrun_multichip(n_devices: int = 8, device: str = "cuda", backend: str = "nccl",
                     timeout_s: float = 300.0) -> Dict[str, float]:
    """Run the three paths on n ranks against one device and print a line
    for each; raise if one deviates (float32: only reassociation of the
    gathered products is tolerated, 1e-3 as the JAX dry run). By default
    each rank drives a card of its own over NCCL."""
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
    cases = [("unet", "unet", dict(text=text, weights=weights, inputs=inputs, mesh=mesh)),
             ("llm", "llm", dict(mesh=dict(tp=tp_llm)))]
    ranks = spawn(rank_cases, n_devices, backend, device, timeout_s, args=(cases,))
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
    return {"sharded": dev_sharded, "pp": dev_pp, "llm": dev_llm}


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

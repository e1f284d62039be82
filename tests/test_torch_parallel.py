"""The port's mesh rules and sharding pass, without starting ranks.

``parallel/sharding.py``'s rules are held to the JAX package's on the same
shapes: ``shard_weight_spec`` on every weight of the TINY UNet and
LLAMA_TINY at tp 1 / 2 / 4 / 8, ``activation_sharding`` and
``kv_head_sharding`` (indivisible shapes included) on the conftest's eight
virtual devices, and ``make_mesh``'s factorizations and errors. The sharding
pass (``parallel/spmd.py``) is run by the planner for one rank of a mesh
(``_RankMesh``: the attributes of a DeviceMesh the pass and the rules read,
so a plan can be made without a process group): every tensor of the
LLAMA_TINY prefill and decode graphs gets a placement at tp = 2 and no
``ostpu.all_gather`` lies between the q / k / v projections and attention.
The options a mesh once refused plan and run on one rank (its own blocks
standing in for the other rank's in a gather), and the pieces that make
them right are held here: the W8A8 producer lookup through a gather, one
device's QDQ skip set, the staged slices, no pass beside pipeline stages,
QDQ's strided sample and calibration's percentiles of the whole tensor.
The runs over spawned gloo ranks are ``tests/test_torch_sharded.py``.
"""

import dataclasses
import re
from typing import Tuple

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from onnxstream_tpu.models.llm.llama import LLAMA_TINY as JAX_LLAMA_TINY
from onnxstream_tpu.models.llm.llama import build_llama as jax_build_llama
from onnxstream_tpu.models.sd.unet import TINY as JAX_TINY
from onnxstream_tpu.models.sd.unet import build_unet as jax_build_unet
from onnxstream_tpu.parallel import sharding as jax_sharding
from onnxstream_tpu_torch.models.llm.llama import LLAMA_TINY
from onnxstream_tpu_torch.models.llm.pipeline import LlamaPipeline
from onnxstream_tpu_torch.parallel import LocalShard
from onnxstream_tpu_torch.parallel import sharding
from onnxstream_tpu_torch.parallel.dryrun import run_session, tiny_unet, tiny_unet_inputs
from test_torch_ops_card import op_case, rand

CPU = torch.device("cpu")


@dataclasses.dataclass
class _RankMesh:
    """One rank's view of a mesh, as the rules and the pass read it."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coordinate: Tuple[int, ...]

    def get_coordinate(self):
        return list(self.coordinate)

    def get_group(self, dim: str) -> str:
        """No process group: a test that runs a plan stands in for the
        gathers (``_own_blocks``)."""
        return dim


def _rank_mesh(coordinate=None, **sizes) -> _RankMesh:
    names = tuple(n for n in ("dp", "tp", "sp") if n in sizes)
    return _RankMesh(names, tuple(sizes[n] for n in names), tuple(coordinate or (0,) * len(names)))


def _jax_axes(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _port_axes(placements, names, ndim: int) -> tuple:
    out = [None] * ndim
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            out[p.dim] = name
        else:
            assert isinstance(p, Replicate)
    return tuple(out)


def _weight_shapes(model: str):
    if model == "unet":
        return [np.shape(w) for w in jax_build_unet(JAX_TINY).weights.values()]
    return [np.shape(w) for w in jax_build_llama(JAX_LLAMA_TINY, new_len=8, past=16).weights.values()]


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["unet", "llama"])
def test_shard_weight_spec_matches_jax(model, tp):
    shapes = _weight_shapes(model)
    assert len(shapes) > 20
    sharded = 0
    for shape in shapes:
        want = _jax_axes(jax_sharding.shard_weight_spec(shape, tp), len(shape))
        p = sharding.shard_weight_spec(shape, tp)
        got = _port_axes([p], ("tp",), len(shape))
        assert got == want, (shape, got, want)
        sharded += isinstance(p, Shard)
    assert sharded > 0 or tp == 8 and model == "llama"


MESHES = {"dp2tp4": dict(dp=2, tp=4), "dp8": dict(dp=8, tp=1), "tp2": dict(dp=1, tp=2),
          "dp2tp2sp2": dict(dp=2, tp=2, sp=2), "dp1tp4sp2": dict(dp=1, tp=4, sp=2)}
SHAPES = [(2, 4, 16, 16), (2, 7, 32), (2, 64, 32), (4, 16, 8), (1, 2, 16, 16), (1, 3, 16, 8), (1, 8),
          (8,), (2, 4, 16, 8), (3, 16, 16)]


def _jax_mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jax_sharding.make_mesh(n, **sizes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rule", ["activation_sharding", "kv_head_sharding"])
def test_activation_and_kv_rules_match_jax(rule, mesh):
    sizes = MESHES[mesh]
    jmesh = _jax_mesh(sizes)
    pmesh = _rank_mesh(**sizes)
    for shape in SHAPES:
        want = _jax_axes(getattr(jax_sharding, rule)(jmesh, shape).spec, len(shape))
        got = _port_axes(getattr(sharding, rule)(pmesh, shape), pmesh.mesh_dim_names, len(shape))
        assert got == want, (rule, mesh, shape, got, want)


FACTORS = [(8, None, None, 1), (8, 2, None, 1), (8, None, 2, 1), (8, 4, 2, 1), (8, 1, 8, 1), (4, None, None, 1),
           (2, 1, 2, 1), (6, None, None, 1), (1, None, None, 1), (8, 2, 2, 2), (8, None, None, 2),
           (8, 2, None, 2), (8, None, 4, 2)]


@pytest.mark.parametrize("n,dp,tp,sp", FACTORS)
def test_make_mesh_factorization_matches_jax(n, dp, tp, sp):
    jmesh = jax_sharding.make_mesh(n, dp=dp, tp=tp, sp=sp)
    want = (jmesh.shape["dp"], jmesh.shape["tp"])
    assert sharding._factor(n, dp, tp, sp) == want


ERRORS = [(8, 3, None, 1, "dp=3 does not divide"), (8, None, 3, 1, "tp=3 does not divide"),
          (8, None, None, 3, "sp=3 does not divide"), (8, 4, None, 4, "does not divide"),
          (8, 2, 2, 1, "!= n_devices"), (8, 2, 3, 2, "!= n_devices")]


@pytest.mark.parametrize("n,dp,tp,sp,match", ERRORS)
def test_make_mesh_errors_match_jax(n, dp, tp, sp, match):
    with pytest.raises(ValueError, match=re.escape(match)):
        jax_sharding.make_mesh(n, dp=dp, tp=tp, sp=sp)
    with pytest.raises(ValueError, match=re.escape(match)):
        sharding.make_mesh(n, dp=dp, tp=tp, sp=sp)


def test_make_mesh_needs_a_process_group_and_train_step_is_not_ported():
    """No group: the error names the launchers (JAX names XLA_FLAGS); the
    port never makes a CPU mesh by itself. The train step is ported: it
    takes an executor planned under the mesh it is given (or none), and
    refuses one planned otherwise, naming SessionConfig(mesh=...)."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        sharding.make_mesh(2)
    text, weights = tiny_unet(2)
    s = _session_planned(text, weights, None, use_flash_attention=False)
    with pytest.raises(ValueError, match=re.escape("SessionConfig(mesh=mesh)")):
        sharding.make_train_step(s._executor(), "out_sample", _rank_mesh(dp=1, tp=2))


def _planned_llama(L: int, P: int, coordinate: int):
    """One rank's plan of an LLAMA_TINY (L, P) graph at tp = 2."""
    mesh = _rank_mesh(coordinate=(0, coordinate), dp=1, tp=2)
    pipe = LlamaPipeline(LLAMA_TINY, buckets=[8, 16, 32], mesh=mesh, device=CPU)
    s = pipe._session(L, P)
    s.add_tensor("input_5F_ids", np.zeros((1, L), np.int64))
    s.add_tensor("position_5F_ids", np.zeros((1, L), np.int64))
    s.add_tensor("last_5F_pos", np.zeros(1, np.int64))
    if P:
        s.add_tensor("cache_5F_len", np.array([4], np.int64))
        hd = LLAMA_TINY.head_dim
        for i in range(2 * LLAMA_TINY.layers):
            local = torch.zeros(1, LLAMA_TINY.kv_heads // 2, P, hd)
            s.add_tensor(f"pkv{i}", LocalShard(local, (1, LLAMA_TINY.kv_heads, P, hd)))
    return s._executor()


def _ancestors(graph, names):
    producer = {t.name: op for op in graph.ops for t in op.outputs if t.name}
    seen, todo = set(), list(names)
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.add(n)
        op = producer.get(n)
        if op is not None:
            todo.extend(t.name for t in op.inputs if t.name and not t.is_weight)
    return seen


@pytest.mark.parametrize("coordinate", [0, 1])
@pytest.mark.parametrize("L,P", [(8, 0), (1, 16)])
def test_llama_tp2_placements_and_no_gather_before_attention(L, P, coordinate):
    ex = _planned_llama(L, P, coordinate)
    info, graph, plan = ex.mesh_info, ex.graph, ex.plan
    # every device tensor of the whole graph has a placement, and its local
    # shape is the global one divided on the sharded axis
    device_outs = [t.name for op in graph.ops if not op.op_type.startswith("ostpu.")
                   for t in op.outputs if t.name and t.name in info.global_avals]
    assert device_outs
    for name in device_outs:
        pmap = info.placements[name]
        want = list(info.global_avals[name].shape)
        for axis, dim in pmap.items():
            assert dim == "tp"
            want[axis] //= 2
        assert tuple(plan.avals[name].shape) == tuple(want), name
    ops = {op.name: op for op in graph.ops}
    for layer in range(LLAMA_TINY.layers):
        nm = f"model.layers.{layer}"
        for proj in ("q_proj", "k_proj", "v_proj"):
            assert info.placements[f"{nm}.self_attn.{proj}/MatMul_out"] == {2: "tp"}
            w = next(w for w in plan.arg_weights if w.name == f"{nm}.self_attn.{proj}.weight.bin")
            n = w.file_shape[1] // 2
            assert w.shard == ((1, coordinate * n, (coordinate + 1) * n),)
        sdpa = ops[f"{nm}/pv_sdpa"]
        for t in sdpa.inputs[:3]:
            assert info.placements[t.name] == {1: "tp"}, t.name
        assert info.placements[sdpa.outputs[0].name] == {1: "tp"}
        # no gather between the projections and attention
        proj_outs = {f"{nm}.self_attn.{p}/MatMul_out" for p in ("q_proj", "k_proj", "v_proj")}
        feeding = _ancestors(graph, [t.name for t in sdpa.inputs if t.name])
        gathers = [op.name for op in graph.ops if op.op_type == "ostpu.all_gather"
                   and op.outputs[0].name in feeding and _ancestors(graph, [op.inputs[0].name]) & proj_outs]
        assert gathers == []
        # the cache leaves as this rank's head shard
        assert info.local_outputs[f"opkv{2 * layer}"] == {1: "tp"}
        assert tuple(plan.avals[f"opkv{2 * layer}"].shape) == (1, 1, P or L, LLAMA_TINY.head_dim)
    if P:
        # the KV write's indices: this rank's rows, its head block's offset taken off
        scat = ops["model.layers.0/scatk"]
        assert scat.inputs[1].name != "kvw/indices_out"
        assert info.placements["model.layers.0/scatk_out"] == {0: "tp"}
    for name in plan.fetch_names:  # everything else leaves whole
        if not name.startswith("opkv"):
            assert not info.placements.get(name) or name in info.fetch_alias, name


def test_packed_attention_heads_become_local():
    """The TINY UNet at tp = 2: the packed sdpa sites take their local head
    count and q / k / v arrive sharded on their last axis; the rank holds
    the replicated weights and half of the sharded ones."""
    text, weights = tiny_unet(2)
    s = _session_planned(text, weights, _rank_mesh(coordinate=(0, 1), dp=1, tp=2))
    ex = s._executor()
    sdpa = [op for op in ex.graph.ops if op.op_type == "ostpu.sdpa"]
    assert sdpa and all(op.attr_int("heads") == 1 for op in sdpa)
    for op in sdpa:
        for t in op.inputs[:3]:
            assert ex.mesh_info.placements.get(t.name) == {2: "tp"}, (op.name, t.name)
    acc = ex.hbm_accounting()
    assert acc["replicated_weight_bytes"] + 2 * acc["sharded_weight_bytes"] == acc["one_device_weight_bytes"]


def _session_planned(text, weights, mesh, **config):
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    s = Session(SessionConfig(device=CPU, mesh=mesh, **config),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, v in tiny_unet_inputs(2).items():
        s.add_tensor(k, v)
    return s


OPTIONS = [dict(hbm_budget_bytes=1 << 20), dict(use_uint8_arithmetic=True), dict(use_uint8_qdq=True),
           dict(range_data_calibrate=True), dict(hbm_budget_bytes=1 << 20, pp_devices=[CPU, CPU])]


def _own_blocks(x, axis, group, dim="tp"):
    """A gather over a mesh dim of ``group`` ranks with no other rank: this
    rank's block stands in for each of theirs."""
    return torch.cat([x] * 2, axis)


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "+".join(o))
def test_mesh_plans_and_runs_every_option(options, monkeypatch):
    """A budget, pipeline stages, the calibrated W8A8 and QDQ options and
    calibration plan and run under a mesh (one rank of make_mesh(2, dp=1,
    tp=2), no process group: the other rank's blocks are this rank's own, so
    the values are not checked here but on two ranks in
    tests/test_torch_sharded.py). Nothing falls back to a one-device run: a
    budget streams the rank's slices in several segments, QDQ's percentiles
    and calibration gather the whole tensors, calibration records no name
    the pass made, and pipeline stages take the sharding pass's place."""
    from onnxstream_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "all_gather", _own_blocks)
    text, weights = tiny_unet(2)
    s = _session_planned(text, weights, _rank_mesh(dp=1, tp=2), **options)
    out = s.run()["out_sample"]
    assert out.shape == (2, 4, 16, 16) and np.isfinite(out).all()
    ex = s._executor()
    if "pp_devices" in options:
        assert ex.mesh_info is None and not any(op.op_type.startswith("ostpu.all_") for op in ex.graph.ops)
        return
    assert any(w.shard for w in ex.plan.arg_weights) and ex.mesh_info.pass_ops
    if "hbm_budget_bytes" in options:
        assert ex.streamed and len(ex.segments) > 1
        assert ex.hbm_accounting()["weight_bytes"] < ex.mesh_info.global_weight_bytes
    if "range_data_calibrate" in options:
        names = {op.name for op in ex.graph.ops if op.name not in ex.mesh_info.pass_ops}
        ranges = ex.range_data.data
        assert "sample" in ranges and len(ranges) > 20
        assert all("@" not in k and (k in names or k in ex.plan.input_avals) for k in ranges)


def _planned_graph(text, weights, inputs, mesh, **config):
    """A Session of the graph with its inputs pushed, under ``mesh``."""
    from onnxstream_tpu_torch import Session, SessionConfig
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider, params_from_numpy

    s = Session(SessionConfig(device=CPU, mesh=mesh, **config),
                weights_provider=DictWeightsProvider(params_from_numpy(weights)))
    s.read_string(text)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    return s


@pytest.mark.parametrize("coordinate", [0, 1])
def test_w8a8_conv_finds_its_producer_through_a_gather(coordinate):
    """The two-conv net at widths tp = 2 shards (32, 16): c2's input is c1's
    tp-sharded output gathered by the pass (a tensor named by the pass), yet
    c2 quantizes it with the range of m1, the op of the graph that made it,
    as one device does; c1's input, a graph input, with its own range. Both
    convs take kernel 4 on this rank's O / 2 weight channels, c2's (C = 32)
    uploaded channels-last (its slice relayouted, not made contiguous
    again), c1's (C = 4) in the file layout."""
    from onnxstream_tpu_torch.runtime.quantization import range_to_scale
    from test_torch_qlinear import _two_conv_net

    _, _, qmodel, qweights, x = _two_conv_net(32, 16)
    ranges = {"x": (-3.0, 3.5), "c1": (-7.0, 6.0), "s1": (0.0, 1.0), "m1": (-0.3, 5.0), "c2": (-9.0, 8.0)}
    s = _planned_graph(qmodel, qweights, {"x": x}, _rank_mesh(coordinate=(0, coordinate), dp=1, tp=2),
                       use_uint8_arithmetic=True, range_data=ranges)
    ex = s._executor()
    ops = {op.name: op for op in ex.graph.ops}
    gathered = ops["c2"].inputs[0].name
    assert "@" in gathered and ex._origin[gathered] == "hm" and ex._producer_op["hm"] == "m1"
    assert ex.quant_routes == {"c1": "qconv", "c2": "qconv"}
    assert ex._activation_qparams(ops["c2"]) == range_to_scale(*ranges["m1"])
    assert ex._activation_qparams(ops["c1"]) == range_to_scale(*ranges["x"])
    for name, o, transform in (("w1.bin", 32, None), ("w2.bin", 16, "ohwi")):
        w = ex._arg_by_name[name]
        assert w.transform == transform and w.shape[0] == o // 2 and w.file_shape[0] == o
        assert w.shard == ((0, coordinate * o // 2, (coordinate + 1) * o // 2),)
    # the channels-last slice kernel 4's wgmma variant takes, the slice of the file's weight
    up = ex._upload(ex._arg_by_name["w2.bin"])
    assert up.is_contiguous(memory_format=torch.channels_last) and not up.is_contiguous()
    assert torch.equal(up, torch.from_numpy(qweights["w2.bin"][coordinate * 8:(coordinate + 1) * 8]))


def test_qdq_skip_set_is_one_devices():
    """use_uint8_qdq on the TINY VAE decoder at tp = 2: the skip set is the
    one-device executor's (the graph's own adjacency and reference counts),
    not the one the rank's graph would give with the pass's gathers and
    slices between producers and consumers."""
    from onnxstream_tpu_torch.models.sd.vae import VAE_TINY, build_vae_decoder
    from onnxstream_tpu_torch.runtime.quantization import qdq_skip

    g = build_vae_decoder(VAE_TINY, seed=7)
    z = {"latent": np.random.RandomState(42).randn(1, 4, 8, 8).astype(np.float32)}
    one = _planned_graph(g.to_text(), g.weights, z, None, use_uint8_qdq=True)._executor()
    ex = _planned_graph(g.to_text(), g.weights, z, _rank_mesh(dp=1, tp=2), use_uint8_qdq=True)._executor()
    assert ex.mesh_info.pass_ops and len(one._qdq_skip) > 10
    assert ex._qdq_skip == one._qdq_skip
    assert qdq_skip(ex.graph) != one._qdq_skip


def test_sharded_weights_stage_their_slices():
    """The TINY UNet at a 1 MiB budget on one rank of tp = 2: a sharded
    weight never crosses as the whole file's bytes; its part of a staging
    buffer is its slice's upload bytes, half the whole weight's, so the
    rank crosses about half of one device's bytes, in fewer segments (the
    budget is per rank)."""
    from onnxstream_tpu_torch.runtime.executor import STAGING_ALIGN, upload_bytes

    text, weights = tiny_unet(2)
    ex = _session_planned(text, weights, _rank_mesh(dp=1, tp=2), hbm_budget_bytes=1 << 20)._executor()
    one = _session_planned(text, weights, None, hbm_budget_bytes=1 << 20)._executor()
    sharded = [w for w in ex.plan.arg_weights if w.shard]
    assert len(sharded) > 20
    for w in sharded:
        whole = int(np.prod(w.file_shape)) * w.upload_dtype.itemsize
        assert not ex._crosses_as_file_bytes(w)
        assert ex._staged_bytes(w) == -(-upload_bytes(w) // STAGING_ALIGN) * STAGING_ALIGN
        assert 2 * upload_bytes(w) == whole
    crossed = [sum(e._staged_bytes(w) for w in e.plan.arg_weights) for e in (ex, one)]
    assert crossed[0] < 0.6 * crossed[1]
    assert 1 < len(ex.segments) < len(one.segments)


def test_mesh_beside_pipeline_stages_runs_no_sharding_pass():
    """mesh + pp_devices: the stages hold whole weights, so the planner
    skips the pass: no gather, no slice, no sharded weight, the graph of
    the unsharded staged plan."""
    text, weights = tiny_unet(2)
    pp = dict(hbm_budget_bytes=1 << 20, pp_devices=[CPU, CPU])
    ex = _session_planned(text, weights, _rank_mesh(coordinate=(0, 1), dp=1, tp=2), **pp)._executor()
    one = _session_planned(text, weights, None, **pp)._executor()
    assert ex.mesh_info is None and not any(w.shard for w in ex.plan.arg_weights)
    assert [op.name for op in ex.graph.ops] == [op.name for op in one.graph.ops]
    assert len({ex.seg_stage(i) for i in range(len(ex.segments))}) == 2


# (whole shape, {axis: mesh dim}, mesh sizes): strides 3 and 2 over the flattening; then three of the
# full-width VAE_SD decoder's channel- and feature-sharded activations at tp = 2 (strides 2, 32 and 2)
SAMPLES = [((3200, 1000), {1: "tp"}, {"tp": 2}), ((2, 1600, 1000), {0: "dp", 2: "tp"}, {"dp": 2, "tp": 2}),
           ((2, 8, 411, 333), {1: "tp"}, {"tp": 4}), ((64, 32), {1: "tp"}, {"tp": 2}),
           ((1, 512, 64, 64), {1: "tp"}, {"tp": 2}), ((1, 128, 512, 512), {1: "tp"}, {"tp": 2}),
           ((1, 4096, 512), {2: "tp"}, {"tp": 2})]


@pytest.mark.parametrize("shape,pmap,sizes", SAMPLES)
def test_global_sample_is_one_devices_strided_sample(shape, pmap, sizes, monkeypatch):
    """QDQ's percentiles with no range under a mesh: each rank's padded
    share of the strided subsample, gathered (here: every rank's share
    concatenated), sorts to the strided subsample one device takes of the
    whole tensor (``xf[::n // 2^20]``), NaN padding last."""
    import itertools

    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.spmd import MeshInfo
    from onnxstream_tpu_torch.runtime.executor import Executor

    whole = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
    names = tuple(sizes)
    shares = []

    class _Taken(Exception):
        pass

    def take(x, axis, group, dim="tp"):
        shares.append(x)
        raise _Taken

    monkeypatch.setattr(comm, "all_gather", take)
    for coord in itertools.product(*(range(sizes[d]) for d in names)):
        ex = Executor.__new__(Executor)
        ex.config = dataclasses.replace(_session_config(), mesh=_rank_mesh(coordinate=coord, **sizes))
        ex.mesh_info = MeshInfo(input_shapes={"t": shape}, fetch_alias={}, local_outputs={},
                                placements={"t": pmap}, weight_placements={}, global_avals={}, global_weight_bytes=0,
                                sizes=dict(sizes), coord=dict(zip(names, coord)))
        local = whole
        for axis, start, stop in ex.mesh_info.slices("t"):
            local = local.narrow(axis, start, stop - start)
        with pytest.raises(_Taken):
            ex._global_sample("t", local)
    n = whole.numel()
    want = torch.sort(whole.reshape(-1)[:: max(n // (1 << 20), 1)]).values
    got = torch.sort(torch.cat(shares)).values
    assert len({s.numel() for s in shares}) == 1
    assert torch.equal(got[:want.numel()], want) and torch.isnan(got[want.numel():]).all()


# (whole tensor, sharded axis, ranks): one rank holding every extreme; non-finite values; a tensor
# of one finite value; a block with no finite value
PERCENTILE_CASES = {
    "tp2": (np.random.RandomState(2).randn(64, 3000).astype(np.float32), 1, 2),
    "tp4_skewed": (np.concatenate([np.random.RandomState(3).randn(4, 500).astype(np.float32) * s
                                   for s in (1, 1, 1, 1000)], 0), 0, 4),
    "nonfinite": (np.where(np.random.RandomState(4).rand(8, 40) < 0.1, np.nan,
                           np.random.RandomState(5).randn(8, 40)).astype(np.float32), 0, 2),
    "one_finite": (np.array([[np.inf, np.nan], [np.nan, 2.5]], np.float32), 0, 2)}


@pytest.mark.parametrize("case", list(PERCENTILE_CASES))
def test_calibration_percentiles_are_the_whole_tensors(case, monkeypatch):
    """Calibration under a mesh: each rank gathers its block's finite count
    and its k + 1 smallest and largest finite values (``_percentiles``); the
    ranks' results are ``percentiles`` of the whole tensor, exactly. The
    ranks run in threads here, their gathers concatenating every rank's
    operand in rank order."""
    import threading

    from onnxstream_tpu_torch.parallel import comm
    from onnxstream_tpu_torch.parallel.spmd import MeshInfo
    from onnxstream_tpu_torch.runtime.executor import Executor, percentiles

    whole, axis, parts = PERCENTILE_CASES[case]
    whole = torch.from_numpy(whole)
    slots, barrier = [None] * parts, threading.Barrier(parts)
    rank_of = {}

    def gather(x, axis_, group, dim="tp"):
        r = rank_of[threading.get_ident()]
        slots[r] = x
        barrier.wait()
        out = torch.cat(list(slots), axis_)
        barrier.wait()
        return out

    monkeypatch.setattr(comm, "all_gather", gather)
    got = [None] * parts

    def rank(r):
        rank_of[threading.get_ident()] = r
        ex = Executor.__new__(Executor)
        ex.config = dataclasses.replace(_session_config(), mesh=_rank_mesh(coordinate=(r,), tp=parts))
        ex.mesh_info = MeshInfo(input_shapes={"t": tuple(whole.shape)}, fetch_alias={}, local_outputs={},
                                placements={"t": {axis: "tp"}}, weight_placements={}, global_avals={},
                                global_weight_bytes=0, sizes={"tp": parts}, coord={"tp": r})
        (_, start, stop), = ex.mesh_info.slices("t")
        got[r] = ex._percentiles("t", whole.narrow(axis, start, stop - start))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(parts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [percentiles(whole)] * parts


def _session_config():
    from onnxstream_tpu_torch import SessionConfig

    return SessionConfig(device=CPU)


def test_llm_int8_weights_with_a_mesh_raise():
    """They no longer raise: under tp = 2 every int8 MatMul weight of the
    LLAMA_TINY prefill takes Shard(1) on its file layout's N, uploads
    K-major as this rank's (N / 2, K) slice of the whole (K, N), and the
    quantized MatMul's activation stays whole on K, so kernel 6 quantizes
    its rows over the whole K."""
    mesh = _rank_mesh(coordinate=(0, 1), dp=1, tp=2)
    pipe = LlamaPipeline(LLAMA_TINY, buckets=[8, 16, 32], int8_weights=True, mesh=mesh, device=CPU)
    s = pipe._session(8, 0)
    s.add_tensor("input_5F_ids", np.zeros((1, 8), np.int64))
    s.add_tensor("position_5F_ids", np.zeros((1, 8), np.int64))
    s.add_tensor("last_5F_pos", np.zeros(1, np.int64))
    ex = s._executor()
    routes = ex.quant_routes
    assert routes and set(routes.values()) == {"w8a8_dyn_matmul"}
    sharded = 0
    for op in ex.graph.ops:
        if op.name not in routes:
            continue
        w = ex._arg_by_name[op.inputs[1].name]
        k, n = w.file_shape
        assert w.transform == "tnk" and w.upload_dtype == torch.int8
        assert ex.mesh_info.placements.get(op.inputs[0].name, {}).get(len(op.inputs[0].shape) - 1) is None
        if w.shard:
            assert ex.mesh_info.weight_placements[w.name] == {1: "tp"}
            assert w.shard == ((1, n // 2, n),) and w.shape == (n // 2, k)
            sharded += 1
        else:
            assert w.shape == (n, k)
    assert sharded >= 4 * LLAMA_TINY.layers


def test_mesh_takes_weights_quantized_at_fetch():
    """force_uint8_storage_set under tp = 2: a rank's quantized weights are
    the slices of the one-device ones, bit for bit, with their scale and
    zero vectors: symmetric s8 and per-channel u8 2-D weights on their
    columns (quantized as slices), a per-tensor u8 4-D conv kernel on its
    output channels (quantized whole, then sliced), each weight quantized
    once."""
    from onnxstream_tpu_torch import SessionConfig
    from onnxstream_tpu_torch.dtypes import DType
    from onnxstream_tpu_torch.runtime.executor import Executor
    from onnxstream_tpu_torch.runtime.planner import WeightArg
    from onnxstream_tpu_torch.runtime.weights import DictWeightsProvider

    rng = np.random.RandomState(5)
    arrays = {"mm": rng.randn(96, 64).astype(np.float32), "conv": rng.randn(32, 8, 3, 3).astype(np.float32)}
    forms = [("mm", "s8", dict(int8_symmetric_storage=True)), ("mm", "u8c", dict(uint8_per_channel=True)),
             ("conv", "u8", {})]
    for name, form, cfg in forms:
        whole_shape = arrays[name].shape
        axis = 1 if name == "mm" else 0
        n = whole_shape[axis]

        def quantized(shard):
            ex = Executor.__new__(Executor)
            ex.config = SessionConfig(device=CPU, force_uint8_storage_set={name}, **cfg)
            ex.device, ex.quantize_seconds, ex.host_conversions = CPU, 0.0, 0
            ex.provider = DictWeightsProvider({name: torch.from_numpy(arrays[name])})
            symmetric = form == "s8"
            local = tuple(n // 2 if a == axis and shard else d for a, d in enumerate(whole_shape))
            w = WeightArg(name, DType.float32, torch.int8 if symmetric else torch.uint8, local, quant=(0.0, 0),
                          symmetric=symmetric, file_shape=whole_shape if shard else None, shard=shard)
            return ex._host_weight(w), w.quant

        q0, (s0, z0) = quantized(None)
        for r in range(2):
            q, (scale, zero) = quantized(((axis, r * n // 2, (r + 1) * n // 2),))
            block = slice(r * n // 2, (r + 1) * n // 2)
            want = q0[:, block] if axis == 1 else q0[block]
            assert torch.equal(q, want), (name, form, r)
            if form == "u8":
                assert (scale, zero) == (s0, z0)
            else:
                assert torch.equal(scale, s0[block]), (name, form, r)
                if form == "u8c":
                    assert torch.equal(zero, z0[block]), (name, form, r)


def test_one_rank_mesh_is_the_unsharded_run():
    """make_mesh(1)'s shape: the pass places nothing and puts in no gather;
    the output equals the run without a mesh bit for bit."""
    text, weights = tiny_unet(2)
    y0, _ = run_session(text, weights, tiny_unet_inputs(2), CPU)
    s = _session_planned(text, weights, _rank_mesh(dp=1, tp=1))
    y1 = s.run()["out_sample"]
    ex = s._executor()
    assert not any(op.op_type.startswith("ostpu.all_gather") for op in ex.graph.ops)
    assert not any(ex.mesh_info.placements.values())
    np.testing.assert_array_equal(y0, y1)


def _sdpa_case(shape, causal, heads=0, seed=0):
    qkv = {n: rand(*shape, seed=seed + i) for i, n in enumerate("qkv")}
    attrs = {"causal": int(causal)}
    if heads:
        attrs["heads"] = heads
    return op_case("ostpu.sdpa", qkv, {}, [shape], attrs=attrs)


# attention over inputs that sp = 2 shards on their rows (axis 1, 16 >= 2 * 8):
# packed (B, M, H*D) and head-major (H, M, D) with its heads over dp
SDPA_SP_CASES = {"packed_causal": _sdpa_case((2, 16, 32), True, heads=2),
                 "packed": _sdpa_case((2, 16, 32), False, heads=2),
                 "headmajor_causal": _sdpa_case((2, 16, 8), True, seed=3)}


@pytest.mark.parametrize("coordinate", [(0, 0, 0), (1, 1, 1)])
@pytest.mark.parametrize("case", list(SDPA_SP_CASES))
def test_sdpa_keeps_causal_query_rows_whole_under_sp(case, coordinate):
    """q arrives sharded on its rows over sp. Without a causal mask each rank
    attends its own rows to the gathered keys; a causal mask counts rows from
    the first, so q is gathered over sp first and the result is whole on its
    rows."""
    from onnxstream_tpu_torch import Session, SessionConfig

    text, inputs, _ = SDPA_SP_CASES[case]
    s = Session(SessionConfig(device=CPU, mesh=_rank_mesh(coordinate=coordinate, dp=2, tp=2, sp=2)))
    s.read_string(text)
    for k, v in inputs.items():
        s.add_tensor(k, v)
    ex = s._executor()
    info = ex.mesh_info
    assert info.placements["q"].get(1) == "sp"
    sdpa = next(op for op in ex.graph.ops if op.op_type == "ostpu.sdpa")
    q_in, k_in = sdpa.inputs[0].name, sdpa.inputs[1].name
    assert info.placements.get(k_in, {}).get(1) is None, "keys are whole on their rows"
    gathered_sp = [op for op in ex.graph.ops if op.op_type == "ostpu.all_gather" and op.attr("dim") == "sp"]
    assert gathered_sp
    rows = info.placements.get(q_in, {}).get(1)
    out_rows = info.placements[sdpa.outputs[0].name].get(1)
    if "causal" in case:
        assert rows is None and out_rows is None
    else:
        assert rows == "sp" and out_rows == "sp"


def test_dry_run_and_spawn_default_to_the_card():
    """The dry run drives a card a rank over NCCL unless the CPU and gloo
    are asked for; ``spawn`` takes its backend and device from the caller."""
    import inspect

    from onnxstream_tpu_torch.parallel import dryrun, launch

    params = inspect.signature(dryrun.dryrun_multichip).parameters
    assert (params["device"].default, params["backend"].default) == ("cuda", "nccl")
    params = inspect.signature(launch.spawn).parameters
    assert params["backend"].default is params["device"].default is inspect.Parameter.empty
    with pytest.raises(ValueError, match="nccl needs CUDA devices"):
        dryrun.main(["2", "--device", "cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--backend gloo"):
            dryrun.dryrun_multichip(2)

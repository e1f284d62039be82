"""Session — the user-facing model runtime.

Counterpart of ``onnxstream_tpu/runtime/session.py``, with the same public
surface: read_file / read_string, add_tensor, run, get_tensor, set_option,
add_extra_output. One Session owns one parsed Graph and builds one Plan +
Executor per input-shape bucket; repeated shapes reuse the cached executor
(and its resident device weights).

``SessionConfig.device`` names the device; left at None it is the first CUDA
card, and with no card the Session raises: it runs on the CPU only when
asked to (``torch.device("cpu")``). Under ``SessionConfig.mesh`` a Session
is one rank's: its plans are this rank's share (``parallel/spmd.py``), keyed
by the mesh's shape and the rank's coordinates beside the input shapes, and
an input may be pushed as this rank's ``LocalShard``.

On a CUDA device an executor's second ``run`` captures each of its segments
into a CUDA graph, streamed and staged ones included, and later runs replay
them (``runtime/executor.py``, the counterpart of the JAX session's
compiled segments); ``run(eager=True)`` stays the per-op oracle.
``graph_pool`` is the memory pool the executors' graphs allocate from: None
gives each executor its own (one for all its segments), and the pipelines
hand their sessions one pool (``share_graph_pool``), since their runs never
overlap.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from onnxstream_tpu_torch.dtypes import DType, dtype_name
from onnxstream_tpu_torch.ir import Graph, parse_model_txt
from onnxstream_tpu_torch.ops import registered_ops
from onnxstream_tpu_torch.parallel import LocalShard
from onnxstream_tpu_torch.runtime.config import SessionConfig, default_device
from onnxstream_tpu_torch.runtime.executor import Executor
from onnxstream_tpu_torch.runtime.fusion import fuse_attention, fuse_gn_conv, fuse_groupnorm, rewrite_smallconv
from onnxstream_tpu_torch.runtime.layout import rewrite_nhwc
from onnxstream_tpu_torch.runtime.planner import ShapeDtype, plan_graph
from onnxstream_tpu_torch.runtime.weights import CollectNamesWeightsProvider, WeightsProvider, make_provider


class Session:
    def __init__(
        self,
        config: Optional[SessionConfig] = None,
        weights_provider: Optional[WeightsProvider] = None,
        weights_provider_name: str = "ram+prefetch",
    ):
        self.config = config or SessionConfig()
        if self.config.device is None:
            self.config.device = default_device()
        self._provider = weights_provider
        self._provider_name = weights_provider_name
        self.graph: Optional[Graph] = None
        self._raw_graph: Optional[Graph] = None
        self._weights_dir = ""
        self.tensors: Dict[str, Any] = {}
        self._executors: Dict[Tuple, Executor] = {}
        self._last_outputs: Dict[str, Any] = {}
        # CUDA-graph memory pool of this session's executors (None: each its own)
        self.graph_pool = None

    # ------------------------------------------------------------------ load
    def read_file(self, path: str) -> None:
        with open(path) as f:
            text = f.read()
        self._weights_dir = os.path.dirname(os.path.abspath(path)) + os.sep
        self._load(text)

    def read_string(self, text: str, weights_dir: str = "") -> None:
        if weights_dir:
            self._weights_dir = weights_dir.rstrip(os.sep) + os.sep
        self._load(text)

    def _load(self, text: str) -> None:
        self._raw_graph = parse_model_txt(text, allow_dynamic=self.config.support_dynamic_shapes)
        self._rebuild_graph()

    def _rebuild_graph(self) -> None:
        """Graph-level rewrites from the raw parse: attention fusion, the
        GroupNorm fusions and the small-conv rewrite, then the channel-last
        layout pass (runtime/layout.py), in the JAX package's order. Re-run
        whenever options or extra outputs change: the passes read the config,
        and the layout pass keeps every extra output fetchable in NCHW."""
        self.graph = fuse_attention(self._raw_graph, self.config, self._loader)
        # the conv-absorbing fusion first: fuse_groupnorm takes what it leaves
        self.graph = fuse_gn_conv(self.graph, self.config, self._loader)
        self.graph = rewrite_smallconv(self.graph, self.config, self._loader)
        self.graph = fuse_groupnorm(self.graph, self.config, self._loader)
        self.graph = rewrite_nhwc(self.graph, self.config, keep_names=self.config.extra_outputs)
        self._executors.clear()

    @property
    def provider(self) -> WeightsProvider:
        if self._provider is None:
            self._provider = make_provider(self._provider_name, self._weights_dir)
        return self._provider

    def _loader(self, name: str, dtype: DType, shape):
        """Direct weight load for the planner's static pins and the fusion
        pass's scalars; goes through the provider so its caches are honored."""
        return self.provider.get(name, dtype, shape)

    # --------------------------------------------------------------- tensors
    def add_tensor(self, name: str, data) -> None:
        """Push a graph input: a numpy array, or a torch tensor (kept as is,
        e.g. a device tensor fed back from an earlier run), or under a mesh a
        ``LocalShard`` (this rank's shard of the input and its whole shape)."""
        self.tensors[name] = data if isinstance(data, (torch.Tensor, LocalShard)) else np.asarray(data)

    def clear_tensors(self) -> None:
        self.tensors.clear()

    def set_option(self, name: str, value: bool) -> None:
        """String-keyed option setter (the bindings' model_set_option surface).
        Fusion-gating options apply at graph-rewrite time, so the graph is
        re-fused from the raw parse and executors are dropped."""
        self.config.set_option(name, value)
        if self._raw_graph is not None:
            self._rebuild_graph()
        self._executors.clear()

    def add_extra_output(self, name: str) -> None:
        if name not in self.config.extra_outputs:
            self.config.extra_outputs.append(name)
        if self._raw_graph is not None:
            self._rebuild_graph()
        self._executors.clear()

    def get_tensor(self, name: str):
        if name in self._last_outputs:
            return self._last_outputs[name]
        if name in self.tensors:
            return self.tensors[name]
        raise KeyError(f"tensor {name!r} not found (run() first?)")

    def get_all_tensor_names(self) -> List[str]:
        return list(self._last_outputs) + [k for k in self.tensors if k not in self._last_outputs]

    def get_weights_names(self) -> str:
        """Manifest `type:name|...` (reference model_get_weights_names,
        src/exports.cpp:111-148). Graph metadata only: nothing is loaded."""
        assert self.graph is not None, "read a model first"
        c = CollectNamesWeightsProvider()
        c.on_init([(t.name, t.dtype, t.shape) for t in self.graph.weights.values()])
        return c.manifest()

    # ------------------------------------------------------------------- run
    def _bucket_key(self) -> Tuple:
        assert self.graph is not None, "read a model first"
        items = []
        for name in sorted(self.graph.inputs):
            if name not in self.tensors:
                raise KeyError(f"graph input {name!r} has not been pushed (add_tensor)")
            v = self.tensors[name]
            items.append((name, tuple(v.shape), dtype_name(v.dtype)))
        mesh = self.config.mesh
        if mesh is not None:
            # a rank's plan holds its own slices and constants
            items.append(("mesh", tuple(mesh.shape), tuple(mesh.get_coordinate())))
        return tuple(items)

    def _executor(self) -> Executor:
        skey = self._bucket_key()
        # an executor matches if its shape bucket AND the values of any inputs
        # its plan pinned statically both match
        for (k, _pins), ex in self._executors.items():
            if k != skey:
                continue
            if all(
                n in self.tensors and np.array_equal(np.asarray(self.tensors[n]), v)
                for n, v in ex.plan.pinned_inputs.items()
            ):
                return ex
        input_avals = {name: ShapeDtype(shape, dtype) for name, shape, dtype in skey if name != "mesh"}
        values = {name: v for name, v in self.tensors.items() if isinstance(v, np.ndarray)}
        plan = plan_graph(self.graph, self.config, input_avals, self._loader, input_values=values)
        ex = Executor(plan, self.provider, graph_pool=self.graph_pool)
        pins = tuple(sorted((n, v.tobytes()) for n, v in plan.pinned_inputs.items()))
        self._executors[(skey, pins)] = ex
        return ex

    def run(self, eager: bool = False, device_outputs: bool = False) -> Dict[str, Any]:
        """Run the graph on the pushed tensors; float outputs come back as
        float32 numpy arrays, integers as int64. With ``device_outputs`` (not
        in eager runs) they stay device tensors in their compute dtypes, to be
        fed back with add_tensor (the LLM KV cache). With
        ``range_data_calibrate`` the run is eager and records the activation
        ranges into the executor's ``range_data``."""
        ex = self._executor()
        inputs = {name: self.tensors[name] for name in self.graph.inputs}
        if (eager or self.config.ops_printf or self.config.ops_times_printf
                or self.config.range_data_calibrate):
            outs = ex.run_eager(inputs)
        else:
            outs = ex.run(inputs, device_outputs=device_outputs)
        self._last_outputs = outs
        return outs

    # ------------------------------------------------------------- telemetry
    def hbm_stats(self) -> Dict[str, Any]:
        """Device memory: bytes of weights over the cached executors, the
        largest executor's ``hbm_accounting()`` (its estimate, resident or
        streamed), the captured graphs' bytes (``graph_bytes``: each memory
        pool once, and every graph's static inputs) and, on a CUDA device,
        the caching allocator's current and peak bytes
        (``torch.cuda.max_memory_allocated``) beside it."""
        out: Dict[str, Any] = {
            "weight_bytes": max((ex.weight_bytes() for ex in self._executors.values()), default=0)}
        accounts = [ex.hbm_accounting() for ex in self._executors.values()]
        if accounts:
            out["accounting"] = max(accounts, key=lambda a: a["peak_bytes"])
        graphs = [m for ex in self._executors.values() if (m := ex.graph_memory()) is not None]
        if graphs:
            pools = {m["pool"]: m["pool_bytes"] for m in graphs}
            out["graph_bytes"] = sum(pools.values()) + sum(m["input_bytes"] for m in graphs)
        dev = torch.device(self.config.device)
        if dev.type == "cuda":
            out["bytes_in_use"] = torch.cuda.memory_allocated(dev)
            out["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev)
        return out

    def close(self) -> None:
        if self._provider is not None:
            self._provider.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def share_graph_pool(sessions, device) -> None:
    """One CUDA-graph memory pool for sessions whose runs never overlap (the
    sessions of one pipeline): their graphs' intermediates share memory
    instead of each holding its own. Safe because a replay's outputs are
    copied out before another graph of the pool replays. Nothing on a CPU
    device."""
    if torch.device(device).type != "cuda":
        return
    pool = torch.cuda.graph_pool_handle()
    for s in sessions:
        if s is not None:
            s.graph_pool = pool


def supported_ops() -> List[str]:
    """The op types the port runs (JAX ``session.supported_ops``)."""
    return registered_ops()

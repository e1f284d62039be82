"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Each wrapper counts its launches in its ``launches`` and registers itself
here when its module is imported (``register``), with its entry kernels: the
CUDA functions of which each of its launches runs exactly one (a split-K
reduction or a pre-pass runs beside it).

A CUDA graph that captures wrapper calls (``runtime/executor.py``) replays
their launches without calling the wrappers. ``capturing()`` brackets such a
capture: it holds the workspaces the wrappers keep between calls for as long
as the graph, which reads them by address; it keeps the graph from reusing a
quantized A made outside it (``qmatmul._QUANTIZED_A``); and it records the
launches the wrappers counted while the graph was captured. ``graph_kernels``
reads what the captured graph launches, its kernel nodes by function name,
and ``held_to_graph`` holds the record to them: the wrappers that share entry
kernels recorded as many launches as the graph has nodes running one. Each
replay then adds the record to the wrappers' counts and to ``replayed``, and
its graph's kernel nodes to ``replayed_nodes``.

Each wrapper calls a ``KernelFunction`` (a ``torch.autograd.Function``)
with a batching rule, the counterpart of the TPU kernels under ``jax.vmap``:
under ``torch.func.vmap`` the rule folds the mapped axis into the kernel's
own batch or row axis (``folded``), calls the function once more on the
folded operands and splits its output back (``unfolded``), so a vmapped call
is one launch at the folded size. Its forward is the module's ``*_impl``
function, which launches the kernel (or computes the twin on CPU tensors)
and counts the launch (``count``). Weights and scales are never mapped
(``closed_over``): they are closed over, as in JAX.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import importlib
import os
import re
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

_WRAPPER_MODULES = ("flash_attention", "gn_conv", "gn_silu", "matmul", "qconv", "qmatmul")
# kernel name -> the wrapper whose ``launches`` counts its launches, and its entry kernels
_COUNTED: Dict[str, object] = {}
_ENTRY: Dict[str, Tuple[str, ...]] = {}
# while a capture runs: the workspaces the graph reads
_HOLDS: Optional[List[torch.Tensor]] = None
# launches made by graph replays, per kernel, and the kernel nodes the
# replays ran, by function name (``kernel_name``): what a profiler window
# over replays must hold
replayed: Dict[str, int] = collections.Counter()
replayed_nodes: Dict[str, int] = collections.Counter()


def register(name: str, wrapper, entry: Sequence[str]) -> None:
    """Count ``wrapper``'s launches under ``name`` (``wrapper.launches``,
    from 0). ``entry``: the CUDA functions of which each launch runs exactly
    one; empty where the launch is counted under another wrapper too (qconv's
    are kernel 3's, ``qmatmul``)."""
    wrapper.launches = 0
    _COUNTED[name] = wrapper
    _ENTRY[name] = tuple(entry)


def count(name: str) -> None:
    """One launch of kernel ``name``, added to the wrapper registered for it
    at import (a name rebound in the wrapper's module, such as a call
    recorder standing in for it, does not take its count)."""
    _COUNTED[name].launches += 1


class KernelFunction(torch.autograd.Function):
    """A kernel wrapper's batching rule: a subclass's ``forward`` calls the
    implementation (``*_impl``) with the wrapper's arguments as they are,
    its ``vmap`` is the rule. No backward: the kernels have none."""

    generate_vmap_rule = False

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


def closed_over(name: str, in_dims: Sequence[Optional[int]], operands: Sequence[str]) -> None:
    """Raises ValueError where one of the named operands (weights, scales)
    is mapped: a batching rule folds activations only."""
    mapped = [what for what, d in zip(operands, in_dims) if d is not None]
    if mapped:
        raise ValueError(f"{name} under vmap: {', '.join(mapped)} mapped; weights and scales are closed over")


def folded(size: int, in_dims: Sequence[Optional[int]], *xs: Optional[torch.Tensor],
           lift: bool = False) -> List[Optional[torch.Tensor]]:
    """The activation operands of a vmapped call with the mapped axis folded
    into their leading (batch or row) axis: (V, B, ...) -> (V B, ...), where
    ``size`` is V. An unmapped operand (its dim None) is expanded to V first,
    a stride-0 view (the reshape keeps it a view where B is 1; a wrapper whose
    kernel takes no strides copies it as it copies any strided operand).
    With ``lift`` the operands have no batch axis of their own (a 2-D packed
    q) and the mapped axis becomes it: (V, ...). None stays None."""
    out = []
    for x, d in zip(xs, in_dims):
        if x is not None:
            x = x.expand(size, *x.shape) if d is None else x.movedim(d, 0)
            if not lift:
                x = x.reshape(size * x.shape[1], *x.shape[2:])
        out.append(x)
    return out


def unfolded(out: torch.Tensor, size: int, lift: bool = False) -> Tuple[torch.Tensor, int]:
    """A folded call's output split back, (V B, ...) -> (V, ...B...), and its
    mapped dim (0): what a batching rule returns."""
    return (out if lift else out.reshape(size, out.shape[0] // size, *out.shape[1:])), 0


@contextlib.contextmanager
def no_vmap_fallback() -> Iterator[None]:
    """Inside, an op without a batching rule raises under ``torch.func.vmap``
    and names itself, where functorch would otherwise run it once per
    example; the setting is restored after."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)


def counted() -> Dict[str, object]:
    """Kernel name -> the wrapper whose ``launches`` counts its launches,
    as each module registered it at import."""
    for mod in _WRAPPER_MODULES:
        importlib.import_module(f"{__name__}.{mod}")
    return _COUNTED


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in counted().items()}


def add_replay(launches: Dict[str, int], nodes: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``launches`` and whose
    kernel nodes are ``nodes``."""
    for name, n in launches.items():
        counted()[name].launches += n
        replayed[name] += n
    replayed_nodes.update(nodes)


def hold(t: torch.Tensor) -> torch.Tensor:
    """A workspace that a wrapper keeps between calls, handed to a launch:
    while a capture runs the graph keeps it alive, so that a later call that
    replaces it cannot free memory the graph writes."""
    if _HOLDS is not None:
        _HOLDS.append(t)
    return t


@dataclasses.dataclass
class Captured:
    """What a capture of wrapper calls recorded: the workspaces its graph
    reads and the launches one replay makes, per kernel."""
    holds: List[torch.Tensor] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def capturing() -> Iterator[Captured]:
    """Bracket a capture: the wrappers' counts are left as they were (the
    capture launched nothing), the launches it recorded go to
    ``Captured.launches``."""
    global _HOLDS
    from onnxstream_tpu_torch.kernels import qmatmul

    rec = Captured()
    before = launch_counts()
    qmatmul._QUANTIZED_A.clear()
    _HOLDS = rec.holds
    try:
        yield rec
    finally:
        _HOLDS = None
        qmatmul._QUANTIZED_A.clear()
        for name, fn in counted().items():
            if fn.launches != before[name]:
                rec.launches[name] = fn.launches - before[name]
                fn.launches = before[name]


def kernel_name(symbol: str) -> str:
    """A kernel's function name without its scope, template arguments and
    parameters, from its mangled name (a CUDA graph's node) or its demangled
    one (a profiler's event): ``fa_wgmma_kernel`` from both
    ``_Z15fa_wgmma_kernelI13__nv_bfloat16Li64EEv...`` and ``void
    fa_wgmma_kernel<__nv_bfloat16, 64>(...)``."""
    s = symbol.strip()
    if s.startswith("_Z"):
        nested = s.startswith("_ZN")
        i, name = (3 if nested else 2), s
        while nested and i < len(s) and s[i] in "rVKL":  # qualifiers of a nested name
            i += 1
        while m := re.match(r"\d+", s[i:]):
            j = i + len(m.group())
            name, i = s[j:j + int(m.group())], j + int(m.group())
            if not nested:
                break
        return name
    # demangled: template arguments out (innermost first), then the last
    # name before the parameters, past a return type such as
    # ``std::enable_if<...>::type``
    s = s.replace("(anonymous namespace)::", "")
    while (t := re.sub(r"<[^<>]*>", "", s)) != s:
        s = t
    return s.split("(", 1)[0].split()[-1].split("::")[-1]


def graph_kernels(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """The kernel nodes of a captured graph by function name
    (``kernel_name``): what each replay launches. The graph must have been
    made with ``keep_graph=True``; its nodes are read from CUDA's DOT
    description of it (``cudaGraphDebugDotPrint``), where a kernel node is an
    octagon labelled with its index and its function's name."""
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        rc = rt.cudaGraphDebugDotPrint(ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), ctypes.c_uint(0))
        if rc != 0:
            raise RuntimeError(f"cudaGraphDebugDotPrint failed with CUDA error {rc}")
        with open(path) as f:
            return dot_kernels(f.read())


def dot_kernels(dot: str) -> Dict[str, int]:
    """The kernel nodes of a CUDA graph's DOT description (no flags) by
    function name."""
    return collections.Counter(kernel_name(sym) for sym in re.findall(r'shape="octagon"\s*label="\d+\n([^\n"]+)', dot))


def _families() -> Dict[Tuple[str, ...], List[str]]:
    """Each set of entry kernels and the kernels that launch them (kernels
    1 and 2 run the same functions)."""
    counted()
    families: Dict[Tuple[str, ...], List[str]] = {}
    for name, entry in _ENTRY.items():
        if entry:
            families.setdefault(entry, []).append(name)
    return families


def entry_launches(ran: Dict[str, int]) -> Dict[str, int]:
    """Launches by set of entry kernels, keyed by the kernels that share the
    set joined by ``+``, from kernels run by function name (a graph's nodes,
    a profiler window's events)."""
    return {"+".join(names): sum(ran.get(sym, 0) for sym in entry) for entry, names in _families().items()}


def held_to_graph(launches: Dict[str, int], nodes: Dict[str, int]) -> Dict[str, int]:
    """The launches a capture recorded (``Captured.launches``) held to its
    graph's kernel nodes: ``entry_launches(nodes)``. Raises RuntimeError
    where a set's nodes differ from the launches its wrappers recorded, or
    where qconv recorded more launches than kernel 3, under which they are
    counted too."""
    out, wrong = entry_launches(nodes), []
    for entry, names in _families().items():
        label = "+".join(names)
        want = sum(launches.get(n, 0) for n in names)
        if out[label] != want:
            wrong.append(f"{label}: {want} recorded, {out[label]} nodes of {'/'.join(entry)}")
    if launches.get("qconv", 0) > launches.get("qmatmul", 0):
        wrong.append(f"qconv: {launches['qconv']} recorded, more than kernel 3's {launches.get('qmatmul', 0)}")
    if wrong:
        raise RuntimeError("the captured graph launches other kernels than the capture recorded: " + "; ".join(wrong))
    return out

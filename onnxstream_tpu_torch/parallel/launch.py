"""Start n ranks of one process group and collect what each returns.

JAX drives every device from one process, so the JAX package has no
counterpart. Here each rank is a process (``torch.multiprocessing``, the
``spawn`` start method, as CUDA needs) that joins the group through a
``FileStore`` in a temporary directory (no port to collide on when several
groups start at once) and calls ``fn(rank, device, *args)``. The parent
returns the ranks' results in rank order. If a rank raises, every rank is
ended and its traceback raised in the parent; a group that has not finished
after ``timeout_s`` is ended and ``TimeoutError`` raised, so a deadlock costs
one call and not a test run.

    results = spawn(fn, 2, backend="nccl", device="cuda", timeout_s=120)  # a card a rank
    results = spawn(fn, 2, backend="gloo", device="cpu", timeout_s=120)

``device``: "cpu", one card for every rank ("cuda:0": two gloo ranks may
share it; NCCL refuses that) or "cuda" for card ``rank % device_count`` each.
Under ``torchrun`` the ranks are started by the launcher instead: call
``init_process_group`` and ``make_mesh`` in each.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, n: int, backend: str, device: str, folder: str, timeout_s: float, results) -> None:
    try:
        with open(os.path.join(folder, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)  # written by spawn() for this group
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # n ranks share the host's cores
        if backend == "gloo":
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share one host
        store = dist.FileStore(os.path.join(folder, "store"), n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, backend: str, device: str, timeout_s: float = 120.0,
          args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(rank, device, *args)`` on n ranks; the results in rank order.
    fn and its results cross processes by pickle: a module-level function.
    fn and args go to the ranks through a file, not the start pipe: a
    payload larger than the pipe's buffer would make each start wait for
    its rank's imports, one rank after another."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    folder = tempfile.mkdtemp(prefix="ostt_rdzv_")
    with open(os.path.join(folder, "call.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_rank_main, args=(r, n, backend, device, folder, timeout_s, results), daemon=True)
             for r in range(n)]
    out: List[Any] = [None] * n
    deadline = time.monotonic() + timeout_s
    finished = False
    try:
        for p in procs:
            p.start()
        done = set()
        while len(done) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {n - len(done)} of {n} ranks did not finish within {timeout_s} s "
                                   f"(ranks {sorted(set(range(n)) - done)})")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                       f"before reporting")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of {n} failed:\n{payload}")
            out[rank] = payload
            done.add(rank)
        finished = True
    finally:
        # every rank has reported (each exits right after), or the group is
        # ended: a rank that waits in a collective for a failed one waits
        # for ever
        for p in procs:
            if finished:
                p.join(timeout=30.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(folder, ignore_errors=True)
    return out

"""Multi-process training: one process per card under
DistributedDataParallel, the PyTorch idiom that stands in for JAX's
single-process ``'data'`` mesh (fal_net_tpu/parallel/mesh.py).

  * :func:`init_process_group`: NCCL on cards, gloo on the CPU (or where the
    caller asks for it: gloo also all-reduces CUDA tensors, and it takes
    two ranks on one card, which NCCL refuses), rendezvous through a
    ``FileStore`` path, never a fixed TCP port;
  * :func:`launch`: starts N processes (spawned), runs ``fn(rank, world,
    *args)`` in each inside its process group, returns every rank's result
    and re-raises a child's failure with its traceback; it builds the CUDA
    kernels once in the parent first, so the children only load them;
  * :func:`rank`, :func:`world_size`, :func:`rank_device`;
  * :func:`all_reduce_mean`: the mean over ranks of logged scalars.

Outside a process group every helper answers for a world of one.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from fal_net_torch.ops import _build

DEFAULT_TIMEOUT = 1800.0  # seconds a collective may wait


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(rank: int, world: int, store_path: str, *, backend: Optional[str] = None,
                       device="cuda", timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the group of ``world`` ranks that rendezvous at the FileStore
    ``store_path`` (a path no earlier group used) as ``rank``."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend or default_backend(device), store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank_device(device, r: int) -> torch.device:
    """Rank ``r``'s device: ``cuda:r`` for a CUDA ``device`` given without
    an index, the given device otherwise."""
    d = torch.device(device)
    return torch.device("cuda", r) if d.type == "cuda" and d.index is None else d


def all_reduce_mean(values: Dict[str, float], device) -> Dict[str, float]:
    """``values`` averaged over the ranks (one all-reduce; identity outside a
    process group)."""
    if not active() or not values:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(t)  # SUM: gloo has no AVG
    return dict(zip(keys, (t / world_size()).tolist()))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _child(fn, r: int, world: int, store_path: str, backend: str, device: str, timeout: float,
           threads: Optional[int], args: Sequence[Any], results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, r)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # NCCL's and broadcast_object_list's device
        init_process_group(r, world, store_path, backend=backend, device=device, timeout=timeout)
        try:
            out = fn(r, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((r, True, out))
    except BaseException as e:  # reported to the parent, which re-raises
        results.put((r, False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def launch(fn: Callable[..., Any], world: int, args: Sequence[Any] = (), *, store_path: str,
           backend: Optional[str] = None, device="cuda", timeout: float = DEFAULT_TIMEOUT,
           join_timeout: Optional[float] = None, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form one process group (``backend`` or NCCL on cards, gloo on the CPU)
    through the FileStore at ``store_path``; returns the ranks' results in
    rank order.  ``fn`` must be importable by the children (a module-level
    function) and its arguments and result picklable.  A child's exception
    is re-raised here with its traceback; a child that dies, or a run past
    ``join_timeout`` seconds, ends every child and raises.  ``threads``:
    ``torch.set_num_threads`` in each child.  Collectives wait ``timeout``
    seconds at most."""
    backend = backend or default_backend(device)
    _build.ensure_loaded(device)  # build in the parent; the children load the library
    if os.path.exists(store_path):
        raise ValueError(f"FileStore path {store_path} exists: give each process group a fresh path")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, store_path, backend, str(device), timeout, threads,
                                              tuple(args), results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    got: Dict[int, Any] = {}
    try:
        while len(got) < world:
            try:
                r, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {world} died with exit code {procs[dead[0]].exitcode}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {join_timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{out}")
            got[r] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if os.path.exists(store_path):
            os.remove(store_path)
    return [got[r] for r in range(world)]

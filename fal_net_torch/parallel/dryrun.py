"""One data-parallel stage-1 step over n ranks (the port's counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m fal_net_torch.parallel.dryrun --ranks 2 --backend gloo   # two ranks on one card

:func:`dryrun_multigpu` spawns n ranks (parallel/ddp.py), each a
:class:`~fal_net_torch.train.trainer.Trainer` inside the process group, so
under DistributedDataParallel whatever n is (world 1 included); each rank
takes its shard of one seeded global batch from the sharded loader and makes
one step, after computing its gradient alone on its slice of the
one-process loader's global batch.  The same step then runs in this process
on the whole global batch, with no process group, and every parameter's
gradient (averaged over the ranks), Adam moment and the loss are held
against both (see :func:`dryrun_multigpu`).  Rank *r* runs on
``cuda:r`` for ``device="cuda"``; ``backend="gloo"`` puts two ranks on one
card, which NCCL refuses.  :func:`rank_step` is the step each rank makes; the
tests drive it for the other stages too.

An even rank count of 4 or more takes the 2-D layout of
``__graft_entry__.py::dryrun_multichip``: a (n / 2) x 2 grid of data groups
and ranks that split each image's rows (parallel/spatial.py).
:func:`rank_forward` is one rank's forward on such a grid, and
:func:`rank_calls` runs several calls in each rank of one process group.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from fal_net_torch.data.loader import DataLoader, to_device
from fal_net_torch.ops import _build
from fal_net_torch.ops.med_kernel import MedForward
from fal_net_torch.models import create_model
from fal_net_torch.parallel import ddp
from fal_net_torch.parallel.spatial import make_2d_grid
from fal_net_torch.train.config import Stage1Config
from fal_net_torch.train.trainer import Trainer
from fal_net_torch.utils.timing import tf32 as tf32_mode


class SyntheticStereo:
    """``n`` seeded stereo pairs of normalized (H, W, 3) float32 images, each
    drawn from (seed, index) when it is read, so the set pickles small."""

    def __init__(self, n: int, height: int, width: int, seed: int = 0):
        self.n, self.height, self.width, self.seed = n, height, width, seed

    def __len__(self) -> int:
        return self.n

    def get(self, i: int, rng=None) -> Dict[str, np.ndarray]:
        g = np.random.default_rng((self.seed, i))
        left = (g.standard_normal((self.height, self.width, 3)) * 0.3).astype(np.float32)
        right = (np.roll(left, -4, axis=1) + g.standard_normal(left.shape) * 0.05).astype(np.float32)
        return {"left": left, "right": right}


STEP_KEYS = ("left", "right", "max_disp")


def rank_step(rank: int, world: int, cfg, stage: str, device, dataset, timed_steps: int = 0,
              batch: Optional[Dict[str, np.ndarray]] = None,
              reference: Optional[Dict[str, np.ndarray]] = None, spatial: int = 1) -> Dict[str, Any]:
    """This rank's trainer makes one step on its share of the loader's first
    global batch (on ``batch``, a host batch, where given), with TF32 off
    and cuDNN's deterministic algorithms, so that the compared steps differ
    by fp32 summation order alone.  Returns the all-reduced aux losses and
    this rank's K1 and K2 launches in the step; rank 0 also returns every
    parameter's gradient and Adam moments (numpy, None where a parameter
    has no gradient).  ``reference`` (a host global batch, inside a process
    group): before the step, this rank's loss and gradients on its slice
    ``reference[rank::world]`` alone, under ``no_sync`` (``local``).  Then
    ``timed_steps`` more steps on the same batch in this process's own TF32
    and cuDNN settings (the port's: TF32 convolutions on), each timed on the
    host clock up to a device synchronise (``step_ms``, their median), with
    their peak device memory (``peak_gb``, on a card).  ``spatial``: the
    trainer splits each image's rows over that many ranks (the slice of
    ``reference`` is then the data group's, ``[d::world / spatial]``, and
    ``local`` its rows' share of the gradients)."""
    dev = ddp.rank_device(device, rank)
    to_np = lambda t: None if t is None else t.detach().cpu().numpy().copy()  # no alias of a live CPU tensor
    deterministic = torch.backends.cudnn.deterministic
    with tf32_mode(False):
        torch.backends.cudnn.deterministic = True
        trainer = Trainer(cfg, stage=stage, device=dev, train_dataset=dataset, spatial=spatial)
        trainer.setup()
        if batch is None:
            with contextlib.closing(iter(trainer.train_loader)) as batches:
                batch = next(batches)
        batch = to_device({k: batch[k] for k in STEP_KEYS if k in batch}, dev)
        out = {"rank": rank}
        try:
            if reference is not None:
                d, n = trainer.data_rank, trainer.data_groups
                part = to_device({k: reference[k][d::n] for k in STEP_KEYS if k in reference}, dev)
                with trainer.train_model.no_sync():
                    loss, _ = trainer._loss(part)
                    loss.backward()
                out["local"] = {"aux": {"loss": float(loss.detach())},
                                "grads": {n: to_np(p.grad) for n, p in trainer.model.named_parameters()}}
            _build.reset_launch_counts()
            aux = trainer.train_step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        out.update(aux=aux, k1=MedForward.launches, k2=MedForward.bwd_launches)
        if rank == 0:
            state = trainer.optimizer.state
            out["grads"] = {n: to_np(p.grad) for n, p in trainer.model.named_parameters()}
            out["adam"] = {n: (to_np(state[p]["exp_avg"]), to_np(state[p]["exp_avg_sq"])) if p in state else None
                           for n, p in trainer.model.named_parameters()}
    times = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(timed_steps):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = float(np.median(times)) if times else None
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" and times else None
    return out


def rank_forward(rank: int, world: int, spatial: int, device, images: np.ndarray, min_disp: float, max_disp: float,
                 model_kw: Dict[str, Any], seed: int = 0, timed: int = 0, **flags) -> Dict[str, Any]:
    """This rank's forward on a (world / spatial) x spatial grid: a model of
    ``create_model(**model_kw)`` with weights from ``seed``, on its data
    group's share of ``images`` (a host NHWC global batch, split in equal
    consecutive parts) with its rows split over the group's ranks, with TF32
    off and cuDNN's deterministic algorithms; returns the rank's place, its
    rows of each requested output (numpy NCHW), K1's launches, and with
    ``timed`` the median of that many more forwards in this process's own
    settings, as :func:`rank_step`'s timed steps (ms, host clock up to a
    device synchronise), and their peak device memory (GB, on a card).
    ``flags``: ``ret_pan``, ``ret_subocc``."""
    dev = ddp.rank_device(device, rank)
    grid = make_2d_grid(world // spatial, spatial) if spatial > 1 else None
    (data, d), rows = ((grid.data, grid.d), grid.rows) if grid else ((world, rank), None)
    model = create_model(**model_kw, device=dev, generator=torch.Generator().manual_seed(seed)).with_spatial(rows)
    x = torch.from_numpy(np.array_split(images, data)[d]).permute(0, 3, 1, 2).contiguous().to(dev)
    _build.reset_launch_counts()
    forward = lambda: model(x, min_disp, max_disp, ret_disp=True, **flags)
    with torch.inference_mode():
        deterministic = torch.backends.cudnn.deterministic
        with tf32_mode(False):
            torch.backends.cudnn.deterministic = True
            try:
                out = forward()
            finally:
                torch.backends.cudnn.deterministic = deterministic
        k1 = MedForward.launches
        times = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(timed):
            t0 = time.perf_counter()
            forward()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
    return {"d": d, "s": rows.index if rows else 0, "k1": k1, "levels": rows.describe(images.shape[1]) if rows else "",
            "outputs": {k: v.cpu().numpy() for k, v in out._asdict().items() if v is not None},
            "ms": float(np.median(times)) if times else None,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" and timed else None}


def rank_calls(rank: int, world: int, calls) -> list:
    """``fn(rank, world, *args, **kwargs)`` for each ``(fn, args, kwargs)`` of
    ``calls`` in turn, in this rank of one process group: their results."""
    return [fn(rank, world, *args, **kwargs) for fn, args, kwargs in calls]


def step_units(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """Each parameter's worst difference of ``got``'s gradient (and Adam
    moments, where both have them) from ``want``'s, in units of the
    tolerance rtol 1e-4, atol 1e-6 of each tensor's largest magnitude: at
    most 1 is within it.  Raises AssertionError where the losses differ past
    rtol 1e-5 or a gradient is on one side only."""
    np.testing.assert_allclose(got["aux"]["loss"], want["aux"]["loss"], rtol=1e-5)
    units = lambda h, g: float((np.abs(h - g) / (1e-6 * np.abs(g).max() + 1e-4 * np.abs(g) + 1e-30)).max())
    out = {}
    for name, g in want["grads"].items():
        h = got["grads"][name]
        if (g is None) != (h is None):
            raise AssertionError(f"{name}: a gradient on one side only")
        if g is None:
            continue
        pairs = [(h, g)] + (list(zip(got["adam"][name], want["adam"][name])) if "adam" in got and "adam" in want
                            else [])
        out[name] = max(units(a, b) for a, b in pairs)
    return out


def step_error(got: Dict[str, Any], want: Dict[str, Any]) -> float:
    """The worst of :func:`step_units`."""
    return max(step_units(got, want).values(), default=0.0)


def _mean_of(shards, spatial: int = 1) -> Dict[str, Any]:
    """The average of per-shard gradients and losses: what DDP's all-reduce
    computes from the ranks' own gradients (summed over the ``spatial``
    ranks of a data group, averaged over the data groups)."""
    grads = {n: None if shards[0]["grads"][n] is None else sum(s["grads"][n] for s in shards) * spatial / len(shards)
             for n in shards[0]["grads"]}
    return {"aux": {"loss": float(np.mean([s["aux"]["loss"] for s in shards]))}, "grads": grads}


# Limits in tolerance units (step_error) of the full-width check on the card
# (FAL_netB, N=49, 192x640, global batch 8; PERF.md, phase 13).  A rank's
# all-reduced gradients and its own on its slice read 0.000 with this
# process's cache handed back first and 7.4 without it; SAME_SPLIT allows
# 10, far below a fault's size (an all-reduce that drops or does not average
# a gradient moves it by its own size, 1e4 units; a wrong shard moves the
# loss past its rtol 1e-5).  The one-process step sums batch 8 in another
# order than the ranks' batch 4: FAL_netB's first-layer weight gradients,
# sums of a million products, read 81-144 units, which ORDER_ONLY caps.
SAME_SPLIT = 10.0
ORDER_ONLY = 200.0
# Stage 2 (the same model, batch 4, its double batch 8, a_mr 1) sums more
# terms a gradient: the one-process step against itself as two microbatches,
# summation order alone, read 296.0 units, its rows over two ranks 243.9
# (PERF.md, phase 14).  STAGE2_ORDER caps it, 2x above the one and 17x below
# a fault's 1e4.
STAGE2_ORDER = 600.0


def dryrun_multigpu(n: int = 2, device="cuda", backend: Optional[str] = None, *, variant: str = "B",
                    num_levels: int = 49, height: int = 192, width: int = 640, batch: int = 8, seed: int = 0,
                    store_dir: Optional[str] = None, timeout: float = 600.0, join_timeout: Optional[float] = None,
                    threads: Optional[int] = None, timed_steps: int = 0) -> Dict[str, Any]:
    """One stage-1 step (a_p 0) of a seeded global ``batch`` over ``n``
    ranks under DDP, each rank's share from the sharded loader, held against
    the one-process loader's global batch.  ``timed_steps``: more steps
    after the compared one, timed in every rank and in a one-process run
    (see :func:`rank_step`).  An even ``n`` of 4 or more forms a (n / 2) x 2
    grid: n / 2 data groups, each image's rows split over 2 ranks.

    The errors, in units of the tolerance rtol 1e-4, atol 1e-6 of the
    tensor's largest magnitude (:func:`step_error`): ``mean_worst``, the
    ranks' all-reduced gradients against the average of the ranks' own
    gradients on the global batch's slices ``[r::n]``, which are their
    shards (``rank_step``'s ``local``; on a grid the data groups' slices,
    the rows' shares summed): the sharded loader and the
    all-reduce, at most ``SAME_SPLIT``; ``worst``, the ranks' step against
    the step on the whole batch made in this process with no process group:
    fp32 summation order at another batch size, at most ``ORDER_ONLY``.
    The losses agree at rtol 1e-5.  Raises past a limit.  Returns each
    rank's loss, K1 and K2 launches and step time, the errors, the device
    memory free as the ranks start (GiB, on a card), the grid's ``spatial``
    and rank 0's :func:`rank_step` report."""
    cfg = Stage1Config(model=variant, num_levels=num_levels, crop_size=(height, width), batch_size=batch, a_p=0.0,
                       workers=2, seed=seed)
    dataset = SyntheticStereo(batch, height, width, seed)
    with contextlib.closing(iter(DataLoader(dataset, batch_size=batch, seed=seed, num_workers=cfg.workers))) as it:
        whole = next(it)
    args = (cfg, "stage1", str(device), dataset)
    spatial = 2 if n >= 4 and n % 2 == 0 else 1
    free_gib = None
    if torch.device(device).type == "cuda":
        # the ranks share this process's card: hand them the memory it has
        # cached (without it, a rank's two passes over one slice drifted
        # apart by a few tolerance units)
        gc.collect()
        torch.cuda.empty_cache()
        free_gib = torch.cuda.mem_get_info(ddp.rank_device(device, 0))[0] / 2**30
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        ranks = ddp.launch(rank_step, n, (*args, timed_steps, None, whole, spatial),
                           store_path=os.path.join(tmp, "store"), backend=backend, device=device, timeout=timeout,
                           join_timeout=join_timeout, threads=threads)
    one = rank_step(0, 1, *args, timed_steps, batch=whole)
    mean_worst = step_error(ranks[0], _mean_of([r["local"] for r in ranks], spatial))
    worst = step_error(ranks[0], one)
    if mean_worst > SAME_SPLIT or worst > ORDER_ONLY:
        raise AssertionError(f"{n} ranks: {mean_worst:.3f} tolerance units against their own steps on the global "
                             f"batch's slices (limit {SAME_SPLIT}); {worst:.3f} against the one-process step "
                             f"(limit {ORDER_ONLY})")
    return {
        "ranks": n, "spatial": spatial, "backend": backend or ddp.default_backend(device),
        "loss": [r["aux"]["loss"] for r in ranks], "one_process_loss": one["aux"]["loss"],
        "k1": [r["k1"] for r in ranks], "k2": [r["k2"] for r in ranks], "rank0": ranks[0],
        "worst": worst, "mean_worst": mean_worst,
        "step_ms": [r["step_ms"] for r in ranks], "one_process_step_ms": one["step_ms"], "free_gib": free_gib,
    }


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on cards, gloo on the CPU)")
    p.add_argument("--model", default="B")
    p.add_argument("--no_levels", type=int, default=49)
    args = p.parse_args(argv)
    report = dryrun_multigpu(args.ranks, args.device, args.backend, variant=args.model, num_levels=args.no_levels)
    print({k: v for k, v in report.items() if k != "rank0"})
    return report


if __name__ == "__main__":
    main()

"""Row (spatial) partitioning over a data x spatial grid of ranks
(counterpart of fal_net_tpu/parallel/spatial.py).

A convolutional model has no weight axis worth splitting, but its
activations do: splitting every image's rows over S ranks splits each conv's
work and memory, so that an image larger than one card's memory, or a batch-1
image that needs less latency, runs over several cards.  JAX's SPMD
partitioner inserts the conv halo exchanges itself; here they are explicit:

  * :func:`make_2d_grid`: the ranks of a process group as a (data, spatial)
    grid, rank ``r`` at ``(r // S, r % S)`` as JAX's ``make_2d_mesh``
    reshapes its devices, with the process group of each data group (the S
    ranks that split one image's rows); the gradient all-reduce runs over
    the whole group (:func:`mean_over_data`), so no group of the data
    groups is needed;
  * :class:`RowShard`: one rank's place among the S ranks of its row.  Its
    level rule (:meth:`RowShard.sharded`) is JAX's
    (fal_net_tpu/models/backbone.py:157-177); :meth:`~RowShard.split`,
    :meth:`~RowShard.gather` and :meth:`~RowShard.halo` move rows between
    the ranks under autograd; :meth:`~RowShard.mean` and
    :meth:`~RowShard.amax` reduce a loss term over the group;
    :meth:`~RowShard.apply` runs one op on each rank's rows or on whole rows
    and places its output as the rule says.

While :meth:`RowShard.active` is entered, every 3x3 conv of
``models/layers.py`` takes its k//2 boundary rows from the neighbouring ranks
(zeros at the image's top and bottom) and zero-pads only its columns.  A
whole level is computed alike on the S ranks, and each keeps only its own
rows of what leaves it, so every rank's gradient is its own rows' share:
gradients are summed over the spatial group and averaged over the data
groups (:func:`mean_over_data`).  The MED head's shifts act along W, so its
math is row-local and the split is exact.

The collectives are ``all_gather`` and ``all_reduce``, which gloo runs on
CUDA tensors too (two ranks on one card cannot use NCCL); every rank of a
group calls them in the same order, in the forward, in the backward and in
a rematerialized forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_STATE = threading.local()


def active_rows() -> Optional["RowShard"]:
    """The :class:`RowShard` whose rows the current op runs on, or None."""
    return getattr(_STATE, "rows", None)


def level_heights(h: int) -> List[int]:
    """Rows of the backbone's levels x0..x6 for an image of ``h`` rows: each
    3x3 stride-2 conv with padding 1 halves them, rounding up."""
    hs = [h]
    for _ in range(6):
        hs.append((hs[-1] + 1) // 2)
    return hs


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    t = t.contiguous()
    bufs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, t, group=group)
    return bufs


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``, a new tensor."""
    acc = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(acc, group=group)
    return acc


class _Gather(torch.autograd.Function):
    """Whole rows from each rank's rows; the backward sums the ranks' partial
    gradients of the whole tensor and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, shard: "RowShard", h: int):
        ctx.shard, ctx.h = shard, h
        bounds = [shard.bounds(h, r) for r in range(shard.size)]
        most = max(hi - lo for lo, hi in bounds)
        padded = torch.nn.functional.pad(x, (0, 0, 0, most - x.shape[-2]))
        parts = _all_gather(padded, shard.group)
        return torch.cat([p[..., : hi - lo, :] for p, (lo, hi) in zip(parts, bounds)], dim=-2)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.shard.bounds(ctx.h)
        return _all_reduce_sum(g, ctx.shard.group)[..., lo:hi, :], None, None


class _Halo(torch.autograd.Function):
    """This rank's rows with ``k`` rows of each neighbour above and below
    (zeros at the image's top and bottom); the backward sends the halo rows'
    gradients back to their owners, which add them into their boundary rows."""

    @staticmethod
    def forward(ctx, x, shard: "RowShard", k: int):
        if x.shape[-2] < k:
            raise ValueError(f"a halo of {k} rows needs at least {k} rows a rank, this rank has {x.shape[-2]}")
        ctx.shard, ctx.k = shard, k
        s, n = shard.index, shard.size
        parts = _all_gather(torch.cat([x[..., :k, :], x[..., -k:, :]], dim=-2), shard.group)
        zeros = x.new_zeros(x.shape[:-2] + (k, x.shape[-1]))
        top = parts[s - 1][..., k:, :] if s > 0 else zeros  # the rank above's last rows
        bottom = parts[s + 1][..., :k, :] if s < n - 1 else zeros  # the rank below's first rows
        # keep the input's row stride: rows padded past W stay padded
        w = x.shape[-1]
        pitch = x.stride(-2) if x.stride(-1) == 1 and x.shape[-2] > 1 and x.stride(-2) > w else w
        out = x.new_empty(x.shape[:-2] + (x.shape[-2] + 2 * k, pitch))[..., :w]
        return torch.cat([top, x, bottom], dim=-2, out=out)

    @staticmethod
    def backward(ctx, g):
        k, s, n = ctx.k, ctx.shard.index, ctx.shard.size
        parts = _all_gather(torch.cat([g[..., :k, :], g[..., -k:, :]], dim=-2), ctx.shard.group)
        gx = g[..., k:-k, :].clone()
        if s > 0:  # the rank above's bottom halo is this rank's first rows
            gx[..., :k, :] += parts[s - 1][..., k:, :]
        if s < n - 1:  # the rank below's top halo is this rank's last rows
            gx[..., -k:, :] += parts[s + 1][..., :k, :]
        return gx, None, None


class _Sum(torch.autograd.Function):
    """The sum over the group; the backward passes the gradient through
    unchanged, as each rank's loss is the group's and its gradient is its
    own rows' share."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """Rank ``index`` of the ``size`` ranks in ``group`` that split an image's
    rows.  An image of h rows is split evenly where S divides h, else the
    first h % S ranks take one row more (``numpy.array_split``)."""

    size: int
    index: int
    group: Any = None

    def sharded(self, h: int, h_in: Optional[int] = None) -> bool:
        """JAX's level rule (fal_net_tpu/models/backbone.py:157-177): a level
        of h rows is split over the ranks where S divides h, and kept whole
        otherwise; a deconv's output (``h_in``: its input's rows) where S
        divides min(h, h_in).  Where two consecutive levels are both split,
        the larger has 2 * S * m rows, so each rank's first row is even and a
        stride-2 conv or an exact 2x upsample stays aligned with the rows."""
        return self.size > 1 and (h if h_in is None else min(h, h_in)) % self.size == 0

    def bounds(self, h: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """The rows [lo, hi) of an h-row image that ``rank`` (this rank if
        None) holds."""
        r = self.index if rank is None else rank
        q, m = divmod(h, self.size)
        lo = r * q + min(r, m)
        return lo, lo + q + (r < m)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole NCHW ``x`` (the backward zero-pads)."""
        lo, hi = self.bounds(x.shape[-2])
        return x[..., lo:hi, :]

    def gather(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """The whole h rows from each rank's rows ``x``."""
        return _Gather.apply(x, self, h)

    def halo(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """``x`` with ``k`` neighbour rows above and below."""
        return _Halo.apply(x, self, k)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over every rank's rows (sum and count in fp64)."""
        part = torch.stack([t.sum().double(), torch.tensor(float(t.numel()), dtype=torch.float64, device=t.device)])
        total = _Sum.apply(part, self.group)
        return (total[0] / total[1]).to(t.dtype)

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        """Each image's largest value over every rank's rows, (B, 1, 1, 1)
        (no gradient: stage 2 reads it from the frozen teacher)."""
        m = torch.amax(t, dim=(1, 2, 3), keepdim=True).detach().contiguous()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return m

    @contextlib.contextmanager
    def active(self):
        """Convs run on this rank's rows with halos while it is entered."""
        prev = active_rows()
        _STATE.rows = self
        try:
            yield self
        finally:
            _STATE.rows = prev

    def apply(self, fn: Callable, inputs: Sequence["Level"], split: bool, row_local: bool = True):
        """``fn(*inputs)``: on this rank's rows (inputs split, under
        :meth:`active`) where its output is to be ``split`` and ``fn`` is
        ``row_local`` (its output rows need only its input rows and their
        halo, aligned); else on whole rows (inputs gathered), its output,
        a tensor or a tuple of tensors and Nones, split if ``split``."""
        if split and row_local:
            with self.active():
                return fn(*(self.placed(v, True) for v in inputs))
        out = fn(*(self.placed(v, False) for v in inputs))
        if not split:
            return out
        if isinstance(out, torch.Tensor):
            return self.split(out)
        return type(out)(*(None if t is None else self.split(t) for t in out))

    def placed(self, v: "Level", split: bool) -> torch.Tensor:
        """``v``'s tensor split over the ranks or whole."""
        if v.split == split:
            return v.x
        return self.split(v.x) if split else self.gather(v.x, v.h)

    def describe(self, h: int) -> str:
        """Which backbone levels an image of h rows splits and keeps whole."""
        return ", ".join(f"x{i} {hi} rows " + (f"split {hi // self.size} a rank" if self.sharded(hi) else "whole")
                         for i, hi in enumerate(level_heights(h)))


ONE_RANK = RowShard(1, 0)  # no split: every level whole, every op once on whole rows, no collective


@dataclasses.dataclass(frozen=True)
class Level:
    """A tensor of ``h`` global rows: this rank's rows (``split``) or all."""

    x: torch.Tensor
    h: int
    split: bool


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """A rank's place in a (data, spatial) grid: ``d`` of ``data`` groups of
    samples, ``rows`` its place among the ``spatial`` ranks that split those
    samples' rows."""

    data: int
    spatial: int
    d: int
    rows: RowShard


def make_2d_grid(data: int, spatial: int) -> Grid:
    """This rank's place in a (data, spatial) grid over the process group's
    ``data * spatial`` ranks (JAX's ``make_2d_mesh``): rank r at
    (r // spatial, r % spatial).  Every rank creates every data group's
    process group, in the same order, as ``new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * spatial != world:
        raise ValueError(f"a {data} x {spatial} grid needs {data * spatial} ranks, the process group has {world}")
    groups = [dist.new_group([d * spatial + s for s in range(spatial)]) for d in range(data)]
    d, s = divmod(rank, spatial)
    return Grid(data, spatial, d, RowShard(spatial, s, groups[d]))


def mean_over_data(data: int, bucket):  # unannotated: DDP holds annotations to its own types
    """DDP comm hook over the whole group: each gradient divided by the
    number of data groups, then summed over every rank: summed over the
    spatial ranks (each holds its rows' share) and averaged over the data
    groups (each holds its samples' mean), the gradient of the global mean.
    DDP's own all-reduce averages over every rank instead."""
    t = bucket.buffer().div_(data)
    return dist.all_reduce(t, async_op=True).get_future().then(lambda fut: fut.value()[0])

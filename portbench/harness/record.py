"""What a run hands from its driver to the metric readers and the result."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from portbench.harness.spec import Cell


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float = dataclasses.field(default_factory=time.perf_counter)  # process start by default


@dataclasses.dataclass
class Check:
    """One number of the correctness comparison and its limit: sound while
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class SetupParts:
    """Set-up's seconds by part: ``mark(name)`` closes the part that began at
    the last mark (the first at the process's start)."""

    def __init__(self, ctx: Context):
        self.seconds, self._t = {}, ctx.t_start

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def checks(ctx: Context, numbers: dict) -> list:
    """The numbers that the cell's limits file names, each with its limit."""
    return [Check(name, numbers[name], limit) for name, limit in ctx.cell.limits.items()]


@dataclasses.dataclass
class Run:
    setup_s: float  # process start to the first timed call
    window_s: float  # host seconds of the timed (or traced) window
    launches: dict  # the port's K1 / K2 launches in the window, by its counters
    attempted: int
    failed: int
    checks: list  # [Check]
    device: dict  # the result's "device" entry
    calls: dict  # kernel -> the shape arguments of its calls in the window (metrics/_work.py)
    flops_per_call: float  # convolution FLOPs of one model call (a batch's forward or a step)
    conv_peak: float  # FLOP/s of the compute dtype's convolutions
    frames: Optional[int] = None  # served frames handed back in the window
    latencies_s: Optional[list] = None  # pull to hand-back, each frame of the window
    pairs: Optional[int] = None  # training pairs of the steps completed in the window
    trace: Optional[dict] = None  # harness/trace.py's reduction of the traced window
    numbers: Optional[dict] = None  # every number the driver's comparison read, checked or not
    setup_parts: Optional[dict] = None  # set-up's seconds by part (SetupParts)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)

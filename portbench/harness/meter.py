"""Opens and closes a run's measured window: the device's memory peak and
the port's launch counters are read across it, and under ``--trace 1`` the
profiler's window (harness/trace.py) is the same stretch."""

from __future__ import annotations

import time

import torch

from portbench.harness import device as card, guard, trace
from portbench.harness.record import Context


class Meter:
    def __init__(self, ctx: Context, chips: int = 1):
        self.ctx, self.chips = ctx, chips
        self.window = trace.Window(ctx.device) if ctx.trace else None
        self.t0 = None
        self.seconds = None
        self.launches = None
        self.device = None

    @property
    def open_s(self) -> float:
        """Seconds the window may stay open: ``--seconds``, or under
        ``--trace 1`` at most ``trace_seconds`` of the traffic file."""
        tr = self.ctx.cell.traffic
        return min(self.ctx.seconds, tr["trace_seconds"]) if self.window else self.ctx.seconds

    def start_profiler(self) -> None:
        if self.window:
            self.window.__enter__()

    def stop_profiler(self) -> None:
        if self.window:
            self.window.__exit__(None, None, None)

    def open(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.ctx.device)
        self._counts = guard.launch_counts()
        if self.window:
            self.window.open()
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def close(self, sync: bool) -> None:
        """Close once; ``sync`` waits for the device first, so that the
        window's seconds hold all of its work."""
        if self.seconds is not None:
            return
        if sync:
            card.sync(self.ctx.device)
        self.seconds = time.perf_counter() - self.t0
        if self.window:
            self.window.close()
        self.launches = guard.kernel_launches(self._counts, guard.launch_counts())
        self.device = card.describe(self.ctx.device, self.chips)

    @property
    def reduced(self):
        return self.window.reduced if self.window else None

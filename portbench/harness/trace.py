"""The traced window: ``torch.profiler`` over a stretch of the cell's own
loop, reduced to what the per-layer readers take.

:class:`Window` starts the profiler (CPU and CUDA activity), lets the
driver run a few calls under it so that CUPTI is warm, then opens the
window on a synchronised device and closes it on one: every device
operation the window's calls launched lies inside it, and nothing from
before.  :func:`reduce` keeps, of the window:

  * ``ops``: every device operation (kernels, copies, sets) as
    (name, start_us, end_us), in start order;
  * ``host``: the main thread's host events (the benchmark's own spans,
    named ``portbench.*``, and the operators under them) as
    (name, start_us, end_us);
  * ``window_us``: the window's length; ``busy_us``: the union of ``ops``.

``KINDS`` (copied from the port's chip_smoke.py) names a kernel's kind by
its name; the breakdown lists device time by kind and kernel name and the
longest idle gaps by what the host was doing in them: the innermost host
event in flight at the gap's middle, under the outermost benchmark span.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager

import torch

# kernel kinds, matched in order against lower-cased device operation names
KINDS = [
    ("K1 med_fwd", "med_fwd_kernel"),
    ("K2 med_bwd", "med_bwd_kernel"),
    ("L1 logits_conv", "logits_conv"),
    ("memcpy", "^memcpy"),
    ("memset", "^memset"),
    ("layout transposes", "nchwtonhwc|nhwctonchw|transpose"),
    ("nearest upsample", "upsample"),
    ("ELU", "elu"),
    ("concat", "catarray|cat_"),
    ("convolutions", "conv|xmma|cudnn|implicit|gemm|cutlass|sm90|winograd|fft|dgrad|wgrad"),
    ("Adam", "adam|multi_tensor|foreach"),
    ("reductions", "reduce"),
    ("adds", "add"),
]
SPAN = "portbench."


def kind(name: str) -> str:
    low = name.lower()
    return next((k for k, rx in KINDS if re.search(rx, low)), "other")


def union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


class Window:
    """``with Window(device) as w: ...warm calls...; w.open(); ...calls...;
    w.close()``, then ``w.reduced``.  On the CPU (the harness's tests) it
    records host events only."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.reduced = None
        self._span = None
        self.host_s = 0.0

    def __enter__(self):
        self.prof.__enter__()
        return self

    def open(self):
        _sync(self.device)
        self._span = torch.profiler.record_function(SPAN + "window")
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def close(self):
        _sync(self.device)
        self.host_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.reduced = reduce(self.prof)
        return False


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reduce(prof) -> dict:
    from torch.autograd import DeviceType

    events = list(prof.events())
    win = [e for e in events if e.name == SPAN + "window" and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ops = sorted(((e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and w0 <= e.time_range.start and e.time_range.end <= w1), key=lambda t: t[1])
    # the main thread: the one that ran the benchmark's spans
    main = win[0].thread
    host = []
    for e in events:
        if e.device_type == DeviceType.CPU and e.thread == main and w0 <= e.time_range.start <= w1:
            host.append((e.name, e.time_range.start, e.time_range.end))
    host.sort(key=lambda t: (t[1], -t[2]))
    return {"ops": ops, "host": host, "t0_us": w0, "window_us": w1 - w0,
            "busy_us": union_us((s, e) for _, s, e in ops)}


def count(reduced: dict, pattern: str) -> tuple[int, float]:
    """(launches, device us) of the operations whose lower-cased name
    matches ``pattern``."""
    rx = re.compile(pattern)
    hits = [(e - s) for name, s, e in reduced["ops"] if rx.search(name.lower())]
    return len(hits), float(sum(hits))


def idle_gaps(reduced: dict, min_us: float = 0.0):
    """[(what the host was doing, gap us)] for every gap between device
    operations in the window (and before the first, after the last)."""
    host, cur, gaps = reduced["host"], reduced["t0_us"], []
    for _, s, e in reduced["ops"]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    end = reduced["t0_us"] + reduced["window_us"]
    if end > cur:
        gaps.append((cur, end))
    gaps = [g for g in gaps if g[1] - g[0] > min_us]
    # innermost host event covering each gap's middle: host events of one
    # thread nest, so a stack over them in start order finds it
    out, stack, i = [], [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        outer = next((h[0] for h in stack if h[0].startswith(SPAN) and h[0] != SPAN + "window"), "")
        inner = stack[-1][0] if stack and stack[-1][0] != outer else ""
        label = "/".join(p for p in (outer, inner) if p) or "host idle"
        out.append((label, g1 - g0))
    return out


def by_kind(reduced: dict) -> dict:
    """Device seconds of the window by kind, largest first."""
    out: dict = {}
    for name, s, e in reduced["ops"]:
        out[kind(name)] = out.get(kind(name), 0.0) + (e - s) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def breakdown(reduced: dict, top: int = 10) -> dict:
    """The result's ``breakdown``: device seconds by kind and name, and idle
    seconds by what the host was doing, the largest ``top`` of each."""
    by_op: dict = {}
    for name, s, e in reduced["ops"]:
        key = f"{kind(name)}: {name}"[:160]
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-6
    by_gap: dict = {}
    for label, us in idle_gaps(reduced):
        by_gap[label] = by_gap.get(label, 0.0) + us * 1e-6
    pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(by_op), "idle_gaps": pick(by_gap)}


@contextmanager
def span(name: str):
    """A benchmark span around a call into the program (a no-op unless a
    profiler is recording)."""
    with torch.profiler.record_function(SPAN + name):
        yield

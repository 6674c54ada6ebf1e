"""The program's own spans in a traced window, and the host's waits on the
card inside them.  Not a metric (its name starts with ``_``).

The port opens ``fal_net_torch.*`` spans (fal_net_torch/utils/trace.py)
while a profiler records: ``pipeline.dispatch`` and ``pipeline.fetch`` in
the serving pipeline, ``train.loss``, ``train.backward``,
``train.optimizer`` and ``train.aux`` in a training step.  They land in
harness/trace.py's ``host``: the main thread's host events as (name,
start_us, end_us), which nest.  A program older than its spans leaves none
there, and every reader of this module then reads None.

A wait is a CUDA call that blocks the host until the card has done
something: a stream, event or device synchronisation, or a synchronous
copy.  It counts as the program's when the innermost span around it, the
benchmark's ``portbench.*`` spans and the program's alike (operators such
as ``aten::copy_`` are no spans), is one of the program's: the
benchmark's own synchronisations around its window are left out.

A model call is one K1 launch (a batch's forward), or one K2 launch when
the run trains (a step): as the other readers count it.
"""

from __future__ import annotations

from portbench.harness import trace

PROGRAM = "fal_net_torch."
WAITS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"})


def is_span(name: str) -> bool:
    return name.startswith(PROGRAM) or name.startswith(trace.SPAN)


def calls(run) -> int:
    """Model calls in the traced window; 0 without a trace or a launch."""
    if not run.trace:
        return 0
    return trace.count(run.trace, "med_bwd_kernel" if "med_bwd" in run.calls else "med_fwd_kernel")[0]


def traced(run) -> bool:
    """Whether the window holds a model call and one of the program's spans."""
    return calls(run) > 0 and any(name.startswith(PROGRAM) for name, _, _ in run.trace["host"])


def waits(host) -> list:
    """The program's waits, each with the innermost span around it:
    [(name, start_us, end_us, span name)]."""
    out, stack = [], []
    for name, s, e in host:  # in start order, an enclosing event first
        while stack and stack[-1][2] <= s:
            stack.pop()
        if name in WAITS:
            inner = next((h[0] for h in reversed(stack) if is_span(h[0])), "")
            if inner.startswith(PROGRAM):
                out.append((name, s, e, inner))
        stack.append((name, s, e))
    return out


def span_us(host, name: str) -> float:
    """Host microseconds inside the program's span ``name``."""
    return sum(e - s for n, s, e in host if n == PROGRAM + name)

"""K1's share (%) of its roofline: the least time of one call from its
shapes (metrics/_work.py: bytes at HBM's rate or the plain head's
operations at fp32's), over K1's device time per launch in the window."""

from portbench.harness import trace
from portbench.metrics import _work


def read(run):
    launches, us = trace.count(run.trace, "med_fwd_kernel") if run.trace else (0, 0.0)
    if not launches or "med_fwd" not in run.calls:
        return None
    return 100.0 * _work.bound_s(*_work.med_fwd(**run.calls["med_fwd"])) / (us * 1e-6 / launches)

"""K2's share (%) of its roofline, as med_fwd_roofline.py takes K1's."""

from portbench.harness import trace
from portbench.metrics import _work


def read(run):
    launches, us = trace.count(run.trace, "med_bwd_kernel") if run.trace else (0, 0.0)
    if not launches or "med_bwd" not in run.calls:
        return None
    return 100.0 * _work.bound_s(*_work.med_bwd(**run.calls["med_bwd"])) / (us * 1e-6 / launches)

"""Device ms per training step in the optimizer's kernels (the kind "Adam"
of harness/trace.py::KINDS).  A step is one K2 launch."""

from portbench.harness import trace


def read(run):
    steps = trace.count(run.trace, "med_bwd_kernel")[0] if run.trace else 0
    if not steps:
        return None
    us = sum(e - s for name, s, e in run.trace["ops"] if trace.kind(name) == "Adam")
    return us * 1e-3 / steps

"""Share (%) of the device's busy time spent in the NCHW<->NHWC layout
kernels around cuDNN's convolutions (the kind "layout transposes")."""

from portbench.harness import trace


def read(run):
    if not run.trace or not run.trace["busy_us"]:
        return None
    us = sum(e - s for name, s, e in run.trace["ops"] if trace.kind(name) == "layout transposes")
    return 100.0 * us / run.trace["busy_us"]

"""The whole model call's share (%) of the card's peak: the convolution
FLOPs of one call counted on the plain reference (metrics/_work.py), times
the calls in the traced window (K1 launches: one a forward batch or a
training step), over the window's seconds and the peak of the compute
dtype's convolutions (harness/peaks.py)."""

from portbench.harness import trace


def read(run):
    calls = trace.count(run.trace, "med_fwd_kernel")[0] if run.trace else 0
    if not calls:
        return None
    return 100.0 * run.flops_per_call * calls / (run.trace["window_us"] * 1e-6) / run.conv_peak

"""Host ms per training step inside stage 2's ``fal_net_torch.train.teacher``
span (metrics/_spans.py): the frozen teacher's forward launches on the
mirrored pair, with whatever waits on the card sit among them.  None on a
program without the span."""

from portbench.metrics import _spans


def read(run):
    if not _spans.traced(run):
        return None
    us = _spans.span_us(run.trace["host"], "train.teacher")
    return us * 1e-3 / _spans.calls(run) if us else None

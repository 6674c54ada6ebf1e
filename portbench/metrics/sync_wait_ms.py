"""Host ms per model call spent inside the waits that host_syncs counts
(metrics/_spans.py): the time the program's thread waited for the card."""

from portbench.metrics import _spans


def read(run):
    if not _spans.traced(run):
        return None
    return sum(e - s for _, s, e, _ in _spans.waits(run.trace["host"])) * 1e-3 / _spans.calls(run)

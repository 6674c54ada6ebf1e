"""Waits of the host on the card per model call (metrics/_spans.py): the
stream, event and device synchronisations and synchronous copies whose
innermost span is one of the program's.  Each is a point where the host
stops launching until the card catches up; in the pipeline, one inside
``pipeline.dispatch`` holds the next batch's launches behind the last
one's work."""

from portbench.metrics import _spans


def read(run):
    if not _spans.traced(run):
        return None
    return len(_spans.waits(run.trace["host"])) / _spans.calls(run)

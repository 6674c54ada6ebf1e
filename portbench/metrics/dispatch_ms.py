"""Host ms per batch inside the pipeline's ``fal_net_torch.pipeline.dispatch``
span (metrics/_spans.py): the pin, the upload, the forward's launches and
the start of the fetch copy, with whatever waits on the card sit among
them.  At a batch of one it is the launch path that paces the frames."""

from portbench.metrics import _spans


def read(run):
    if not _spans.traced(run):
        return None
    return _spans.span_us(run.trace["host"], "pipeline.dispatch") * 1e-3 / _spans.calls(run)

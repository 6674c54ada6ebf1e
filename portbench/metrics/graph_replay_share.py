"""Share (%) of the traced window's model calls whose forward was replayed
from a CUDA graph: the program's ``fal_net_torch.pipeline.replay`` spans
(fal_net_torch/eval/pipeline.py) over the model calls (metrics/_spans.py:
K1 launches).  None where the window holds no such span (an eager path, or
a program older than the graph) or no model call."""

from portbench.metrics import _spans


def read(run):
    calls = _spans.calls(run)
    if not calls:
        return None
    replays = sum(name == _spans.PROGRAM + "pipeline.replay" for name, _, _ in run.trace["host"])
    return 100.0 * replays / calls if replays else None

"""The 95th percentile over every frame handed back in the window of its
latency: from the pipeline pulling it from the source to its disparity
handed back (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95) * 1e3) if run.latencies_s else None

"""What the port's test files share; each imports this module first.

The tier-1 lane runs several pytest-xdist workers on one machine.  With
torch's default of a thread for every CPU in every worker, the workers'
threads outnumber the cores many times over and wait on each other, so each
worker's torch gets its share of the CPUs, ``THREADS`` (outside xdist: all
of them).  Processes a test starts get the same: ``threads=THREADS`` for
``ddp.launch``, ``env()`` for a subprocess.  pytest collects no tests here
and puts ``tests/`` on ``sys.path``, so test files import it by name.
"""

import os

import numpy as np
import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()
THREADS = max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)


def env(drop=()):
    """This process's environment without the names in ``drop``, with
    ``OMP_NUM_THREADS`` set to ``THREADS`` for a child Python's torch."""
    out = {k: v for k, v in os.environ.items() if k not in drop}
    out["OMP_NUM_THREADS"] = str(THREADS)
    return out


def nchw(a):
    """An NHWC array (numpy, JAX or anything ``np.asarray`` takes) as a
    contiguous NCHW numpy array of the same dtype."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


@pytest.fixture
def default_threads():
    """Torch's own default thread count for one test, ``THREADS`` again
    after it: for a test whose fp32 tolerance holds at that count and not at
    one thread, where torch's CPU kernels sum in another order."""
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(THREADS)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels and the card's paths have no CPU mode)")
    return torch.device("cuda")

"""Seconds from the process's start to the first timed call: loading the
port (and building its kernels in a fresh checkout), the seeded weights and
inputs, the model or trainer (its kernel gate), the FLOP count, and the
warm calls at the cell's own shapes."""


def read(run):
    return run.setup_s

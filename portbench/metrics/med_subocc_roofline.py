"""K1's share (%) of its roofline in its disp+pan+subocc mode: the least
time of one such call from its shapes (metrics/_work_subocc.py) over the
device time per launch of the K1 launches whose template arguments select
that mode (``med_fwd_kernel<true, true, true, ...>``: disp, pan, subocc).
Other modes' launches in the window (a stage-2 step's teacher) are left
out."""

from portbench.harness import trace
from portbench.metrics import _work, _work_subocc

SUBOCC = r"med_fwd_kernel<\s*true\s*,\s*true\s*,\s*true\s*,"


def read(run):
    launches, us = trace.count(run.trace, SUBOCC) if run.trace else (0, 0.0)
    if not launches or "med_subocc" not in run.calls:
        return None
    return 100.0 * _work.bound_s(*_work_subocc.med_subocc(**run.calls["med_subocc"])) / (us * 1e-6 / launches)

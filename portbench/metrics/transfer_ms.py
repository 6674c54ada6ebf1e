"""Device ms per model call of host<->device copies (the profiler's memcpy
activity): the pipeline's uint8 upload and its disparity fetch.  A model
call is one K1 launch: one batch's forward."""

from portbench.harness import trace


def read(run):
    calls = trace.count(run.trace, "med_fwd_kernel")[0] if run.trace else 0
    if not calls:
        return None
    return trace.count(run.trace, "^memcpy")[1] * 1e-3 / calls

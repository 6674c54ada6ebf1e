"""Run-time guards: nothing of JAX in the process, and the port's kernels
launched in the window."""

from __future__ import annotations

import sys

# whole top-level module names: the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "fal_net_tpu")


def jax_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def launch_counts() -> dict:
    """The port's launch counters (K1 by mode, K2, ...), all 0 before its
    library loads."""
    from fal_net_torch.ops import _build

    return _build.launch_counts()


def kernel_launches(before: dict, after: dict) -> dict:
    """{"med_fwd": K1 launches, "med_bwd": K2 launches} between two readings."""
    k1 = sum(after[k] - before[k] for k in after if k.startswith("med_fwd:"))
    return {"med_fwd": k1, "med_bwd": after["med_bwd"] - before["med_bwd"]}

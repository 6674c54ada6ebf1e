"""The readings the correctness limits are set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... [--kinds sound control faults]
        [--seconds 2] [--out FILE]

For each seed, one short run of the cell (the harness's ``measure``, its
window ``--seconds`` long) of each kind, in one process, each printing one
JSON line with the numbers its check compared:

  * ``sound``: the program as the configuration states it: the lower
    readings;
  * ``control``: the program's own bfloat16 path (``dtype`` bfloat16), the
    precision below the configuration's fp32 with TF32 convolutions: the
    upper readings;
  * faults planted underneath the timed path, each the cell's kind can
    have: serving ``answer`` (every disparity handed back 1 px off) and
    ``half_batch`` (the batch's second half answered with its first
    half's disparities; not at a batch of 1); training ``unchanged``
    (Adam's step returns the parameters as they were) and ``half_batch``
    (the loss taken over the batch's first half).

The benchmark's own runs never run this.  portbench/tests/ runs its faults
small on the CPU and the control on the card.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import run as harness  # noqa: E402
from portbench.harness import device as card, spec  # noqa: E402
from portbench.harness.record import Context  # noqa: E402


def fault(kind: str, driver: str):
    """A context that plants the fault ``kind`` in the program."""
    if driver in ("serve", "frame"):
        from fal_net_torch.eval.pipeline import DisparityPipeline

        forward = DisparityPipeline._forward
        if kind == "answer":
            return mock.patch.object(DisparityPipeline, "_forward",
                                     lambda self, x, model=None: forward(self, x, model) + 1.0)
        if kind == "half_batch":
            def half(self, x, model=None):
                h = max(1, x.shape[0] // 2)
                return forward(self, x[:h], model).repeat(2, 1, 1)[: x.shape[0]]

            return mock.patch.object(DisparityPipeline, "_forward", half)
    if driver == "train":
        from fal_net_torch.train.trainer import Trainer

        if kind == "unchanged":
            return mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None)
        if kind == "half_batch":
            loss = Trainer._loss
            return mock.patch.object(Trainer, "_loss",
                                     lambda self, b: loss(self, {k: v[: len(v) // 2] for k, v in b.items()}))
    raise ValueError(f"no fault {kind!r} for the {driver} driver")


FAULTS = {"serve": ("answer", "half_batch"), "frame": ("answer",), "train": ("unchanged", "half_batch")}


def reading(cell: spec.Cell, seed: int, seconds: float, kind: str, dev) -> dict:
    if kind == "control":
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic, dtype="bfloat16"))
    ctx = Context(cell, seed, seconds, False, dev, time.perf_counter())
    plant = contextlib.nullcontext() if kind in ("sound", "control") else fault(kind, cell.driver)
    with plant:
        try:
            result = harness.measure(ctx)
        except Exception as e:  # a control or fault that crashes has failed
            return {"cell": cell.name, "kind": kind, "seed": seed, "error": repr(e)[:400]}
    return {"cell": cell.name, "kind": kind, "seed": seed, "correct": result["correct"],
            "checks": {k: v["value"] for k, v in result["checks"].items()}, "numbers": result.get("numbers"),
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["sound", "control", "faults"])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = card.require(cell.chips)
    kinds = [k for kind in args.kinds for k in (FAULTS[cell.driver] if kind == "faults" else [kind])]
    out = open(args.out, "a") if args.out else None
    try:
        for kind in kinds:
            for seed in args.seeds:
                line = json.dumps(reading(cell, seed, args.seconds, kind, dev))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    print(f"{torch.cuda.get_device_name(dev)}, power limit {card.power_limit()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

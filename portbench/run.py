"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root.  The cell (BENCHMARK.json's ``workloads``)
names a configuration (configs/<config>.json) and a traffic mix
(traffic/<traffic>.json), whose ``driver`` (drivers/<driver>.py) builds the
program under test, ``fal_net_torch``, from the seed, warms it up on the
cell's shapes, measures it for ``--seconds`` and checks its answers against
the plain reference.  Each metric is read by metrics/<name>.py
(metrics/__init__.py): with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics from a profiled window.

Standard output's last line is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when
traced), ``breakdown`` and ``kinds`` (device seconds by kind) when
traced, ``setup_parts`` (set-up's seconds by
part), ``numbers`` (every statistic the comparison with the reference
read) and last ``checks``: each number the
correctness check compared with its limit, which also end standard error.
The run exits non-zero and prints no result without the card(s) the cell
asks for, when JAX or the JAX package is loaded after the window, or when
the port's MED kernels did not launch in the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# One intra-op thread for the process's CPU work (set before torch loads):
# the card's host is shared, and at the frame cell's batch of 1 the default
# thread pool spread its p95 over 18-28 ms, one thread over 14.5-15.6 ms
# (measured on one H100)
os.environ["OMP_NUM_THREADS"] = "1"

from portbench.harness import device as card, guard, spec, trace  # noqa: E402
from portbench.harness.record import Context  # noqa: E402

METRICS_DIR = os.path.join(spec.BENCH_DIR, "metrics")


class Refused(RuntimeError):
    """The run cannot give a result; the message says why."""


def reader(name: str):
    """metrics/<name>.py, else metrics/<name up to its first dot>.py."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(METRICS_DIR, f"{stem}.py")
        if os.path.isfile(path):
            loaded = importlib.util.spec_from_file_location(f"portbench.metrics.{stem}", path)
            module = importlib.util.module_from_spec(loaded)
            loaded.loader.exec_module(module)
            return module.read
    raise Refused(f"no reader for metric {name!r} under {METRICS_DIR}")


def measure(ctx: Context) -> dict:
    """Drive the cell once and return the result's object."""
    driver = importlib.import_module(f"portbench.drivers.{ctx.cell.driver}")
    run = driver.run(ctx)
    found = guard.jax_modules()
    if found:
        raise Refused(f"JAX modules loaded in the run's process: {', '.join(found)}")
    if ctx.device.type == "cuda":
        if run.launches["med_fwd"] <= 0:
            raise Refused(f"K1 (med_fwd) did not launch in the window: {run.launches}")
        if "med_bwd" in run.calls and run.launches["med_bwd"] <= 0:
            raise Refused(f"K2 (med_bwd) did not launch in the window: {run.launches}")
    wanted = ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": dict(run.device)}
    if ctx.trace:
        result["device"].update(busy_s=run.trace["busy_us"] * 1e-6, window_s=run.trace["window_us"] * 1e-6)
        result["breakdown"] = trace.breakdown(run.trace)
        result["kinds"] = trace.by_kind(run.trace)
    finite = lambda v: v if math.isfinite(v) else None  # noqa: E731  JSON has no infinity
    result["setup_parts"] = run.setup_parts
    result["numbers"] = {k: finite(v) for k, v in (run.numbers or {}).items()}
    result["checks"] = {c.name: {"value": finite(c.value), "limit": c.limit} for c in run.checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    try:
        dev = card.require(cell.chips)
        result = measure(Context(cell, args.seed, args.seconds, bool(args.trace), dev, T_START))
    except (card.NoCard, Refused) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    result["device"]["power_limit"] = card.power_limit()
    result["checks"] = result.pop("checks")  # the result's last key
    print(f"{cell.name} seed {args.seed}: correct {result['correct']} on {result['device']['kind']}, "
          f"power limit {result['device']['power_limit']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

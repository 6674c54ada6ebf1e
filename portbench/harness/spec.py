"""A cell's description, gathered by name from BENCHMARK.json and the files
under portbench/:

  * configs/<config>.json   the model's sizes (``variant``, ``num_levels``,
                            ``min_disp``, ``max_disp``), with its source;
  * traffic/<traffic>.json  the driver that runs it and its parameters;
  * workloads/<cell>.json   the limits of the correctness check, with the
                            readings each was set from.

A later cell adds files and BENCHMARK.json entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # and with --trace 1
    chips: int = 1

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; KeyError if the
    benchmark has no such cell."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    config = load_json(os.path.join(BENCH_DIR, "configs", f"{w['config']}.json"))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))["limits"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, limits, e2e, per_layer, w["chips"])

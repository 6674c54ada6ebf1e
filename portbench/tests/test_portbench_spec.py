"""BENCHMARK.json and the files it names: everything loads, every name is
found, and the names, units and metric links keep to the benchmark's rules."""

import json
import os
import re

import pytest

from portbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = spec.cell(cell)
    assert os.path.isfile(os.path.join(spec.BENCH_DIR, "drivers", f"{c.driver}.py"))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        stems = (m["name"], m["name"].split(".", 1)[0])
        assert any(os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics", f"{s}.py")) for s in stems), m["name"]
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_config_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert data["reduced"] == c["reduced"] == []
        assert {"variant", "num_levels", "min_disp", "max_disp", "source", "assumed"} <= set(data)


def test_moves_is_reported_by_every_listed_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in CELLS
            listed = e2e[m["moves"]].get("workloads")
            assert listed is None or cell in listed, (m["name"], cell)


def test_one_layer_name_per_layer():
    """Metrics of one layer spell it alike: each quantity's cells share it."""
    by_quantity = {}
    for m in BENCH["per_layer"]:
        by_quantity.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_quantity.values()), by_quantity

"""Each driver's control flow on the CPU at a tiny size (the port's tiny
variant, 32x64, its plain MED head): a sound run is correct and reports
its cell's metrics; a run with a fault planted under its timed path is not.
The harness's look for a card is skipped by handing ``measure`` a CPU
context.  The cells' own limits are ratios to the reference's TF32 gap,
which the CPU does not have (it reads 0), so these runs hold the raw gaps
to limits of their own: the program's plain head against the plain
reference differs by fp32 rounding alone here."""

import dataclasses
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, run as harness
from portbench.harness import guard, spec
from portbench.harness.record import Context

SMALL = {
    "serve": dict(height=32, width=64, batch=2, pool=5, sample=5, warm_batches=2, trace_warm_batches=1,
                  trace_seconds=0.4),
    "frame": dict(height=32, width=64, pool=3, sample=2, warm_batches=2, trace_warm_batches=1, trace_seconds=0.4),
    "train": dict(height=32, width=64, batch=2, pool=4, trace_seconds=0.4),
}
CELLS = {"serve": "b49_serve_b8", "frame": "b49_frame_b1", "train": "b49_train_stage1_b8"}
SERVE_LIMITS = {"disp_max_px": 1e-2, "disp_mean_px": 1e-3}
CPU_LIMITS = {"serve": SERVE_LIMITS, "frame": SERVE_LIMITS, "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2}}


def tiny(driver: str, **traffic) -> spec.Cell:
    c = spec.cell(CELLS[driver])
    return dataclasses.replace(c, config=dict(c.config, variant="tiny", num_levels=5, max_disp=20.0),
                               traffic=dict(c.traffic, **SMALL[driver], **traffic), limits=CPU_LIMITS[driver])


def measure(cell, trace=False, seed=2 ** 31 + 7):
    return harness.measure(Context(cell, seed, 1.0, trace, torch.device("cpu"), time.perf_counter()))


@pytest.mark.parametrize("driver", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(driver, trace):
    cell = tiny(driver)
    result = measure(cell, trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(cell.limits)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU the device-trace readers find no kernel; the idle share alone reads
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_same_seed_same_answers():
    a, b = measure(tiny("serve")), measure(tiny("serve"))
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("driver,fault", [(d, f) for d, faults in control.FAULTS.items() for f in faults])
def test_fault_is_not_correct(driver, fault):
    with control.fault(fault, driver):
        result = measure(tiny(driver))
    assert result["correct"] is False, result["checks"]


def test_half_batch_fault_at_batch_one_is_the_sound_run():
    """A batch of one has no half to leave out (control.FAULTS lists none)."""
    assert "half_batch" not in control.FAULTS["frame"]


def test_jax_in_the_process_refuses_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert guard.jax_modules() == ["jax"]
    with pytest.raises(harness.Refused, match="jax"):
        measure(tiny("serve"))


def test_names_compared_whole():
    assert guard.jax_modules() == []  # fal_net_torch begins with fal_net_ but is not fal_net_tpu
    assert "fal_net_torch" in {m.split(".")[0] for m in sys.modules}


def test_run_without_a_card_exits_non_zero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "b49_serve_b8", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr

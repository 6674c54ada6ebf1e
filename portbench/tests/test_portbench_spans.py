"""The readers of the program's spans (metrics/_spans.py, host_syncs,
sync_wait_ms, dispatch_ms) on hand-made reductions of a traced window, and
on the CPU's traced runs, where no kernel launched and each reads None."""

import dataclasses
import importlib
import time
import types

import pytest
import torch

from portbench import run as harness
from portbench.harness import spec
from portbench.harness.record import Context
from portbench.metrics import _spans

READERS = ("host_syncs", "sync_wait_ms", "dispatch_ms")


def _run(host, ops, train=False):
    calls = {"med_fwd": {}, "med_bwd": {}} if train else {"med_fwd": {}}
    reduced = {"ops": ops, "host": sorted(host, key=lambda t: (t[1], -t[2])), "t0_us": 0.0, "window_us": 1000.0,
               "busy_us": sum(e - s for _, s, e in ops)}
    return types.SimpleNamespace(trace=reduced, calls=calls)


# two served batches: the benchmark's span around each call into the pipeline;
# inside the first, a dispatch with a hidden upload's stream sync under an
# operator, then the fetch's event sync; the benchmark's own syncs outside
SERVE_HOST = [
    ("portbench.window", 0.0, 1000.0),
    ("portbench.pipeline", 10.0, 400.0),
    ("fal_net_torch.pipeline.dispatch", 20.0, 120.0),
    ("aten::to", 30.0, 60.0),
    ("aten::copy_", 31.0, 59.0),
    ("cudaMemcpyAsync", 32.0, 34.0),
    ("cudaStreamSynchronize", 35.0, 55.0),  # 20 us, the program's (innermost span: dispatch)
    ("cudaLaunchKernel", 70.0, 75.0),  # a launch, no wait
    ("fal_net_torch.pipeline.fetch", 200.0, 300.0),
    ("cudaEventSynchronize", 210.0, 290.0),  # 80 us, the program's
    ("cudaStreamSynchronize", 320.0, 330.0),  # under the benchmark's span alone
    ("portbench.pipeline", 500.0, 700.0),
    ("fal_net_torch.pipeline.dispatch", 510.0, 570.0),
    ("cudaMemcpy", 520.0, 540.0),  # a synchronous copy: 20 us
    ("cudaDeviceSynchronize", 990.0, 999.0),  # the window's own close
]
SERVE_OPS = [("med_fwd_kernel(float*)", 100.0, 110.0), ("Memcpy DtoH", 120.0, 130.0),
             ("med_fwd_kernel(float*)", 600.0, 610.0)]


def _read(name, run):
    return harness.reader(name)(run)


def test_host_syncs_counts_the_waits_under_the_programs_spans_alone():
    waits = _spans.waits(_run(SERVE_HOST, SERVE_OPS).trace["host"])
    assert [(w[0], w[3]) for w in waits] == [
        ("cudaStreamSynchronize", "fal_net_torch.pipeline.dispatch"),
        ("cudaEventSynchronize", "fal_net_torch.pipeline.fetch"),
        ("cudaMemcpy", "fal_net_torch.pipeline.dispatch"),
    ]
    assert _read("host_syncs.serve", _run(SERVE_HOST, SERVE_OPS)) == pytest.approx(3 / 2)


def test_sync_wait_ms_sums_the_waits():
    assert _read("sync_wait_ms.serve", _run(SERVE_HOST, SERVE_OPS)) == pytest.approx((20 + 80 + 20) * 1e-3 / 2)


def test_dispatch_ms_divides_by_k1_launches():
    assert _read("dispatch_ms.serve", _run(SERVE_HOST, SERVE_OPS)) == pytest.approx((100 + 60) * 1e-3 / 2)
    three = SERVE_OPS + [("med_fwd_kernel(float*)", 800.0, 810.0)]
    assert _read("dispatch_ms.frame", _run(SERVE_HOST, three)) == pytest.approx((100 + 60) * 1e-3 / 3)


def test_a_training_step_is_a_k2_launch():
    host = [
        ("portbench.train_step", 0.0, 900.0),
        ("fal_net_torch.train.loss", 10.0, 300.0),
        ("aten::item", 20.0, 40.0),
        ("cudaStreamSynchronize", 22.0, 38.0),  # the max_disp upload: 16 us
        ("fal_net_torch.train.backward", 300.0, 600.0),
        ("fal_net_torch.train.aux", 700.0, 890.0),
        ("aten::_local_scalar_dense", 710.0, 750.0),
        ("cudaStreamSynchronize", 712.0, 748.0),  # 36 us
    ]
    ops = [("med_fwd_kernel", 100.0, 110.0), ("med_bwd_kernel", 400.0, 420.0), ("med_bwd_kernel", 401.0, 402.0)]
    run = _run(host, ops, train=True)
    assert _read("host_syncs.train", run) == pytest.approx(2 / 2)
    assert _read("sync_wait_ms.train", run) == pytest.approx((16 + 36) * 1e-3 / 2)


def test_a_program_without_spans_reads_none():
    """The parent of the spans: the same waits under the benchmark's spans alone."""
    bare = [h for h in SERVE_HOST if not h[0].startswith(_spans.PROGRAM)]
    run = _run(bare, SERVE_OPS)
    assert _spans.waits(run.trace["host"]) == []
    assert all(_read(f"{name}.serve", run) is None for name in READERS)


def test_no_trace_or_no_launch_reads_none():
    assert all(_read(f"{name}.serve", types.SimpleNamespace(trace=None, calls={"med_fwd": {}})) is None
               for name in READERS)
    no_kernel = _run(SERVE_HOST, [op for op in SERVE_OPS if "med_fwd" not in op[0]])
    assert all(_read(f"{name}.serve", no_kernel) is None for name in READERS)


SMALL = {
    "b49_serve_b8": dict(height=32, width=64, batch=2, pool=5, sample=5, warm_batches=2, trace_warm_batches=1,
                         trace_seconds=0.4),
    "b49_frame_b1": dict(height=32, width=64, pool=3, sample=2, warm_batches=2, trace_warm_batches=1,
                         trace_seconds=0.4),
    "b49_train_stage1_b8": dict(height=32, width=64, batch=2, pool=4, trace_seconds=0.4),
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cpu_traced_run_reads_none(cell):
    """On the CPU the program's spans are in the window, but no kernel
    launched on a device: every reader of them reads None."""
    c = spec.cell(cell)
    c = dataclasses.replace(c, config=dict(c.config, variant="tiny", num_levels=5, max_disp=20.0),
                            traffic=dict(c.traffic, **SMALL[cell]), limits={})
    ctx = Context(c, 2 ** 31 + 7, 1.0, True, torch.device("cpu"), time.perf_counter())
    run = importlib.import_module(f"portbench.drivers.{c.driver}").run(ctx)
    assert any(name.startswith(_spans.PROGRAM) for name, _, _ in run.trace["host"])
    for m in c.per_layer:
        if m["name"].split(".")[0] in READERS:
            assert _read(m["name"], run) is None, m["name"]

"""The stage-2 cell's plain reference (portbench/reference/mom.py) against
the port on the CPU: the port's stage-2 step (the Trainer that
portbench/drivers/train_mom.py builds, its teacher loaded from a port
``.pt``, the plain MED head) against the reference's on the same seeded
weights at FAL_netB's widths, N = 49, batch 2 (a double batch of 4) at
64x128, float32; each fault that portbench/control_mom.py plants fails that
comparison; the reference's masks equal the port's plain head's; and
``stage2_loss`` opens its spans under a profiler only."""

import torch_lane  # noqa: F401  (torch's threads sized to the xdist worker)
import dataclasses
import os
import time

import pytest
import torch
from torch.autograd import DeviceType

from fal_net_torch.models import create_model
from fal_net_torch.ops._build import COUNTERS
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.train import stages
from fal_net_torch.utils import trace
from portbench import control_mom
from portbench.drivers import train_mom
from portbench.drivers.serve import shapes
from portbench.drivers.train import vgg_shapes
from portbench.harness import inputs, spec
from portbench.harness.record import Context
from portbench.reference import falnet as ref_falnet, mom as ref_mom, train as ref_train

SEED = 2 ** 31 + 22
CPU = torch.device("cpu")
# The two sides compute the same fp32 arithmetic in other orders: the port
# composes iconv1 and the 1x1 into one conv and gathers every plane at once,
# the reference convolves twice and shifts plane by plane.  Measured here:
# the worst aux gap 1.1e-7 relative (the mirror's), the worst leaf's
# gradient gap 5.2e-5 of the larger of its norm and the median leaf's.  The
# limits leave 90x and 19x of room; each fault reads 0.04 or more in one.
AUX_RTOL = 1e-5
GRAD_GAP = 1e-3


def _cell():
    c = spec.cell("b49_train_stage2_b4")
    return dataclasses.replace(c, traffic=dict(c.traffic, height=64, width=128, batch=2))


def _batch(cell):
    tr = cell.traffic
    left, right = inputs.stereo_pairs(tr["batch"], tr["height"], tr["width"], SEED, CPU)
    return {"left": left, "right": right}


@pytest.fixture(scope="module")
def mom(tmp_path_factory):
    """The cell at 64x128: seeded weights, the reference's loss, aux and
    gradients on one batch, and the port's Trainer built as the driver
    builds it."""
    cell = _cell()
    cfg, tr = cell.config, cell.traffic
    weights = inputs.weights(shapes(cfg["variant"], cfg["num_levels"]), SEED, CPU)
    teacher_weights = inputs.weights(shapes(cfg["teacher"]["variant"], cfg["teacher"]["num_levels"]), SEED, CPU,
                                     stream=train_mom.TEACHER_STREAM)
    vgg_weights = inputs.weights(vgg_shapes(), SEED, CPU, stream=5)
    batch = _batch(cell)

    student = ref_falnet.FalNet(cfg["variant"], cfg["num_levels"])
    student.load_state_dict(weights)
    teacher = ref_falnet.FalNet(cfg["teacher"]["variant"], cfg["teacher"]["num_levels"]).requires_grad_(False)
    teacher.load_state_dict(teacher_weights)
    vgg = ref_train.Vgg19Pool3()
    vgg.load_state_dict(vgg_weights)
    loss, aux = ref_mom.stage2_loss(student, teacher, vgg, batch["left"], batch["right"], cfg["min_disp"],
                                    cfg["max_disp"], tr["a_p"], tr["a_sm"], tr["a_mr"])
    loss.backward()
    want = ({k: float(v.detach()) for k, v in aux.items()},
            {n: p.grad for n, p in student.named_parameters() if p.grad is not None})

    ctx = Context(cell, SEED, 1.0, False, CPU, time.perf_counter())
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.pt")
    trainer = train_mom.build(ctx, weights, vgg_weights, train_mom.write_teacher(cfg, teacher_weights, path))
    return trainer, batch, want


def _port_step(trainer, batch):
    """The port's aux and every leaf's gradient of one stage-2 loss."""
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, aux = trainer._loss(batch)
    loss.backward()
    return ({k: float(v.detach()) for k, v in aux.items()},
            {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None})


def _gaps(got, want):
    """(worst relative aux gap, worst leaf's gradient gap over the larger of
    its reference norm and the median leaf's)."""
    aux = max(abs(got[0][k] - v) / abs(v) for k, v in want[0].items())
    norms = {n: float(g.norm()) for n, g in want[1].items()}
    median = sorted(norms.values())[len(norms) // 2]
    grads = max(float((got[1][n] - g).norm()) / max(norms[n], median) if n in got[1] else 1.0
                for n, g in want[1].items())
    return aux, grads


def test_port_step_matches_the_reference(mom):
    trainer, batch, want = mom
    got = _port_step(trainer, batch)
    assert set(got[0]) == set(want[0]) == {"rec_loss", "sm_loss", "mirror_loss", "loss"}
    assert want[0]["mirror_loss"] > 0
    # the same leaves learn: every parameter but B's unused amask head
    assert set(got[1]) == set(want[1]) and not any(n.startswith("backbone.amask_conv") for n in got[1])
    aux, grads = _gaps(got, want)
    assert aux < AUX_RTOL, got[0]
    assert grads < GRAD_GAP


@pytest.mark.parametrize("kind", control_mom.FAULTS)
def test_planted_fault_fails_the_comparison(mom, kind):
    trainer, batch, want = mom
    with control_mom.fault(kind):
        got = _port_step(trainer, batch)
    aux, grads = _gaps(got, want)
    assert aux >= AUX_RTOL or grads >= GRAD_GAP, (aux, grads)


@pytest.mark.parametrize("max_disp", [300.0, 40.0])
def test_reference_masks_equal_the_port_plain_head(max_disp):
    """Plane by plane (the reference) against every plane gathered at once
    (the port's plain head, the CUDA kernels' yardstick)."""
    g = torch.Generator().manual_seed(SEED)
    logits = 4 * torch.randn(2, 49, 8, 128, generator=g)
    image = torch.randn(2, 3, 8, 128, generator=g)
    out = med_outputs(logits, image, 2.0, max_disp, ret_subocc=True)
    mask_l, mask_r = ref_mom.masks(logits, 2.0, max_disp)
    assert 0.1 < float(mask_l.mean()) and float(mask_r.amax()) <= 1.0
    # sums over 49 planes in another order: 3e-7 apart at most, measured
    torch.testing.assert_close(mask_l, out.maskL, rtol=0, atol=2e-6)
    torch.testing.assert_close(mask_r, out.maskR, rtol=0, atol=2e-6)


def _tiny_step():
    torch.manual_seed(0)
    student, teacher = create_model("tiny", 5, device="cpu"), create_model("tiny", 5, device="cpu")
    teacher.requires_grad_(False)
    batch = _batch(dataclasses.replace(_cell(), traffic=dict(_cell().traffic, height=16, width=32)))
    return lambda: stages.stage2_loss(student, batch, teacher, min_disp=2.0, max_disp=10.0, a_p=0.0, a_sm=0.01,
                                      a_mr=1.0)


def test_stage2_spans_open_under_a_profiler():
    step = _tiny_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    for span in ("train.teacher", "loss.mirror"):
        assert names.count(trace.PREFIX + span) == 1, span


def test_stage2_spans_stay_shut_without_a_profiler(monkeypatch):
    step = _tiny_step()
    opened = []
    monkeypatch.setattr(trace.torch.profiler, "record_function", lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    step()
    assert opened == []


def test_driver_runs_the_cell_small():
    """The driver end to end on the CPU with the tiny model at 32x64: the
    CPU has no TF32 to scale by (``grad_diff_ratio`` is left out), so the
    raw gaps are held to limits of their own, fp32 rounding apart."""
    c = spec.cell("b49_train_stage2_b4")
    tiny = dict(variant="tiny", num_levels=5, max_disp=20.0)
    cell = dataclasses.replace(c, config=dict(c.config, **tiny, teacher=dict(c.config["teacher"], **tiny)),
                               traffic=dict(c.traffic, height=32, width=64, batch=2, pool=4),
                               limits={"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3, "mirror_gap": 1e-5})
    run = train_mom.run(Context(cell, SEED, 0.5, False, CPU, time.perf_counter()))
    assert run.correct, run.numbers
    assert run.attempted > 0 and run.failed == 0 and run.pairs == 2 * run.attempted
    assert set(run.calls) == {"med_subocc", "med_bwd"} and run.calls["med_bwd"]["b"] == 4


def _counts(**by_mode):
    counts = dict.fromkeys(COUNTERS, 0)
    counts.update({k if k == "med_bwd" else f"med_fwd:{k.replace('_', '+')}": v for k, v in by_mode.items()})
    return counts


@pytest.mark.parametrize("window,ok", [
    (dict(disp=5, disp_pan_subocc=5, med_bwd=5), True),
    (dict(med_bwd=5), False),  # the masks on the plain head, not K1
    (dict(disp=5, disp_pan=5, med_bwd=5), False),  # the student without its masks
    (dict(disp=5, disp_pan_subocc=10, med_bwd=5), False),  # a recomputed forward (remat)
])
def test_driver_refuses_a_window_off_the_stage2_launches(window, ok):
    before = _counts(disp=2, disp_pan_subocc=3, med_bwd=3)
    after = {k: v + _counts(**window)[k] for k, v in before.items()}
    if ok:
        train_mom.check_launches(before, after)
    else:
        with pytest.raises(RuntimeError, match="K1 launches by mode"):
            train_mom.check_launches(before, after)


def test_reference_imports_nothing_of_the_program():
    with open(os.path.join(spec.BENCH_DIR, "reference", "mom.py")) as f:
        src = f.read()
    assert "fal_net_torch" not in src and "jax" not in src

"""Stage 1 slow and stage 2 (MOM distillation) in the port vs the JAX package:
the losses and their parameter gradients against jax.value_and_grad of
fal_net_tpu.train.stages, the frozen teacher in the trainer, the setup gate's
modes, and cli.train --stage 1 --slow / --stage 2 on the CPU.

The tiny model's JAX weights are carried into the port by
models/jax_import.py; inputs are seeded numpy arrays.  JAX runs its plain MED
head, the port its plain head and VJP (CPU tensors).  Tolerances are those
of tests/test_torch_train.py: loss and aux at rtol 1e-5, each parameter
gradient within 1e-4 of that tensor's largest magnitude.
"""

from torch_lane import nchw
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_tpu.train import stages as jax_stages
from fal_net_torch.cli import train as train_cli
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import load_model_any, save_checkpoint
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.ops import med_kernel, med_selfcheck
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_vjp import med_vjp
from fal_net_torch.train import stages
from fal_net_torch.train.config import Stage1Config, Stage2Config
from fal_net_torch.train.trainer import Trainer
from test_torch_train import _write_tree

H, W, N, B = 32, 64, 5, 2
A_SM = 0.2 * 2 / 512


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model in plain form; student variables from seed 0,
    teacher variables from seed 1."""
    jax_model = jax_create_model(
        "tiny", N, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
        stem_flow_analytic=False, fuse_logits=False, phase_deconv=False,
    )
    init = lambda seed: jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)), 2.0, 30.0, ret_disp=True)
    return jax_model, init(0), init(1)


def _port_model(variables):
    port = create_model("tiny", N, med_impl="reference", device="cpu")
    sd = state_dict_from_jax(variables["params"], "tiny")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port


def _batches(rng, per_sample):
    """The same seeded pair for JAX (NHWC) and the port (NCHW); per-sample
    bounds have one sample swapped (negative)."""
    left = (rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32)
    right = (rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32)
    jb = {"left": jnp.asarray(left), "right": jnp.asarray(right)}
    tb = {"left": torch.from_numpy(nchw(left)), "right": torch.from_numpy(nchw(right))}
    if per_sample:
        mx = np.asarray([30.0, -20.0], np.float32)
        jb["max_disp"], tb["max_disp"] = jnp.asarray(mx), torch.from_numpy(mx)
    return jb, tb


def _check(port, loss, aux, want, want_aux, jax_grads):
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert aux.keys() == want_aux.keys()
    for k, v in aux.items():
        assert v.ndim == 0, k  # per-batch mean scalars
        np.testing.assert_allclose(v.item(), float(want_aux[k]), rtol=1e-5, err_msg=k)
    grads = convert_state_dict({k: p.grad.numpy() for k, p in port.named_parameters()}, JAX_VARIANTS["tiny"])

    def close(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=jax.tree_util.keystr(path))

    assert jax.tree.structure(grads) == jax.tree.structure(jax_grads["params"])
    jax.tree_util.tree_map_with_path(close, grads, jax_grads["params"])


@pytest.mark.parametrize("per_sample", [False, True])
def test_stage1_slow_loss_and_grads_match_jax(tiny, rng, per_sample):
    jax_model, variables, _ = tiny
    jb, tb = _batches(rng, per_sample)
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=A_SM * 50)
    (want, want_aux), jax_grads = jax.value_and_grad(
        lambda p: jax_stages.stage1_slow_loss(p, jb, jax_model.apply, **kw), has_aux=True
    )(variables)
    port = _port_model(variables)
    loss, aux = stages.stage1_slow_loss(port, tb, **kw)
    _check(port, loss, aux, want, want_aux, jax_grads)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("a_mr", [0.0, 1.0])
def test_stage2_loss_and_grads_match_jax(tiny, rng, a_mr, per_sample):
    """The masks are stop-gradient in both heads, so the occlusion masks
    weigh the reconstruction as constants; the teacher runs outside autograd."""
    jax_model, variables, teacher_vars = tiny
    jb, tb = _batches(rng, per_sample)
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=A_SM * 50, a_mr=a_mr)
    (want, want_aux), jax_grads = jax.value_and_grad(
        lambda p: jax_stages.stage2_loss(p, jb, jax_model.apply, jax_model.apply, teacher_vars, **kw), has_aux=True
    )(variables)
    port, teacher = _port_model(variables), _port_model(teacher_vars)
    teacher.requires_grad_(False)
    loss, aux = stages.stage2_loss(port, tb, teacher, **kw)
    _check(port, loss, aux, want, want_aux, jax_grads)
    if a_mr:  # negative where a sample's bounds are swapped, as in JAX
        assert aux["mirror_loss"].item() != 0


def test_stacked_bounds():
    mn, mx = torch.tensor([1.0, -2.0]), torch.tensor([30.0, -60.0])
    got = stages._stacked((mn, mx))
    torch.testing.assert_close(got[0], torch.tensor([1.0, -2.0, 1.0, -2.0]))
    torch.testing.assert_close(got[1], torch.tensor([30.0, -60.0, 30.0, -60.0]))
    assert stages._stacked((2.0, 300.0)) == (2.0, 300.0)


def _teacher_ckpt(path, variant="tiny", n=N, seed=1):
    save_checkpoint(str(path), create_model(variant, n, generator=torch.Generator().manual_seed(seed), device="cpu"))
    return str(path)


def test_load_model_any_reads_variant_and_planes(tmp_path):
    """The teacher may differ from the student in variant and N."""
    model, variant, n = load_model_any(_teacher_ckpt(tmp_path / "t.pt", "tiny", 7), device="cpu")
    assert (variant, n, model.num_levels) == ("tiny", 7, 7)


def test_teacher_is_frozen(tmp_path):
    """One stage-2 train_step: the teacher's parameters are unchanged, none
    needs a gradient or sits in the optimizer, and the student moved."""
    root = _write_tree(tmp_path / "data", n_pairs=2)
    cfg = Stage2Config(model="tiny", num_levels=N, data_root=root, lists_dir=root, batch_size=2,
                       crop_size=(H, W), a_p=0.0, workers=1, fix_model=_teacher_ckpt(tmp_path / "t.pt", n=7))
    trainer = Trainer(cfg, stage="stage2", device="cpu")
    trainer.setup()
    teacher = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    student = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert trainer.teacher.num_levels == 7 and not trainer.teacher.training
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy((rng.standard_normal((2, 3, H, W)) * 0.3).astype(np.float32))
             for k in ("left", "right")}
    aux = trainer.train_step(batch)
    assert np.isfinite(aux["loss"]) and aux["mirror_loss"] > 0
    for k, v in trainer.teacher.state_dict().items():
        assert torch.equal(v, teacher[k]), k
    assert not any(p.requires_grad or p.grad is not None for p in trainer.teacher.parameters())
    in_opt = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert not in_opt & {id(p) for p in trainer.teacher.parameters()}
    assert in_opt == {id(p) for p in trainer.model.parameters()}
    assert any(not torch.equal(v, student[k]) for k, v in trainer.model.state_dict().items())


@pytest.mark.parametrize("flags", [["--stage", "1", "--slow"], ["--stage", "2"]])
def test_train_cli_later_stages_on_cpu(tmp_path, flags):
    """cli.train --device cpu, two steps of the tiny model; stage 2's
    teacher is a stage-1 checkpoint of another plane count."""
    root = _write_tree(tmp_path / "data", n_pairs=4)
    if "2" in flags:
        flags = flags + ["--fix_model", _teacher_ckpt(tmp_path / "t.pt", n=7)]
    result = train_cli.main([
        *flags, "--model", "tiny", "--no_levels", str(N), "--data_root", root, "--lists_dir", root,
        "--batch_size", "2", "--a_p", "0", "--epochs", "1", "--crop_height", str(H),
        "--crop_width", str(W), "--workers", "2", "--save_path", str(tmp_path / "runs"),
        "--device", "cpu", "--print_freq", "1",
    ])
    (epoch,) = result["history"]
    assert np.isfinite(epoch["loss"]) and epoch["loss"] > 0
    stage = "stage2" if "2" in flags else "stage1_slow"
    assert f"Kitti_{stage}" in result["save_path"]
    meta = torch.load(os.path.join(result["save_path"], "checkpoint.pt"), weights_only=True)
    assert meta["stage"] == stage and meta["step"] == 2


def test_stage2_needs_fix_model(tmp_path):
    root = _write_tree(tmp_path, n_pairs=2)
    with pytest.raises(ValueError, match="fix_model"):
        train_cli.main(["--stage", "2", "--data_root", root, "--lists_dir", root, "--model", "tiny",
                        "--a_p", "0", "--device", "cpu"])
    cfg = Stage2Config(model="tiny", num_levels=N, data_root=root, lists_dir=root, a_p=0.0)
    with pytest.raises(ValueError, match="fix_model"):
        Trainer(cfg, stage="stage2", device="cpu").setup()


@pytest.mark.parametrize(
    "flags", [["--stage", "2", "--slow"], ["--fix_model", "/x"], ["--a_mr", "1"]],
)
def test_stage_flags_of_the_other_stage_raise(flags):
    with pytest.raises(ValueError, match="does not apply|do not apply"):
        train_cli.main(["--data_root", "/nonexistent", "--device", "cpu", *flags])


def test_slow_takes_the_kslow_batch_default():
    assert Stage1Config(slow=True).batch_size == 4 and Stage1Config().batch_size == 8
    cfg = Stage2Config()
    assert (cfg.lr, cfg.epochs, cfg.milestones, cfg.batch_size, cfg.a_mr) == (5e-5, 20, (5, 10), 4, 1.0)


def _plain_kernels(monkeypatch, field=None, offset=0.0):
    """The plain versions stand in for K1 and K2, ``field`` of K1's outputs
    shifted by ``offset``, so that the gate runs on the CPU."""
    def fwd(*a, **kw):
        out = med_outputs(*a, **kw)
        if field and getattr(out, field) is not None:
            out = out._replace(**{field: getattr(out, field) + offset})
        return out

    monkeypatch.setattr(med_kernel, "med_outputs_fused", fwd)
    monkeypatch.setattr(med_kernel, "med_vjp_fused", med_vjp)


def test_selfcheck_checks_every_mode_of_a_run(monkeypatch):
    """The stage-2 modes: the student's subocc masks and the teacher's
    disp-only forward, on the double batch's stacked per-sample bounds."""
    _plain_kernels(monkeypatch)
    bounds = ([2.0, -2.0, 2.0, -2.0], [30.0, -30.0, 30.0, -30.0])
    assert med_selfcheck.med_selfcheck(8, 48, 5, *bounds, "cpu", modes=["disp+pan+subocc"]) == 0.0
    assert med_selfcheck.med_selfcheck(8, 48, 7, *bounds, "cpu", modes=["disp"], backward=False) == 0.0
    for field in ("maskL", "maskR"):
        _plain_kernels(monkeypatch, field, 1e-2)
        with pytest.raises(med_selfcheck.MedSelfcheckError, match=f"{field} disagrees.*subocc"):
            med_selfcheck.med_selfcheck(8, 48, 5, *bounds, "cpu", modes=["disp+pan+subocc"])
        # the disp+pan gate does not read the masks
        med_selfcheck.med_selfcheck(8, 48, 5, *bounds, "cpu")

"""``remat`` in the port: the student's forward under non-reentrant
``torch.utils.checkpoint`` (train/trainer.py::Remat), the counterpart of
JAX's ``jax.checkpoint`` of ``model.apply`` (fal_net_tpu/train/trainer.py:
264-269).

On the CPU, for stage 1, stage 1 slow and stage 2 (a_mr 0 and 1), one
``Trainer.train_step`` with ``remat`` gives the loss, every aux and every
parameter gradient of the step without it exactly (rtol 0, atol 0), also
with ``grad_accum`` 2 and in bf16, while the student's forward runs twice
(forward and recompute); the same steps match JAX's ``Trainer`` with
``remat=True`` on carried weights at tests/test_torch_stages.py's
tolerances (loss rtol 1e-5, each gradient within 1e-4 of its largest
magnitude); ``cli.train --remat --device cpu`` runs two steps and records
``remat: True``.  On a card, tests/test_torch_ops.py counts the launches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_tpu.parallel.mesh import make_mesh
from fal_net_tpu.train import Trainer as JaxTrainer
from fal_net_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from fal_net_tpu.train.config import Stage1Config as JaxStage1Config, Stage2Config as JaxStage2Config
from fal_net_torch.cli import train as train_cli
from fal_net_torch.models import create_model
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.parallel.dryrun import SyntheticStereo
from fal_net_torch.train import Stage1Config, Stage2Config, Trainer
from fal_net_torch.train.trainer import Remat
from test_torch_train import _write_tree

H, W, N, B = 32, 64, 5, 4
# name -> (trainer stage, the stage's own config fields)
STAGES = {
    "stage1": ("stage1", {}),
    "stage1_slow": ("stage1_slow", {}),
    "stage2_amr0": ("stage2", {"a_mr": 0.0}),
    "stage2_amr1": ("stage2", {"a_mr": 1.0}),
}
MODES = {"fp32": {}, "grad_accum2": {"grad_accum": 2}, "bf16": {"compute_dtype": "bfloat16"}}


def _teacher_path(root):
    """The frozen teacher (tiny, seed 1) as a JAX checkpoint, which both trainers read."""
    sd = {k: v.numpy() for k, v in create_model("tiny", N, device="cpu",
                                               generator=torch.Generator().manual_seed(1)).state_dict().items()}
    jax_save_checkpoint(str(root), convert_state_dict(sd, JAX_VARIANTS["tiny"]), {"model_name": "tiny",
                                                                                  "num_levels": N})
    return os.path.join(str(root), "checkpoint.msgpack")


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    return _teacher_path(tmp_path_factory.mktemp("teacher"))


def _configs(name, teacher, jax=False, **kw):
    stage, extra = STAGES[name]
    base = dict(model="tiny", num_levels=N, crop_size=(H, W), batch_size=B, a_p=0.0, workers=1, med_selfcheck=False,
                **kw)
    if stage == "stage2":
        return stage, (JaxStage2Config if jax else Stage2Config)(fix_model=teacher, **extra, **base)
    return stage, (JaxStage1Config if jax else Stage1Config)(**base)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    left, right = ((rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32) for _ in range(2))
    return left, right


def _port_step(stage, cfg, device="cpu", seed=0):
    """One train_step of a fresh trainer (weights from cfg.seed); returns
    the aux, every parameter's gradient, and the student forwards it ran."""
    tr = Trainer(cfg, stage=stage, device=device, train_dataset=SyntheticStereo(B, H, W))
    tr.setup()
    assert isinstance(tr.train_model, Remat) == cfg.remat
    calls = []
    hook = tr.model.register_forward_pre_hook(lambda *_: calls.append(1))
    left, right = _batch(seed)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(tr.device)
    try:
        aux = tr.train_step({"left": nchw(left), "right": nchw(right)})
    finally:
        hook.remove()
    grads = {n: None if p.grad is None else p.grad.detach().cpu().clone() for n, p in tr.model.named_parameters()}
    return aux, grads, len(calls), tr


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(STAGES))
def test_remat_gradients_are_exact(teacher, name, mode):
    stage, plain_cfg = _configs(name, teacher, remat=False, **MODES[mode])
    _, remat_cfg = _configs(name, teacher, remat=True, **MODES[mode])
    aux, grads, plain_calls, _ = _port_step(stage, plain_cfg)
    r_aux, r_grads, remat_calls, _ = _port_step(stage, remat_cfg)
    assert r_aux == aux  # every aux, the loss included, bit for bit
    assert grads.keys() == r_grads.keys()
    for k, g in grads.items():
        if g is None:
            assert r_grads[k] is None, k
            continue
        torch.testing.assert_close(r_grads[k], g, rtol=0, atol=0, msg=k)
    accum = plain_cfg.grad_accum
    assert plain_calls == accum and remat_calls == 2 * accum  # the recompute is each microbatch's own


@pytest.mark.parametrize("name", list(STAGES))
def test_remat_matches_jax(teacher, name):
    """The port's remat step against JAX's Trainer(remat=True) on the
    port's weights; JAX's gradients are recovered from Adam's first moment
    after one step (mu = (1 - beta1) g)."""
    stage, cfg = _configs(name, teacher, remat=True)
    aux, grads, _, _ = _port_step(stage, cfg)
    sd = {k: v.detach().numpy() for k, v in create_model("tiny", N, device="cpu",
                                                         generator=torch.Generator().manual_seed(cfg.seed))
          .state_dict().items()}
    _, jcfg = _configs(name, teacher, jax=True, remat=True)
    jtr = JaxTrainer(jcfg, stage=stage, mesh=make_mesh(1), train_dataset=SyntheticStereo(B, H, W))
    jtr.setup()
    jtr.state = jtr.state.replace(params={"params": convert_state_dict(sd, JAX_VARIANTS["tiny"])})
    left, right = _batch()
    new_state, jaux = jtr.train_step(jtr.state, {"left": jnp.asarray(left), "right": jnp.asarray(right)},
                                     jtr.vgg_params, jtr.teacher_params)
    mu = jax.device_get(new_state.opt_state[0].mu["params"])
    want = {k: v / (1 - jcfg.beta1) for k, v in state_dict_from_jax(mu, "tiny").items()}
    assert set(aux) == set(jaux)
    for k, v in aux.items():
        np.testing.assert_allclose(v, float(jaux[k]), rtol=1e-5, err_msg=k)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_cli_train_remat_on_cpu(tmp_path):
    root = _write_tree(tmp_path / "data", n_pairs=4)
    result = train_cli.main(["--data_root", root, "--lists_dir", root, "--model", "tiny", "--no_levels", str(N),
                             "--a_p", "0", "--device", "cpu", "--epochs", "1", "--epoch_size", "2", "--batch_size",
                             "2", "--crop_height", str(H), "--crop_width", str(W), "--workers", "1", "--print_freq",
                             "1", "--remat", "--save_path", str(tmp_path / "runs")])
    assert np.isfinite(result["history"][0]["loss"])
    with open(os.path.join(result["save_path"], "settings.txt")) as f:
        settings = dict(ln.split(": ", 1) for ln in f.read().splitlines()[1:])
    assert {k.strip(): v for k, v in settings.items()}["remat"] == "True"
    with open(os.path.join(result["save_path"], "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2  # two steps

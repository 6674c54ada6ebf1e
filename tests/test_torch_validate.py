"""The reference's default training run in the port, on the CPU: epoch
validation on KITTI 2015 against the JAX Trainer's, model_best by the
validation RMSE (or the train loss without validation), full-state resume,
the profiler window and the metrics log, and cli.train with the perceptual
term, validation, resume and the profiler.

Validation is held to fal_net_tpu's ``Trainer.validate`` on a 3-frame
KITTI 2015 tree of two shapes (batch 2: one full batch, one padded tail),
the tiny model's weights carried by models/jax_import.py, both MED heads
plain: every metric at rtol 1e-4.  A resumed second epoch equals an
uninterrupted run's at rtol 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fal_net_tpu.data.datasets import kitti2015 as jax_kitti2015
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.parallel.mesh import make_mesh
from fal_net_tpu.train import Stage1Config as JaxStage1Config
from fal_net_tpu.train import Trainer as JaxTrainer
from fal_net_torch.cli import train as train_cli
from fal_net_torch.data.datasets import kitti2015
from fal_net_torch.losses.vgg import init_vgg19
from fal_net_torch.models.checkpoint import load_model_any
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.train.checkpoint import BEST_NAME, CKPT_NAME
from fal_net_torch.train.config import Stage1Config
from fal_net_torch.train.trainer import Trainer
from test_torch_train import _write_tree

N = 5
CROP = (32, 64)
VAL_SHAPES = ((16, 1242), (16, 1242), (16, 1224))  # KITTI widths (the metrics know their focal lengths);
# two shapes: one full batch of 2, one padded tail
META_KEYS = {"epoch", "step", "model_name", "num_levels", "best_metric", "best_value", "stage"}


class Synthetic:
    """Training pairs: right = left shifted by 4 px, no augmentation."""

    def __init__(self, n=4):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, index, rng=None):
        r = np.random.default_rng(index)
        left = r.random((CROP[0], CROP[1] + 4, 3)).astype(np.float32)
        return {"left": left[:, :CROP[1]] - 0.5, "right": left[:, 4:] - 0.5, "max_disp": np.float32(30.0),
                "name": f"s{index}"}


def _write_kitti2015(root, seed=0):
    """Stereo pairs at _10 and _11 and sparse uint16 disparity ground truth."""
    rng = np.random.default_rng(seed)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    for i, (h, w) in enumerate(VAL_SHAPES):
        base = rng.random((h, w + 6, 3))
        for fr in ("10", "11"):
            for cam, view in (("image_2", base[:, :w]), ("image_3", base[:, 6:])):
                img = (view * 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(root, "training", cam, f"{i:06d}_{fr}.png"))
        disp = rng.random((h, w)) * 20 + 2
        disp[rng.random((h, w)) < 0.6] = 0  # sparse, as lidar
        Image.fromarray((disp * 256).astype(np.uint16)).save(
            os.path.join(root, "training", "disp_occ_0", f"{i:06d}_10.png"))
    return str(root)


def _cfg(**kw):
    base = dict(model="tiny", num_levels=N, crop_size=CROP, batch_size=2, workers=1, epochs=1, epoch_size=2,
                max_disp=30.0, min_disp=2.0, a_p=0.0, print_freq=1, val_batch_size=2)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    return _write_kitti2015(str(tmp_path_factory.mktemp("kitti2015")))


def test_validate_matches_jax(val_root):
    """The same weights and frames: RMSE, EPE and the 7 KITTI metrics of
    both Trainers' validate agree."""
    jtr = JaxTrainer(JaxStage1Config(**_cfg(rel_baseline_val=0.8)), stage="stage1", mesh=make_mesh(1),
                     train_dataset=Synthetic())
    jtr.setup()
    jtr.model = jax_create_model("tiny", N, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
                                 stem_flow_analytic=False, fuse_logits=False, phase_deconv=False)
    import jax

    variables = jtr.model.init(jax.random.PRNGKey(0), jnp.zeros((1, *CROP, 3)), 2.0, 30.0, ret_disp=True)
    jtr.state = jtr.state.replace(params=variables)
    _, jval = jax_kitti2015(val_root, split=0, disp=True, load_t1=False)
    want = jtr.validate(jval)

    tr = Trainer(Stage1Config(**_cfg(rel_baseline_val=0.8)), device="cpu", train_dataset=Synthetic())
    tr.setup()
    tr.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], "tiny").items()})
    _, val = kitti2015(val_root, split=0, disp=True, load_t1=False)
    assert len(val) == 3
    got = tr.validate(val)
    assert got.keys() == want.keys() and len(got) == 9
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], float(v), rtol=1e-4, err_msg=k)
    # batch 1 gives the same metrics: batching pads, it does not change a frame's numbers
    tr.cfg.val_batch_size = 1
    for k, v in tr.validate(val).items():
        np.testing.assert_allclose(v, got[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("with_val", [True, False])
def test_model_best_by_rmse_or_train_loss(tmp_path, val_root, monkeypatch, with_val):
    """With validation, model_best is the epoch of lowest RMSE and epochs
    whose validation val_freq skips do not compete; without, the lowest
    train loss.  The meta keys are JAX's (best_rmse only for the RMSE)."""
    _, val = kitti2015(val_root, split=0, disp=True, load_t1=False)
    tr = Trainer(Stage1Config(**_cfg(epochs=4, val_freq=2 if with_val else 1, save_path=str(tmp_path))),
                 device="cpu", train_dataset=Synthetic(), val_dataset=val if with_val else None)
    rmses = iter([5.0, 4.0])  # epochs 0 and 2
    monkeypatch.setattr(tr, "validate", lambda ds, epoch: {"rmse": next(rmses), "epe": 1.0})
    losses = iter([3.0, 1.0, 2.0, 4.0])
    real_epoch = tr.train_epoch
    monkeypatch.setattr(tr, "train_epoch", lambda e, p: {**real_epoch(e, p), "loss": next(losses)})
    result = tr.fit()
    best = torch.load(os.path.join(result["save_path"], BEST_NAME), weights_only=True)
    last = torch.load(os.path.join(result["save_path"], CKPT_NAME), weights_only=True)
    if with_val:
        assert result["best_metric"] == "rmse" and result["best_value"] == 4.0
        assert best["epoch"] == 2 and best["best_rmse"] == 4.0 and last["best_rmse"] == 4.0
        assert META_KEYS | {"best_rmse"} <= best.keys()
        logged = [json.loads(ln) for ln in open(os.path.join(result["save_path"], "metrics.jsonl"))]
        assert [r["step"] for r in logged if "val/rmse" in r] == [0, 2]
    else:
        assert result["best_metric"] == "train_loss" and result["best_value"] == 1.0
        assert best["epoch"] == 1 and "best_rmse" not in best and META_KEYS <= best.keys()
    assert best["best_metric"] == result["best_metric"] and last["epoch"] == 3


def _run(tmp, **kw):
    tr = Trainer(Stage1Config(**_cfg(save_path=str(tmp), milestones=(1,), **kw)), device="cpu",
                 train_dataset=Synthetic())
    return tr, tr.fit()


def test_resume_restores_the_full_state(tmp_path):
    """A resumed second epoch equals an uninterrupted two-epoch run: the
    parameters, Adam's moments, the step and the schedule (its milestone
    falls at the resume); start_epoch follows the checkpoint's epoch, and
    the run continues its directory and metrics log."""
    full, _ = _run(tmp_path / "full", epochs=2)
    first, r1 = _run(tmp_path / "part", epochs=1, profile_steps=1)
    lines = open(os.path.join(r1["save_path"], "metrics.jsonl")).read().splitlines()
    ckpt = os.path.join(r1["save_path"], CKPT_NAME)
    resumed = Trainer(Stage1Config(**_cfg(save_path=str(tmp_path / "other"), milestones=(1,), epochs=2,
                                          resume=ckpt)), device="cpu", train_dataset=Synthetic())
    resumed.setup()
    assert resumed.cfg.start_epoch == 1 and resumed.step == 2
    assert resumed.scheduler.get_last_lr() == first.scheduler.get_last_lr()
    for k, v in first.optimizer.state_dict()["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(resumed.optimizer.state_dict()["state"][k][name], v[name], rtol=0, atol=0)
    r2 = resumed.fit()
    assert r2["save_path"] == r1["save_path"] and [h["epoch"] for h in r2["history"]] == [1]
    assert resumed.step == full.step == 4
    assert resumed.scheduler.get_last_lr() == full.scheduler.get_last_lr() == [5e-5, 5e-5]
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=0, msg=k)
    full_state, res_state = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for k in full_state:
        torch.testing.assert_close(res_state[k]["exp_avg_sq"], full_state[k]["exp_avg_sq"], rtol=1e-5, atol=1e-12)
    after = open(os.path.join(r1["save_path"], "metrics.jsonl")).read().splitlines()
    assert after[: len(lines)] == lines and len(after) > len(lines)  # the log appends across the resume
    with pytest.raises(ValueError, match="model-only"):  # a model-only file cannot resume
        from fal_net_torch.models.checkpoint import save_checkpoint as save_model_only

        save_model_only(str(tmp_path / "m.pt"), full.model)
        Trainer(Stage1Config(**_cfg(resume=str(tmp_path / "m.pt"))), device="cpu",
                train_dataset=Synthetic()).setup()


def test_profiler_trace_and_logger(tmp_path):
    """profile_steps traces steps [1, 1 + profile_steps) of the first
    epoch to a Chrome trace under <run dir>/profile; the JSONL log holds a
    train/ record a print_freq step and settings.txt the config."""
    _, r = _run(tmp_path, epochs=1, epoch_size=2, profile_steps=1)
    prof = os.path.join(r["save_path"], "profile")
    (trace,) = os.listdir(prof)
    assert trace.endswith(".json")
    with open(os.path.join(prof, trace)) as f:
        assert json.load(f)["traceEvents"]
    records = [json.loads(ln) for ln in open(os.path.join(r["save_path"], "metrics.jsonl"))]
    assert [rec["step"] for rec in records] == [1, 2]
    assert all(np.isfinite(rec["train/loss"]) for rec in records)
    assert "profile_steps: 1" in open(os.path.join(r["save_path"], "settings.txt")).read()


def test_default_run_through_the_cli_on_cpu(tmp_path, val_root):
    """cli.train --stage 1 --a_p 0.01 --vgg_weights W.pth --val_root R
    --tbatch_size 2 --profile_steps 1, then --resume for a second epoch, then
    --stage 2 --fix_model <model_best> --a_p 0.01 --val_root R: finite losses
    and validation metrics, best by RMSE, no flag raises."""
    root = _write_tree(tmp_path / "data", n_pairs=4)
    weights = str(tmp_path / "vgg19.pth")
    torch.save(init_vgg19(seed=1).state_dict(), weights)
    common = ["--model", "tiny", "--no_levels", str(N), "--data_root", root, "--lists_dir", root,
              "--batch_size", "2", "--crop_height", str(CROP[0]), "--crop_width", str(CROP[1]), "--workers", "2",
              "--device", "cpu", "--a_p", "0.01", "--vgg_weights", weights, "--val_root", val_root,
              "--tbatch_size", "2", "--save_path", str(tmp_path / "runs")]
    first = train_cli.main(["--stage", "1", "--epochs", "1", "--profile_steps", "1", *common])
    second = train_cli.main(["--stage", "1", "--epochs", "2", "--resume", first["checkpoint"], *common])
    assert second["save_path"] == first["save_path"]
    history = first["history"] + second["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert all(np.isfinite(v) for v in h.values()), h
    assert second["best_metric"] == "rmse" and second["best_value"] == min(h["rmse"] for h in history)
    best = os.path.join(first["save_path"], BEST_NAME)
    assert torch.load(best, weights_only=True)["best_metric"] == "rmse"
    assert os.listdir(os.path.join(first["save_path"], "profile"))
    _, variant, levels = load_model_any(best, device="cpu")
    assert (variant, levels) == ("tiny", N)
    third = train_cli.main(["--stage", "2", "--epochs", "1", "--fix_model", best, *common])
    assert third["best_metric"] == "rmse" and all(np.isfinite(v) for v in third["history"][0].values())

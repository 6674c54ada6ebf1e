"""``--resume`` in the port against JAX's Trainer (fal_net_tpu/train/trainer.py:
336-372) on the same tiny configuration: one epoch, then a second epoch
resumed from each package's own checkpoint.

Both write the resumed run in a new stamped run directory with the same
layout under ``save_path``, both dump the same settings keys (JAX's
``relay_retries`` and ``snapshot_every_steps`` are left behind), and both
start the resumed run's best at -1, so that its first competing epoch
becomes its ``model_best`` even where the first run's epoch was better.
The epochs' train losses are fixed (1.0, then 2.0) so that a carried best
would show.
"""

import json
import os
import re

import pytest
import torch

from fal_net_tpu.parallel.mesh import make_mesh
from fal_net_tpu.train import Stage1Config as JaxStage1Config
from fal_net_tpu.train import Trainer as JaxTrainer
from fal_net_torch.train import Stage1Config, Trainer
from fal_net_torch.train.checkpoint import BEST_NAME, CKPT_NAME
from test_torch_validate import Synthetic, _cfg

STAMP = re.compile(r"\d\d-\d\d-\d\d_\d\d(-\d+)?")
LEFT_BEHIND = {"relay_retries", "snapshot_every_steps"}  # ROADMAP.md, "Leave behind"
LOSSES = (1.0, 2.0)  # epoch 0 beats epoch 1


def _fixed_losses(trainer):
    real = trainer.train_epoch
    trainer.train_epoch = lambda epoch, path: {**real(epoch, path), "loss": LOSSES[epoch]}
    return trainer


def _run_dirs(root, ckpt_name):
    return sorted(os.path.relpath(d, root) for d, _, files in os.walk(root) if ckpt_name in files)


def _layout(rel):
    """(dataset_stage, stamp, leaf) with the stamp checked and dropped."""
    first, stamp, leaf = rel.split(os.sep)
    assert STAMP.fullmatch(stamp), rel
    return first, leaf


def _settings_keys(run_dir):
    with open(os.path.join(run_dir, "settings.txt")) as f:
        return {ln.split(":")[0].strip() for ln in f.read().splitlines()[1:]}


def _jax_runs(root):
    cfg = lambda **kw: JaxStage1Config(**_cfg(save_path=str(root), med_selfcheck=False, **kw))
    tr = _fixed_losses(JaxTrainer(cfg(epochs=1), stage="stage1", mesh=make_mesh(1), train_dataset=Synthetic()))
    tr.fit()
    (first,) = _run_dirs(root, "checkpoint.msgpack")
    resume = os.path.join(root, first, "checkpoint.msgpack")
    tr = _fixed_losses(JaxTrainer(cfg(epochs=2, resume=resume), stage="stage1", mesh=make_mesh(1),
                                  train_dataset=Synthetic()))
    result = tr.fit()
    (second,) = set(_run_dirs(root, "checkpoint.msgpack")) - {first}
    with open(os.path.join(root, second, "checkpoint.json")) as f:
        meta = json.load(f)
    best = os.path.isfile(os.path.join(root, second, "model_best.msgpack"))
    return first, second, result, meta, best


def _port_runs(root):
    cfg = lambda **kw: Stage1Config(**_cfg(save_path=str(root), med_selfcheck=False, **kw))
    r1 = _fixed_losses(Trainer(cfg(epochs=1), device="cpu", train_dataset=Synthetic())).fit()
    resume = os.path.join(r1["save_path"], CKPT_NAME)
    result = _fixed_losses(Trainer(cfg(epochs=2, resume=resume), device="cpu", train_dataset=Synthetic())).fit()
    first, second = (os.path.relpath(r["save_path"], root) for r in (r1, result))
    assert _run_dirs(root, CKPT_NAME) == sorted([first, second])
    meta = torch.load(os.path.join(result["save_path"], CKPT_NAME), weights_only=True)
    best = torch.load(os.path.join(result["save_path"], BEST_NAME), weights_only=True)
    return first, second, result, meta, best


def test_resume_matches_jax(tmp_path):
    j_first, j_second, j_result, j_meta, j_best = _jax_runs(tmp_path / "jax")
    p_first, p_second, p_result, p_meta, p_best = _port_runs(tmp_path / "port")

    # the layout under save_path, apart from the stamp; each resumed run's directory is new
    assert _layout(p_first) == _layout(j_first) and _layout(p_second) == _layout(j_second)
    assert _layout(p_second)[0] == _layout(p_first)[0]  # <dataset>_<stage>, then a stamp of its own
    assert j_second != j_first and p_second != p_first

    # the settings keys, apart from what the port leaves behind
    j_keys = _settings_keys(tmp_path / "jax" / j_second) - LEFT_BEHIND
    assert _settings_keys(tmp_path / "port" / p_second) == j_keys
    assert _settings_keys(tmp_path / "port" / p_first) == _settings_keys(tmp_path / "jax" / j_first) - LEFT_BEHIND

    # the resumed epoch (loss 2.0, worse than the first run's 1.0) is the resumed run's model_best in both
    assert [h["epoch"] for h in j_result["history"]] == [h["epoch"] for h in p_result["history"]] == [1]
    assert j_result["best_value"] == p_result["best_value"] == LOSSES[1]
    assert j_meta["best_value"] == p_meta["best_value"] == LOSSES[1]
    assert j_meta["epoch"] == p_meta["epoch"] == 1
    assert j_best and p_best["epoch"] == 1 and p_best["best_metric"] == j_meta["best_metric"] == "train_loss"


def test_fit_takes_a_save_path(tmp_path):
    """fit(save_path) writes the run where it is told, as JAX's fit does."""
    tr = Trainer(Stage1Config(**_cfg(save_path=str(tmp_path / "runs"), med_selfcheck=False)), device="cpu",
                 train_dataset=Synthetic())
    result = tr.fit(save_path=str(tmp_path / "here"))
    assert result["save_path"] == str(tmp_path / "here")
    assert sorted(os.listdir(tmp_path / "here"))[:3] == ["checkpoint.pt", "metrics.jsonl", "model_best.pt"]
    assert not os.path.exists(tmp_path / "runs")


@pytest.mark.parametrize("resume_from", ["file", "directory"])
def test_resume_leaves_the_first_run_alone(tmp_path, resume_from):
    """The first run's files are byte for byte as they were after a resume
    from its checkpoint file or its run directory."""
    cfg = lambda **kw: Stage1Config(**_cfg(save_path=str(tmp_path), med_selfcheck=False, **kw))
    r1 = Trainer(cfg(epochs=1), device="cpu", train_dataset=Synthetic()).fit()
    before = {n: open(os.path.join(r1["save_path"], n), "rb").read() for n in sorted(os.listdir(r1["save_path"]))
              if os.path.isfile(os.path.join(r1["save_path"], n))}
    resume = r1["save_path"] if resume_from == "directory" else os.path.join(r1["save_path"], CKPT_NAME)
    r2 = Trainer(cfg(epochs=2, resume=resume), device="cpu", train_dataset=Synthetic()).fit()
    assert r2["save_path"] != r1["save_path"]
    after = {n: open(os.path.join(r1["save_path"], n), "rb").read() for n in before}
    assert after == before and set(before) >= {"checkpoint.pt", "model_best.pt", "metrics.jsonl", "settings.txt"}
    assert "resume: " + resume in open(os.path.join(r2["save_path"], "settings.txt")).read()

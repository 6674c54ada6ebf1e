"""Training checkpoints (counterpart of fal_net_tpu/train/checkpoint.py).

A checkpoint is the port's ``.pt`` (:mod:`fal_net_torch.models.checkpoint`:
``{"m_model", "state_dict"}``, the reference's layout) with the run's meta
at the top level, as the reference's ``{"epoch", "m_model", "state_dict",
"best_rmse"}`` (Train_Stage1_K.py:202-207), and the rest of the training
state: Adam's ``state_dict`` (moments and step counts) under ``optimizer``
and the LR schedule's position under ``scheduler`` (JAX's params +
opt_state + step).  ``read_state_dict``, ``load_model_any`` and
``cli.infer --pretrained`` read it as a model-only checkpoint;
:func:`load_checkpoint` restores all of it.  ``model_best.pt`` is a copy of
the best epoch's checkpoint.
"""

from __future__ import annotations

import collections
import os
import shutil
from typing import Any, Dict

import torch

from fal_net_torch.models.checkpoint import strip_data_parallel

CKPT_NAME = "checkpoint.pt"
BEST_NAME = "model_best.pt"
STATE_KEYS = ("m_model", "state_dict", "optimizer", "scheduler")


def save_checkpoint(save_dir: str, model, meta: Dict[str, Any], is_best: bool = False, optimizer=None,
                    scheduler=None) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, CKPT_NAME)
    data = {**meta, "m_model": model.spec.torch_name,
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    if optimizer is not None:  # on the CPU, so that the file loads anywhere
        opt = optimizer.state_dict()
        opt["state"] = {i: {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in st.items()}
                        for i, st in opt["state"].items()}
        data["optimizer"] = opt
    if scheduler is not None:
        # MultiStepLR keeps its milestones in a Counter: stored as a dict so
        # that the file loads with weights_only
        data["scheduler"] = {k: dict(v) if isinstance(v, collections.Counter) else v
                             for k, v in scheduler.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(data, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir, BEST_NAME))
    return path


def load_checkpoint(path: str, trainer) -> Dict[str, Any]:
    """Restore a full-state checkpoint (a file, or a run directory's
    ``checkpoint.pt``) into a set-up trainer: the model's weights, Adam's
    state, the schedule's position and the step.  Returns the meta (epoch,
    step, best_metric, ...).  Raises ValueError for a model-only file."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_NAME)
    data = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer" not in data or "scheduler" not in data:
        raise ValueError(f"{path} holds no optimizer state (a model-only checkpoint): warm-start from it "
                         "with --pretrained instead")
    trainer.model.load_state_dict(strip_data_parallel(data["state_dict"]))
    trainer.optimizer.load_state_dict(data["optimizer"])  # moves the moments to the parameters' device
    sched = dict(data["scheduler"])
    sched["milestones"] = collections.Counter(sched["milestones"])
    trainer.scheduler.load_state_dict(sched)
    trainer.step = int(data["step"])
    return {k: v for k, v in data.items() if k not in STATE_KEYS}

"""Training checkpoints, save side (counterpart of
fal_net_tpu/train/checkpoint.py).

A checkpoint is the port's ``.pt`` (:mod:`fal_net_torch.models.checkpoint`:
``{"m_model", "state_dict"}``, the reference's layout) with the run's meta
at the top level, as the reference's ``{"epoch", "m_model", "state_dict",
"best_rmse"}`` (Train_Stage1_K.py:202-207).  ``load_checkpoint`` and
``cli.infer --pretrained`` read it back.  ``model_best.pt`` is a copy of the
best epoch's checkpoint.  Full-state resume (Adam moments, step) waits for
the trainer's next slice.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import torch

CKPT_NAME = "checkpoint.pt"
BEST_NAME = "model_best.pt"


def save_checkpoint(save_dir: str, model, meta: Dict[str, Any], is_best: bool = False) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, CKPT_NAME)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save({**meta, "m_model": model.spec.torch_name, "state_dict": state}, tmp)
    os.replace(tmp, path)  # a reader never sees a partial file
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir, BEST_NAME))
    return path

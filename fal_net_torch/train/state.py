"""Optimizer and learning-rate schedule (counterpart of
fal_net_tpu/train/state.py).

The reference's setup: Adam(betas=(0.5, 0.999)) (Train_Stage1_K.py:52-54,180)
over two param groups, the biases and everything else, each with its own
weight decay (:177-178), which torch Adam applies as L2-into-grad; and
MultiStepLR x``gamma`` at epoch milestones (:55-56,181), here stepped once
per optimizer step at ``milestone * steps_per_epoch``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


def param_groups(model: nn.Module, weight_decay: float, bias_decay: float):
    """The reference's bias_parameters() / weight_parameters() split."""
    named = list(model.named_parameters())
    biases = [p for name, p in named if name.endswith(".bias")]
    weights = [p for name, p in named if not name.endswith(".bias")]
    return [
        {"params": biases, "weight_decay": bias_decay},
        {"params": weights, "weight_decay": weight_decay},
    ]


def create_optimizer(
    model: nn.Module,
    *,
    lr: float,
    beta1: float,
    beta2: float,
    milestones: Sequence[int],
    lr_gamma: float,
    steps_per_epoch: int,
    start_step: int = 0,
    weight_decay: float = 0.0,
    bias_decay: float = 0.0,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    """Adam and its per-step MultiStepLR.  ``start_step`` is a warm start's
    steps already taken (--pretrained with --start_epoch, the reference's
    restart idiom, Train_Stage1_K.py:183-184): the schedule starts there, so
    milestones already passed are in the first learning rate."""
    boundaries = [int(m) * steps_per_epoch for m in milestones]
    lr0 = lr * lr_gamma ** sum(start_step >= b for b in boundaries)
    opt = torch.optim.Adam(
        param_groups(model, weight_decay, bias_decay), lr=lr0, betas=(beta1, beta2)
    )
    ahead = [b - start_step for b in boundaries if b > start_step]
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=ahead, gamma=lr_gamma)
    return opt, sched

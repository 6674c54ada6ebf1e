"""Training: configs, the stage losses, the optimizer, checkpoints, the
trainer.  The names are JAX's (fal_net_tpu/train/__init__.py), apart from
optax's train state: the port's counterpart of ``TrainState``,
``create_train_state`` and ``make_lr_schedule`` is ``create_optimizer``
(torch Adam and its MultiStepLR)."""

from fal_net_torch.train.checkpoint import load_checkpoint, save_checkpoint
from fal_net_torch.train.config import Stage1Config, Stage2Config, TrainConfig
from fal_net_torch.train.stages import stage1_loss, stage1_slow_loss, stage2_loss
from fal_net_torch.train.state import create_optimizer
from fal_net_torch.train.trainer import Trainer

__all__ = [
    "TrainConfig",
    "Stage1Config",
    "Stage2Config",
    "stage1_loss",
    "stage1_slow_loss",
    "stage2_loss",
    "create_optimizer",
    "save_checkpoint",
    "load_checkpoint",
    "Trainer",
]

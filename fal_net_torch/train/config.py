"""Typed training configs (counterpart of fal_net_tpu/train/config.py),
replacing the reference's argparse blocks (Train_Stage1_K.py:30-70 etc.).
Defaults mirror the reference's shipped hyperparameters exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    model: str = "B"
    num_levels: int = 49
    dataset: str = "Kitti"
    data_root: str = ""
    lists_dir: Optional[str] = None
    crop_size: Tuple[int, int] = (192, 640)
    batch_size: int = 8
    workers: int = 4
    epochs: int = 50
    epoch_size: int = 0  # 0 = full epoch (Train_Stage1_K.py:34)
    lr: float = 1e-4
    beta1: float = 0.5  # adam 'momentum' (Train_Stage1_K.py:53)
    beta2: float = 0.999
    milestones: Tuple[int, ...] = (30, 40)
    lr_gamma: float = 0.5
    weight_decay: float = 0.0  # L2-into-grad on non-bias params, torch Adam's
    #   per-group weight_decay, NOT decoupled AdamW
    #   (Train_Stage1_K.py:57,177-178; reference default 0.0)
    bias_decay: float = 0.0  # same, on bias params (:58,177)
    max_disp: float = 300.0
    min_disp: float = 2.0
    rel_baseline_val: float = 1.0  # validation-set baseline scale
    #                                 (--rel_baset, Train_Stage1_K.py:36,296)
    a_p: float = 0.01  # perceptual weight (Train_Stage1_K.py:43)
    a_sm: float = 0.2 * 2 / 512  # smoothness weight (Train_Stage1_K.py:44)
    fix_order: bool = True  # trainers always pass fix=True
    seed: int = 0
    save_path: str = "runs"
    print_freq: int = 100
    val_freq: int = 1
    val_batch_size: int = 4
    compute_dtype: str = "float32"  # or "bfloat16": the backbone's compute dtype;
    #                                   parameters, Adam and checkpoints stay fp32
    remat: bool = False  # rematerialize the student's forward in the backward
    #                      pass (torch.utils.checkpoint, non-reentrant): its
    #                      activations are recomputed, not kept; the same
    #                      gradients for one more forward (K1 included)
    grad_accum: int = 1  # microbatch count: split each batch into this many
    #                      sequential backward passes and apply their mean,
    #                      the same update as the full batch (up to fp
    #                      reassociation).  batch_size must be divisible by it.
    start_epoch: int = 0
    pretrained: Optional[str] = None  # params-only warm start
    resume: Optional[str] = None  # full-state resume (params + Adam + step)
    save_every_steps: int = 0  # 0 = only per-epoch checkpoints
    profile_steps: int = 0  # profiler trace over this many first-epoch steps
    med_selfcheck: bool = True  # before the first step, compare the MED
    #   kernels (K1, K2) with their plain versions at this run's exact
    #   (crop, levels, bounds); a disagreement RAISES (ops/med_selfcheck.py)
    vgg_weights: Optional[str] = None  # torchvision vgg19 state_dict path
    allow_random_vgg: bool = False  # opt-in: the a_p>0 perceptual term
    #   against RANDOM-init VGG features (the reference always uses
    #   pretrained ImageNet features, loss_functions.py:10,48)

    @property
    def min_max_ratio(self) -> float:
        return self.min_disp / self.max_disp


@dataclasses.dataclass
class Stage1Config(TrainConfig):
    """Stage-1 defaults == TrainConfig defaults (Train_Stage1_K.py)."""

    slow: bool = False  # True -> Train_Stage1_Kslow two-sided variant

    def __post_init__(self):
        if self.slow:
            self.batch_size = 4  # Kslow default (Train_Stage1_Kslow.py:48)


@dataclasses.dataclass
class Stage2Config(TrainConfig):
    """Stage-2 MOM distillation defaults (Train_Stage2_K.py:44-60)."""

    lr: float = 5e-5
    epochs: int = 20
    milestones: Tuple[int, ...] = (5, 10)
    batch_size: int = 4
    a_sm: float = 0.4 * 2 / 512
    a_mr: float = 1.0  # mirror-loss weight
    fix_model: Optional[str] = None  # frozen stage-1 teacher checkpoint

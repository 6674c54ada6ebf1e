"""Data parallelism: one-process device meshes for evaluation and serving
(mesh.py), one process per card under DistributedDataParallel for training
(ddp.py), and a data-parallel dry run (dryrun.py).  JAX's names
(fal_net_tpu/parallel/__init__.py) where they carry over: ``make_mesh``;
the counterparts of its shardings are ``split_batch`` (``batch_sharding``,
``shard_batch``) and ``replicate`` (``replicate_sharding``)."""

from fal_net_torch.parallel.mesh import make_mesh, replicate, split_batch

__all__ = ["make_mesh", "split_batch", "replicate"]

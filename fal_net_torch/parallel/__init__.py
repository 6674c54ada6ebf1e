"""Data parallelism: one-process device meshes for evaluation and serving
(mesh.py), one process per card under DistributedDataParallel for training
(ddp.py), and a data-parallel dry run (dryrun.py)."""

"""The repository's kernel scripts (``scripts/``), ported to the card: each
module keeps its JAX namesake's name and runs as
``python -m fal_net_torch.scripts.<name>``."""

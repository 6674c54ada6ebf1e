"""The port's subpackages export JAX's public names (each subpackage's
``__all__`` in fal_net_tpu), or name the port's counterpart of an optax or
sharding idiom in :data:`COUNTERPARTS`; importing them builds no kernel,
starts no thread and imports no JAX.  ``denormalize`` against JAX's on
numpy."""

from torch_lane import env
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

SUBPACKAGES = ("data", "eval", "train", "losses", "parallel", "utils")
# JAX's name -> the port's counterpart ("module:attribute" under fal_net_torch)
COUNTERPARTS = {
    ("train", "TrainState"): "train.state:create_optimizer",  # torch Adam + MultiStepLR hold the state
    ("train", "create_train_state"): "train.state:create_optimizer",
    ("train", "make_lr_schedule"): "train.state:create_optimizer",
    ("parallel", "batch_sharding"): "parallel.mesh:split_batch",  # one part of the batch per device
    ("parallel", "shard_batch"): "parallel.mesh:split_batch",
    ("parallel", "replicate_sharding"): "parallel.mesh:replicate",  # one copy of the model per device
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_jax_names_have_counterparts(sub):
    jax_pkg = importlib.import_module(f"fal_net_tpu.{sub}")
    port = importlib.import_module(f"fal_net_torch.{sub}")
    assert set(port.__all__) <= set(dir(port)), sub
    for name in jax_pkg.__all__:
        if (sub, name) in COUNTERPARTS:
            module, attr = COUNTERPARTS[(sub, name)].split(":")
            assert callable(getattr(importlib.import_module(f"fal_net_torch.{module}"), attr)), name
            assert name not in port.__all__
            continue
        assert name in port.__all__, f"fal_net_torch.{sub} lacks {name}"
        if hasattr(getattr(jax_pkg, name), "__name__"):  # a function or class: the same one by name
            assert getattr(port, name).__name__ == getattr(jax_pkg, name).__name__, name
    for name in port.__all__:  # nothing beyond JAX's but the counterparts
        assert name in jax_pkg.__all__ or name in {v.split(":")[1] for (s, _), v in COUNTERPARTS.items() if s == sub}


def test_import_is_light():
    """A fresh interpreter imports every subpackage: no kernel library
    loaded or built, no thread started, no JAX."""
    code = f"""
import sys, threading
import fal_net_torch
for sub in {SUBPACKAGES!r}:
    __import__("fal_net_torch." + sub)
from fal_net_torch.ops import _build
from fal_net_torch.train import Trainer, Stage1Config
from fal_net_torch.data import DataLoader, denormalize
assert _build.load_library.cache_info().currsize == 0
assert threading.active_count() == 1, threading.enumerate()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "fal_net_tpu"))
assert not bad, bad
print("LIGHT")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "LIGHT" in proc.stdout, proc.stdout + proc.stderr


def test_denormalize_matches_jax(rng):
    from fal_net_tpu.data.transforms import denormalize as jax_denormalize
    from fal_net_torch.data import denormalize, normalize

    image = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    x = normalize(image)
    np.testing.assert_allclose(denormalize(x), image, atol=1e-4)
    wide = (rng.standard_normal((4, 6, 3)) * 2).astype(np.float32)  # past both ends: clipped
    got, want = denormalize(wide), np.asarray(jax_denormalize(wide))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 255.0

"""fal_net_torch/scripts/soak_train.py, the counterpart of the JAX package's
scripts/soak_train_tpu.py, on the CPU: its synthetic stereo against the
JAX script's own class (loaded by path), the soak's two phases small (the
tiny model, 64x128, batch 2, 3 steps an epoch, a checkpoint every 2 steps)
with every check of the card's run but the launch counts, which are 0 here
(the plain head), and ``main`` refusing to run without a card."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fal_net_torch.scripts import soak_train

JAX_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                          "soak_train_tpu.py")


def _jax_script():
    spec = importlib.util.spec_from_file_location("soak_train_tpu", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [(32, 64), (64, 128)])
def test_smooth_stereo_matches_jax_script(size):
    h, w = size
    want = _jax_script().SmoothStereo(unique=3, length=7, h=h, w=w, seed=5)
    got = soak_train.SmoothStereo(unique=3, length=7, h=h, w=w, seed=5)
    assert len(got) == len(want) == 7
    for i in range(7):
        a, b = got.get(i), want.get(i, None)
        for key in ("left", "right"):
            assert a[key].dtype == b[key].dtype == np.float32 and a[key].shape == (h, w, 3)
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soak_small_on_cpu(tmp_path, dtype):
    """Both phases through ``Trainer.fit``: steps 6 then 9, one resumed
    epoch, finite losses, the resumed loss under 1.2x phase 1's, and the
    step-2 checkpoint (mid-epoch) restoring its step, weights and Adam state
    exactly; the run directory keeps it beside the last checkpoint."""
    res = soak_train.soak(device="cpu", dtype=dtype, model="tiny", num_levels=9, batch_size=2, crop=(64, 128),
                          steps=3, save_every=2, keep_step=2, unique=2, length=8, workdir=str(tmp_path))
    assert res["ok"], res["checks"]
    assert (res["step1"], res["step2"], len(res["losses1"]), len(res["losses2"])) == (6, 9, 2, 1)
    assert res["launches1"] == res["launches2"] == (0, 0, 0) and res["step_ms1"] is None
    run = tmp_path / "run"
    assert (run / "checkpoint.pt").is_file() and (run / "step2.pt").is_file()
    meta = torch.load(run / "checkpoint.pt", map_location="cpu", weights_only=True)
    assert (meta["step"], meta["epoch"]) == (9, 2)


def test_soak_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        soak_train.main([])

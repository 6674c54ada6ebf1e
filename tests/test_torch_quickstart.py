"""The port's quickstart (examples/quickstart_synthetic_torch.py) against
JAX's (examples/quickstart_synthetic.py): the same synthetic stereo samples,
bit for bit, and the walkthrough run to its end on the CPU (16 stage-1
steps of the tiny model at 64x128, then multi-scale post-processing)."""

import torch_lane  # noqa: F401  (torch's threads sized to the xdist worker)
import importlib.util
import math
import os
import re

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port():
    return _load("quickstart_synthetic_torch")


@pytest.fixture(scope="module")
def jax_example():
    return _load("quickstart_synthetic")


@pytest.mark.parametrize("index", [0, 1, 37, 63, 999])
def test_synthetic_samples_equal_jax(port, jax_example, index):
    assert port.SyntheticStereo.DISP == jax_example.SyntheticStereo.DISP
    assert len(port.SyntheticStereo()) == len(jax_example.SyntheticStereo())
    got, want = port.SyntheticStereo().get(index, None), jax_example.SyntheticStereo().get(index, None)
    assert got.keys() == want.keys() and got["name"] == want["name"]
    for key in ("left", "right", "max_disp"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key


def test_quickstart_runs_on_the_cpu(port, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    result = port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["rec_loss"]) for h in result["history"])
    # each epoch's step lines: the running loss at steps 0 and 4 of 8
    losses = [float(x) for x in re.findall(r"^Epoch: \[\d\]\[\d/8\] .* Loss (\S+) ", out, re.M)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert f"training history: {[round(h['loss'], 4) for h in result['history']]}" in out
    disp = result["disparity"]
    assert tuple(disp.shape) == (1, 1, 64, 128) and disp.isfinite().all()
    assert 2.0 <= float(disp.min()) and float(disp.max()) <= 24.0
    lo, hi = (float(x) for x in re.search(r"range \[(\S+), (\S+)\]", out).groups())
    assert 2.0 <= lo <= hi <= 24.0
    assert os.path.isfile(tmp_path / "runs" / "quickstart" / "checkpoint.pt")

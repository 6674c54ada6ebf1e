"""Guards of the port: no JAX in fal_net_torch, no silent CPU or plain-head
stand-in for the CUDA kernel, a clear build error without nvcc, and
chip_smoke.py refusing to run without a GPU.  The last test needs a GPU and
skips without one."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fal_net_torch.models import create_model
from fal_net_torch.ops import _build
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_kernel import MedForward, med_outputs_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO, env_drop=()):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_never_imports_jax():
    code = """
import importlib, pkgutil, sys
import torch
import fal_net_torch
for m in pkgutil.walk_packages(fal_net_torch.__path__, "fal_net_torch."):
    importlib.import_module(m.name)
from fal_net_torch.models import create_model
model = create_model("tiny", 5, generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    out = model(torch.zeros(1, 3, 32, 64), 2.0, 30.0, ret_disp=True, ret_pan=True, ret_subocc=True)
assert torch.isfinite(out.disp).all()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "fal_net_tpu"))
print("IMPORTED", bad)
assert not bad, bad
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED []" in proc.stdout


def test_fused_head_raises_on_cpu_tensors():
    model = create_model("tiny", 5, med_impl="fused")
    with pytest.raises(ValueError, match="CUDA"):
        model(torch.zeros(1, 3, 32, 64), 2.0, 30.0, ret_disp=True)
    logits, image = torch.zeros(1, 5, 4, 16), torch.zeros(1, 3, 4, 16)
    launches = MedForward.launches
    with pytest.raises(ValueError, match="CUDA"):
        med_outputs_fused(logits, image, 2.0, 30.0, ret_disp=True, ret_pan=True)
    # per-sample tensor bounds take the kernel too, so they raise on CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        med_outputs_fused(logits, image, torch.tensor([2.0]), torch.tensor(30.0))
    with pytest.raises(ValueError, match="one bound per sample"):
        med_outputs_fused(logits, image, torch.tensor([2.0, 3.0]), 30.0)
    with pytest.raises(TypeError, match="number or a tensor"):
        med_outputs_fused(logits, image, "2", 30.0)
    assert MedForward.launches == launches


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    _build.load_library.cache_clear()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load_library()
    assert os.listdir(tmp_path) == []


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path, env_drop=("PYTHONPATH",))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MED kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("ret_pan,ret_subocc", [(False, False), (True, False), (True, True)])
def test_med_kernel_matches_plain_on_gpu(cuda_device, ret_pan, ret_subocc, per_sample):
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 49, 16, 300), np.float32)).to(cuda_device)
    image = torch.from_numpy(rng.standard_normal((2, 3, 16, 300), np.float32)).to(cuda_device)
    kw = dict(ret_disp=True, ret_pan=ret_pan, ret_subocc=ret_subocc)
    mn, mx = 2.0, 300.0
    if per_sample:
        mn, mx = torch.tensor([2.0, -1.0], device=cuda_device), torch.tensor([300.0, -30.0], device=cuda_device)
    got = med_outputs_fused(logits, image, mn, mx, **kw)
    torch.cuda.synchronize()
    want = med_outputs(logits, image, mn, mx, **kw)
    torch.testing.assert_close(got.disp, want.disp, rtol=1e-5, atol=1e-4)
    for name in ("pan", "maskL", "maskR"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_auto_takes_kernel_for_tensor_bounds_on_gpu(cuda_device):
    """Per-sample tensor bounds on CUDA go through the kernel as well."""
    model = create_model("tiny", 5, generator=torch.Generator().manual_seed(0), device=cuda_device)
    left = torch.zeros(2, 3, 32, 64, device=cuda_device)
    mn, mx = torch.tensor([2.0, 1.0], device=cuda_device), torch.tensor([30.0, 20.0], device=cuda_device)
    launches = MedForward.launches
    with torch.no_grad():
        got = model(left, mn, mx, ret_disp=True, ret_pan=True)
    assert MedForward.launches == launches + 1
    want = create_model("tiny", 5, med_impl="reference", device=cuda_device)
    want.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = want(left, mn, mx, ret_disp=True, ret_pan=True)
    torch.testing.assert_close(got.disp, ref.disp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.pan, ref.pan, rtol=1e-4, atol=1e-4)

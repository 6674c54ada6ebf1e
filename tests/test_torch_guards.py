"""Guards of the port: no JAX in fal_net_torch, entry points that run on the
GPU unless asked for the CPU, no silent CPU or plain stand-in for the CUDA
kernels (the MED kernels and the ported scripts' conv and roll kernels), a
MED kernel gate that raises, a clear build error without nvcc,
and chip_smoke.py refusing to run without a GPU.  The tests marked cuda need
a GPU and skip without one."""

import importlib
import importlib.util
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
from fal_net_torch.ops import conv3x3, med_kernel, med_selfcheck, roll_probe
from fal_net_torch.ops.med_kernel import MedForward, med_outputs_fused, med_vjp_fused
from fal_net_torch.ops.med_vjp import med_vjp

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
from fal_net_torch.train.stages import stage1_loss
model = create_model("tiny", 5, generator=torch.Generator().manual_seed(0), device="cpu")
with torch.no_grad():
    out = model(torch.zeros(1, 3, 32, 64), 2.0, 30.0, ret_disp=True, ret_pan=True, ret_subocc=True)
assert torch.isfinite(out.disp).all()
with torch.no_grad():
    out16 = model.with_dtype("bfloat16")(torch.zeros(1, 3, 32, 64), 2.0, 30.0, ret_disp=True)
assert torch.isfinite(out16.disp).all() and out16.disp.dtype == torch.float32
batch = {"left": torch.zeros(1, 3, 32, 64), "right": torch.zeros(1, 3, 32, 64)}
loss, _ = stage1_loss(model, batch, min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=0.1)
loss.backward()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "fal_net_tpu"))
print("IMPORTED", bad)
assert not bad, bad
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED []" in proc.stdout


def test_no_jax_in_the_port_sources():
    """A grep of every source of the port (python, CUDA and the native C++
    decoder), of chip_smoke.py and of the port's quickstart: no import of jax, jaxlib, flax, msgpack
    or fal_net_tpu, and no C++ include from fal_net_tpu.  The port reads
    JAX's msgpack checkpoints with its own decoder (models/msgpack.py)."""
    import glob
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|msgpack|fal_net_tpu)\b"
                         r"|#\s*include\s+[<\"][^>\"]*fal_net_tpu", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "examples", "quickstart_synthetic_torch.py")]
    for ext in ("py", "cu", "cuh", "cpp"):
        files += glob.glob(os.path.join(REPO, "fal_net_torch", "**", f"*.{ext}"), recursive=True)
    assert any(f.endswith(os.path.join("native", "io_native.cpp")) for f in files)
    assert any(f.endswith(os.path.join("parallel", "ddp.py")) for f in files)
    assert any(f.endswith(os.path.join("models", "msgpack.py")) for f in files)
    for f in files:
        with open(f) as fh:
            hits = pattern.findall(fh.read())
        assert not hits, (f, hits)


def test_fused_head_raises_on_cpu_tensors():
    model = create_model("tiny", 5, med_impl="fused", device="cpu")
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


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """create_model, load_checkpoint, cli.train and the port's quickstart
    default to the GPU; without one they raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("tiny", 5)
    from fal_net_torch.cli import train
    from fal_net_torch.models.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "tiny.pt")
    save_checkpoint(path, create_model("tiny", 5, device="cpu"))
    with pytest.raises(RuntimeError, match="is_available"):
        load_checkpoint(path)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--data_root", str(tmp_path), "--model", "tiny", "--a_p", "0"])
    spec = importlib.util.spec_from_file_location(
        "_quickstart_torch", os.path.join(REPO, "examples", "quickstart_synthetic_torch.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        quickstart.main([])
    assert os.listdir(tmp_path) == ["tiny.pt"]  # raised before it wrote a run directory


def test_k2_raises_on_cpu_tensors():
    logits, image = torch.zeros(1, 5, 4, 16), torch.zeros(1, 3, 4, 16)
    g_disp, g_pan = torch.zeros(1, 1, 4, 16), torch.zeros(1, 3, 4, 16)
    launches = MedForward.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        med_vjp_fused(logits, image, 2.0, 30.0, g_disp, g_pan)
    assert MedForward.bwd_launches == launches


def test_script_kernels_raise_on_cpu_tensors():
    """K3, K4 and K5 raise on CPU tensors instead of running their plain
    versions, and count no launch."""
    counts = dict(conv3x3.LAUNCHES), dict(roll_probe.LAUNCHES)
    x, w = torch.zeros(1, 4, 8, 8), torch.zeros(2, 4, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.conv3x3_packed(x, conv3x3.repack_weights(w))
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.conv3x3_v2(x, conv3x3.permuted_weights(w))
    with pytest.raises(ValueError, match="CUDA"):
        roll_probe.roll_window(torch.zeros(8, 128), torch.zeros(1, dtype=torch.int32), 384)
    assert (dict(conv3x3.LAUNCHES), dict(roll_probe.LAUNCHES)) == counts


@pytest.mark.parametrize("script", ["proto_conv_kernel", "proto_conv_kernel_v2", "probe_roll_bug"])
def test_ported_scripts_need_cuda(script):
    """The ported kernel scripts run on the card or raise; never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the script would run for real")
    module = importlib.import_module(f"fal_net_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="is_available"):
        module.main([])


def _plain_kernels(monkeypatch, offset=0.0):
    """Stand the plain versions in for K1 and K2 (shifted by ``offset``), so
    that the gate runs on the CPU."""
    def fwd(*a, **kw):
        out = med_outputs(*a, **kw)
        return out._replace(pan=out.pan + offset)

    def bwd(*a, **kw):
        g_logits, g_image = med_vjp(*a, **kw)
        return g_logits + offset, g_image

    monkeypatch.setattr(med_kernel, "med_outputs_fused", fwd)
    monkeypatch.setattr(med_kernel, "med_vjp_fused", bwd)


def test_med_selfcheck_passes_agreeing_kernels(monkeypatch):
    _plain_kernels(monkeypatch)
    assert med_selfcheck.med_selfcheck(8, 48, 5, [2.0], [30.0], "cpu") == 0.0
    assert med_selfcheck.med_selfcheck(8, 48, 5, [2.0, -2.0], [30.0, -30.0], "cpu") == 0.0


def test_med_selfcheck_raises_on_disagreement(monkeypatch):
    _plain_kernels(monkeypatch, offset=1e-2)
    with pytest.raises(med_selfcheck.MedSelfcheckError, match="pan disagrees"):
        med_selfcheck.med_selfcheck(8, 48, 5, [2.0], [30.0], "cpu")


def test_k1_gate_checks_each_shape_once_and_raises(monkeypatch):
    """gate_k1 (the Evaluator's and the validation's gate) holds K1 once per
    (mode, shape), records the error, and raises on a disagreement."""
    _plain_kernels(monkeypatch)
    monkeypatch.setattr(med_kernel, "describe_plan", lambda *a, **kw: "plan")
    calls = []
    check = med_selfcheck.med_selfcheck
    monkeypatch.setattr(med_selfcheck, "med_selfcheck", lambda *a, **kw: calls.append(a[:2]) or check(*a, **kw))
    checked = {}
    for _ in range(2):
        med_selfcheck.gate_k1(checked, "disp+pan+subocc", 8, 48, 5, (2.0, 30.0), "cpu")
    med_selfcheck.gate_k1(checked, "disp+pan+subocc", 6, 40, 5, (2.0, 30.0), "cpu")
    assert calls == [(8, 48), (6, 40)] and checked == {("disp+pan+subocc", 8, 48): 0.0, ("disp+pan+subocc", 6, 40): 0.0}
    _plain_kernels(monkeypatch, offset=1e-2)
    with pytest.raises(med_selfcheck.MedSelfcheckError, match="disagrees"):
        med_selfcheck.gate_k1({}, "disp+pan+subocc", 8, 48, 5, (2.0, 30.0), "cpu")


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


@pytest.mark.cuda
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("want_disp,want_pan,image_grad", [(True, True, False), (True, True, True), (True, False, False), (False, True, True)])
def test_med_bwd_kernel_matches_plain_on_gpu(cuda_device, want_disp, want_pan, image_grad, per_sample):
    rng = np.random.default_rng(0)
    draw = lambda c: torch.from_numpy(rng.standard_normal((2, c, 16, 300), np.float32)).to(cuda_device)
    logits, image = draw(49), draw(3)
    g_disp = draw(1) if want_disp else None
    g_pan = draw(3) if want_pan else None
    mn, mx = 2.0, 300.0
    if per_sample:
        mn, mx = torch.tensor([2.0, -1.0], device=cuda_device), torch.tensor([300.0, -30.0], device=cuda_device)
    got = med_vjp_fused(logits, image, mn, mx, g_disp, g_pan, image_grad=image_grad)
    torch.cuda.synchronize()
    want = med_vjp(logits, image, mn, mx, g_disp, g_pan, image_grad=image_grad)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_training_step_launches_k1_and_k2_once_on_gpu(cuda_device):
    """One stage-1 backward through the model: one K1 and one K2 launch, and
    the logits' gradient equals the plain VJP's on the same logits."""
    from fal_net_torch.train.stages import stage1_loss

    model = create_model("tiny", 9, generator=torch.Generator().manual_seed(0), device=cuda_device)
    rng = np.random.default_rng(0)
    draw = lambda: torch.from_numpy(rng.standard_normal((2, 3, 32, 64), np.float32)).to(cuda_device)
    batch = {"left": draw(), "right": draw()}
    k1, k2 = MedForward.launches, MedForward.bwd_launches
    loss, _ = stage1_loss(model, batch, min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=0.1)
    loss.backward()
    torch.cuda.synchronize()
    assert (MedForward.launches - k1, MedForward.bwd_launches - k2) == (1, 1)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())

"""The fal_net_torch PyTorch ops (fal_net_torch/ops/library.py): their
schemas, fake impls and autograd formula under ``torch.library.opcheck``,
their plain CPU kernels against the JAX package (its Pallas MED kernel in
interpret mode), and, on the card (marked cuda), their CUDA impls against
the plain versions and the launch counts they keep, a remat training step's
included.

Tolerances are those of tests/test_med_pallas.py: 1e-4 on forward outputs
(disp 1e-5 relative), rtol 1e-4 and atol 1e-5 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.ops.med_pallas import med_outputs_fused as jax_med_outputs_fused
from fal_net_torch.ops import _build, conv3x3, med_kernel, roll_probe
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_kernel import MedForward, plane_tables
from fal_net_torch.ops.med_vjp import med_vjp

OPS = torch.ops.fal_net_torch
TOL = {"disp": (1e-5, 1e-4), "pan": (1e-4, 1e-4), "maskL": (1e-4, 1e-4), "maskR": (1e-4, 1e-4)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# K1's modes: (want_disp, want_pan, want_subocc)
FWD_MODES = {"disp": (True, False, False), "pan": (False, True, False), "disp+pan": (True, True, False),
             "subocc": (False, False, True), "disp+subocc": (True, False, True), "pan+subocc": (False, True, True),
             "disp+pan+subocc": (True, True, True)}
# K2's cotangents: (g_disp, g_pan, image_grad)
BWD_MODES = {"disp+pan": (True, True, False), "disp+pan+g_img": (True, True, True), "disp": (True, False, False),
             "pan+g_img": (False, True, True)}


def _draw(rng, b, c, h, w):
    return torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))


def _tables(per_sample, b, n, w):
    if per_sample:
        return plane_tables(torch.tensor([2.0, -1.0][:b]), torch.tensor([30.0, -20.0][:b]), n, w)
    return plane_tables(2.0, 30.0, n, w)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("mode", list(FWD_MODES))
def test_med_fwd_opcheck(rng, mode, per_sample):
    """Schema, fake impl, autograd registration and AOT dispatch of med_fwd,
    and its CPU kernel equal to the plain head (the requested outputs; an
    unrequested one is an empty tensor)."""
    logits, image = _draw(rng, 2, 5, 4, 16), _draw(rng, 2, 3, 4, 16)
    tables = _tables(per_sample, 2, 5, 16)
    torch.library.opcheck(OPS.med_fwd.default, (logits.requires_grad_(), image.requires_grad_(), tables,
                                                 *FWD_MODES[mode]))
    d, p, s = FWD_MODES[mode]
    bounds = (torch.tensor([2.0, -1.0]), torch.tensor([30.0, -20.0])) if per_sample else (2.0, 30.0)
    with torch.no_grad():
        got = OPS.med_fwd(logits, image, tables, d, p, s)
        want = med_outputs(logits, image, *bounds, ret_disp=d, ret_pan=p, ret_subocc=s)
    for g, w in zip(got, (want.disp, want.pan, want.maskL, want.maskR)):
        if w is None:
            assert g.numel() == 0
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", list(BWD_MODES))
def test_med_bwd_opcheck(rng, mode):
    """med_bwd with and without g_img, and with one cotangent; its CPU kernel
    is the plain VJP."""
    logits, image = _draw(rng, 2, 5, 4, 16), _draw(rng, 2, 3, 4, 16)
    d, p, img = BWD_MODES[mode]
    g_disp = _draw(rng, 2, 1, 4, 16) if d else None
    g_pan = _draw(rng, 2, 3, 4, 16) if p else None
    tables = _tables(False, 2, 5, 16)
    torch.library.opcheck(OPS.med_bwd.default, (logits, image, g_disp, g_pan, tables, img))
    g_logits, g_image = OPS.med_bwd(logits, image, g_disp, g_pan, tables, img)
    want = med_vjp(logits, image, 2.0, 30.0, g_disp, g_pan, image_grad=img)
    torch.testing.assert_close(g_logits, want[0], rtol=0, atol=0)
    assert (g_image.numel() == 0) == (want[1] is None)


def test_conv3x3_and_roll_window_opcheck(rng):
    x = _draw(rng, 2, 4, 5, 7)
    w2 = conv3x3.repack_weights(_draw(rng, 3, 4, 3, 3))
    torch.library.opcheck(OPS.conv3x3.default, (x, w2))
    torch.testing.assert_close(OPS.conv3x3(x, w2), conv3x3.conv3x3_tf32_plain(x, w2), rtol=0, atol=0)
    row = _draw(rng, 1, 1, 8, 128)[0, 0]
    for wp, f in ((384, 5), (640, -3), (512, 517)):
        ft = torch.tensor([f], dtype=torch.int32)
        torch.library.opcheck(OPS.roll_window.default, (row, ft, wp, 128))
        torch.testing.assert_close(OPS.roll_window(row, ft, wp, 128), roll_probe.roll_window_plain(row, ft, wp, 128))


def _nhwc(t):
    return jnp.asarray(t.numpy().transpose(0, 2, 3, 1))


@pytest.mark.parametrize("b,n,h,w,mn,mx", [(2, 9, 8, 96, 2.0, 300.0), (1, 49, 4, 140, 2.0, 300.0),
                                            (2, 7, 8, 48, 1.0, 30.0)])
def test_med_fwd_cpu_matches_jax_fused(rng, b, n, h, w, mn, mx):
    """The op (through ``med_outputs_op``) against JAX's Pallas MED kernel in
    interpret mode, every output, on the same seeded inputs."""
    logits, image = _draw(rng, b, n, h, w), _draw(rng, b, 3, h, w)
    got = med_kernel.med_outputs_op(logits, image, mn, mx, ret_disp=True, ret_pan=True, ret_subocc=True,
                                    cuda=False)
    want = jax_med_outputs_fused(_nhwc(logits), _nhwc(image), mn, mx, ret_disp=True, ret_pan=True,
                                 ret_subocc=True, interpret=True)
    for name, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)).transpose(0, 3, 1, 2),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("disp_term,pan_term", [(True, True), (True, False), (False, True)])
def test_med_fwd_gradients_match_jax_fused(rng, disp_term, pan_term):
    """Autograd through med_fwd (its backward is med_bwd) against jax.grad of
    JAX's Pallas kernel in interpret mode, under the JAX tests' loss; masks
    requested and stop-gradient."""
    n, mn, mx = 7, 2.0, 60.0
    logits, image = _draw(rng, 1, n, 8, 128), _draw(rng, 1, 3, 8, 128)
    lg, im = logits.clone().requires_grad_(), image.clone().requires_grad_()
    out = med_kernel.med_outputs_op(lg, im, mn, mx, ret_disp=True, ret_pan=True, ret_subocc=True, cuda=False)
    assert not out.maskL.requires_grad and not out.maskR.requires_grad
    loss = out.maskL.sum() + out.maskR.sum()
    loss = loss + (torch.sin(out.pan).sum() if pan_term else 0) + (torch.cos(out.disp / 300.0).sum() if disp_term else 0)
    gl, gi = torch.autograd.grad(loss, (lg, im), allow_unused=True)

    def jax_loss(lg, im):
        o = jax_med_outputs_fused(lg, im, mn, mx, ret_disp=True, ret_pan=True, interpret=True)
        return (jnp.sum(jnp.sin(o.pan)) if pan_term else 0.0) + (jnp.sum(jnp.cos(o.disp / 300.0)) if disp_term else 0.0)

    jl, ji = jax.grad(jax_loss, argnums=(0, 1))(_nhwc(logits), _nhwc(image))
    np.testing.assert_allclose(gl.numpy(), np.asarray(jl).transpose(0, 3, 1, 2), **GRAD_TOL)
    if pan_term:
        np.testing.assert_allclose(gi.numpy(), np.asarray(ji).transpose(0, 3, 1, 2), **GRAD_TOL)
    else:
        assert gi is None  # disp does not read the image


def test_launch_counts_read_zero_without_the_library(monkeypatch):
    """Before any kernel is loaded the counts read 0, without a build."""
    monkeypatch.setattr(_build.load_library, "cache_info", lambda: type("I", (), {"currsize": 0})())
    assert set(_build.launch_counts().values()) == {0}
    assert (MedForward.launches, MedForward.bwd_launches, MedForward.mode_launches) == (0, 0, {})
    assert dict(conv3x3.LAUNCHES) == {"conv3x3": 0} and dict(roll_probe.LAUNCHES) == {"roll_window": 0}
    with pytest.raises(AttributeError):
        MedForward.launches = 0  # read-only: _build.reset_launch_counts() sets them to 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ops' CUDA impls are the hand-written kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("mode", list(FWD_MODES))
def test_med_fwd_op_matches_plain_on_gpu(cuda_device, mode, per_sample):
    rng = np.random.default_rng(0)  # the GPU lane runs without tests/conftest.py
    logits, image = _draw(rng, 2, 49, 8, 300).to(cuda_device), _draw(rng, 2, 3, 8, 300).to(cuda_device)
    tables = _tables(per_sample, 2, 49, 300).to(cuda_device)
    bounds = ((torch.tensor([2.0, -1.0], device=cuda_device), torch.tensor([30.0, -20.0], device=cuda_device))
              if per_sample else (2.0, 30.0))
    d, p, s = FWD_MODES[mode]
    _build.load_library()
    before = dict(MedForward.mode_launches)
    got = OPS.med_fwd(logits, image, tables, d, p, s)
    torch.cuda.synchronize()
    assert MedForward.mode_launches.get(mode, 0) == before.get(mode, 0) + 1
    want = med_outputs(logits, image, *bounds, ret_disp=d, ret_pan=p, ret_subocc=s)
    for (name, (rtol, atol)), g in zip(TOL.items(), (got[0], got[1], got[2], got[3])):
        w = getattr(want, name)
        if w is None:
            assert g.numel() == 0
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BWD_MODES))
def test_med_bwd_op_matches_plain_on_gpu(cuda_device, mode):
    rng = np.random.default_rng(0)
    dev = cuda_device
    logits, image = _draw(rng, 2, 49, 8, 300).to(dev), _draw(rng, 2, 3, 8, 300).to(dev)
    d, p, img = BWD_MODES[mode]
    g_disp = _draw(rng, 2, 1, 8, 300).to(dev) if d else None
    g_pan = _draw(rng, 2, 3, 8, 300).to(dev) if p else None
    _build.load_library()
    k2 = MedForward.bwd_launches
    g_logits, g_image = OPS.med_bwd(logits, image, g_disp, g_pan, plane_tables(2.0, 300.0, 49, 300).to(dev), img)
    torch.cuda.synchronize()
    assert MedForward.bwd_launches == k2 + 1
    want = med_vjp(logits, image, 2.0, 300.0, g_disp, g_pan, image_grad=img)
    torch.testing.assert_close(g_logits, want[0], **GRAD_TOL)
    if want[1] is None:
        assert g_image.numel() == 0
    else:
        torch.testing.assert_close(g_image, want[1], **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e8, 1e10, 1e12])
def test_med_kernels_stay_finite_at_saturated_logits_on_gpu(cuda_device, scale):
    """Logits of 1e8 and more, as FAL_netC's convergence run reaches: a
    one-hot softmax.  K1's outputs and K2's gradients equal the plain
    versions at the kernel tests' tolerances (K2 once gave NaN there: an
    exponent built from a fused product passed the maximum; since both
    kernels subtract the maximum in the logit domain, pan, the masks and
    g_image equal the plain versions too, not only finite and bounded)."""
    rng, dev = np.random.default_rng(1), cuda_device
    logits = (_draw(rng, 2, 33, 8, 300) * scale).to(dev)
    image, g_pan = _draw(rng, 2, 3, 8, 300).to(dev), _draw(rng, 2, 3, 8, 300).to(dev)
    g_disp = _draw(rng, 2, 1, 8, 300).to(dev)
    got = med_kernel.med_outputs_fused(logits, image, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    want = med_outputs(logits, image, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    for name in ("disp", "pan", "maskL", "maskR"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=TOL[name][0], atol=TOL[name][1])
    g_logits, g_image = med_kernel.med_vjp_fused(logits, image, 2.0, 300.0, g_disp, g_pan, image_grad=True)
    want = med_vjp(logits, image, 2.0, 300.0, g_disp, g_pan, image_grad=True)
    torch.testing.assert_close(g_logits, want[0], **GRAD_TOL)
    torch.testing.assert_close(g_image, want[1], **GRAD_TOL)


@pytest.mark.cuda
def test_med_fwd_autograd_runs_k2_on_gpu(cuda_device):
    """Autograd through the op on the card: one K1 and one K2 launch, and
    the gradients of the plain VJP."""
    rng, dev = np.random.default_rng(0), cuda_device
    logits, image = _draw(rng, 2, 49, 8, 300).to(dev), _draw(rng, 2, 3, 8, 300).to(dev)
    g_disp, g_pan = _draw(rng, 2, 1, 8, 300).to(dev), _draw(rng, 2, 3, 8, 300).to(dev)
    lg, im = logits.clone().requires_grad_(), image.clone().requires_grad_()
    k1, k2 = MedForward.launches, MedForward.bwd_launches
    out = med_kernel.med_outputs_fused(lg, im, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    ((out.disp * g_disp).sum() + (out.pan * g_pan).sum() + out.maskL.sum()).backward()
    torch.cuda.synchronize()
    assert (MedForward.launches - k1, MedForward.bwd_launches - k2) == (1, 1)
    want = med_vjp(logits, image, 2.0, 300.0, g_disp, g_pan)
    torch.testing.assert_close(lg.grad, want[0], **GRAD_TOL)
    torch.testing.assert_close(im.grad, want[1], **GRAD_TOL)


@pytest.mark.cuda
def test_script_ops_match_plain_on_gpu(cuda_device):
    """conv3x3 (K3, K4) and roll_window (K5) through the ops: the plain
    versions' values, one count each."""
    from fal_net_torch.utils.timing import tf32

    rng = np.random.default_rng(0)
    x = _draw(rng, 2, 16, 12, 64).to(cuda_device)
    w2 = conv3x3.repack_weights(_draw(rng, 32, 16, 3, 3).to(cuda_device) * 0.05)
    _build.load_library()
    counts = dict(conv3x3.LAUNCHES), dict(roll_probe.LAUNCHES)
    with tf32(False):
        got = conv3x3.conv3x3_packed(x, w2)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, conv3x3.conv3x3_tf32_plain(x, w2), rtol=1e-5, atol=1e-4)
    row = _draw(rng, 1, 1, 8, 128)[0, 0].to(cuda_device)
    f = torch.tensor([17], dtype=torch.int32, device=cuda_device)
    assert torch.equal(roll_probe.roll_window(row, f, 640), roll_probe.roll_window_plain(row, f, 640))
    assert (conv3x3.LAUNCHES["conv3x3"] - counts[0]["conv3x3"],
            roll_probe.LAUNCHES["roll_window"] - counts[1]["roll_window"]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_remat_launches_on_gpu(cuda_device, tmp_path, stage):
    """One Trainer step of the tiny model on the card, with and without
    remat (train/trainer.py::Remat): K1 twice a student forward (the forward
    and its recompute) plus the teacher's once in stage 2, K2 once; the
    setup gate's launches are not in these counts."""
    from fal_net_torch.models import create_model
    from fal_net_torch.models.checkpoint import save_checkpoint
    from fal_net_torch.parallel.dryrun import SyntheticStereo
    from fal_net_torch.train import Stage1Config, Stage2Config, Trainer

    teacher = str(tmp_path / "teacher.pt")
    save_checkpoint(teacher, create_model("tiny", 5, device="cpu", generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(0)
    batch = {k: (_draw(rng, 4, 3, 32, 64) * 0.3).to(cuda_device) for k in ("left", "right")}
    counts = {}
    for remat in (False, True):
        kw = dict(model="tiny", num_levels=5, crop_size=(32, 64), batch_size=4, a_p=0.0, workers=1, remat=remat)
        cfg = Stage2Config(fix_model=teacher, **kw) if stage == "stage2" else Stage1Config(**kw)
        trainer = Trainer(cfg, stage=stage, device=cuda_device, train_dataset=SyntheticStereo(4, 32, 64))
        trainer.setup()
        _build.reset_launch_counts()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        counts[remat] = (MedForward.launches, MedForward.bwd_launches)
    teacher_k1 = int(stage == "stage2")
    assert counts == {False: (1 + teacher_k1, 1), True: (2 + teacher_k1, 1)}

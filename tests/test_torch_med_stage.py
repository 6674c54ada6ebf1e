"""The MED head and its VJP at the sizes that pick each staging path of the
CUDA kernels K1 and K2 (csrc/med_stage.cuh): the whole row (N = 49,
W = 640), the ring (N = 49, W = 1280), the cp.async copies (W = 187, where
W * 4 is not a multiple of 16), W below the largest shift, and per-sample
negative bounds.

On the CPU the plain head and the plain VJP are held against the JAX head
and its jax.grad on the same seeded numpy inputs (H <= 4), and one small case
against the JAX package's Pallas backward in interpret mode.  On a card the
kernels are held against the plain versions at the same sizes, K1 in every
mode and K2 in every cotangent mode, and the staging plans are checked.
Tolerances are those of tests/test_med_pallas.py: 1e-4 on forward outputs;
rtol 1e-4, atol 1e-5 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.ops.med import med_outputs as jax_med_outputs
from fal_net_tpu.ops.med_pallas import med_outputs_fused as jax_med_outputs_fused
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_kernel import MedForward, med_outputs_fused, med_vjp_fused, stage_plan
from fal_net_torch.ops.med_vjp import med_vjp

TOL = {"disp": (1e-5, 1e-4), "pan": (1e-4, 1e-4), "maskL": (1e-4, 1e-4), "maskR": (1e-4, 1e-4)}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ALL = dict(ret_disp=True, ret_pan=True, ret_subocc=True)
# (B, N, H, W, C, min_disp, max_disp); a list is one bound per sample
PATHS = {
    "whole row": (1, 49, 2, 640, 3, 2.0, 300.0),
    "ring": (1, 49, 2, 1280, 3, 2.0, 300.0),
    "cp.async": (1, 9, 3, 187, 3, 2.0, 300.0),
    "W below the largest shift": (2, 7, 4, 48, 4, 2.0, 300.0),
    "per-sample negative bounds": (3, 9, 2, 96, 3, [2.0, -1.0, 1.0], [300.0, -30.0, 30.0]),
}
FWD_MODES = {
    "disp": dict(ret_disp=True),
    "pan": dict(ret_disp=False, ret_pan=True),
    "disp+pan": dict(ret_disp=True, ret_pan=True),
    "subocc": dict(ret_disp=False, ret_subocc=True),
    "disp+pan+subocc": ALL,
}
# (g_disp, g_pan, image_grad)
BWD_MODES = {
    "disp": (True, False, False),
    "pan": (False, True, False),
    "disp+pan": (True, True, False),
    "pan+g_img": (False, True, True),
    "disp+pan+g_img": (True, True, True),
}
# K1's outputs as stage_plan takes them
FWD_PLANS = [dict(disp=True), dict(disp=False, pan=True), dict(disp=True, pan=True), dict(disp=False, subocc=True),
             dict(disp=True, pan=True, subocc=True)]


def _inputs(rng, b, n, h, w, c):
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    return draw(b, n, h, w), draw(b, c, h, w)


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _bounds(mn, mx, as_tensor):
    """Numbers as they are; per-sample lists as float32 arrays of ``as_tensor``."""
    if isinstance(mn, list):
        return as_tensor(np.asarray(mn, np.float32)), as_tensor(np.asarray(mx, np.float32))
    return mn, mx


def _loss_cotangents(out):
    """d/d(disp, pan) of the JAX tests' loss sum(sin(pan)) + sum(cos(disp / 300))."""
    return -torch.sin(out.disp / 300.0) / 300.0, torch.cos(out.pan)


def _jax_loss(head, mn, mx):
    def loss(lg, im):
        out = head(lg, im, mn, mx)
        return jnp.sum(jnp.sin(out.pan)) + jnp.sum(jnp.cos(out.disp / 300.0))

    return loss


@pytest.mark.parametrize("path", list(PATHS))
def test_plain_head_matches_jax(rng, path):
    b, n, h, w, c, mn, mx = PATHS[path]
    logits, image = _inputs(rng, b, n, h, w, c)
    got = med_outputs(torch.from_numpy(logits), torch.from_numpy(image), *_bounds(mn, mx, torch.from_numpy), **ALL)
    want = jax_med_outputs(_nhwc(logits), _nhwc(image), *_bounds(mn, mx, jnp.asarray), **ALL)
    for name, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(
            getattr(got, name).numpy(), _nchw(getattr(want, name)), rtol=rtol, atol=atol, err_msg=name
        )


@pytest.mark.parametrize("path", list(PATHS))
def test_plain_vjp_matches_jax_grad(rng, path):
    """jax.grad of the JAX head; at W >= 640 of its Pallas kernel in interpret
    mode (fast at H = 2), whose shift tables are float64 like the port's: the
    plain JAX head's fp32 shifts move these gradients by up to 3.4e-5 there
    (ROADMAP queue 3, shift-table precision)."""
    b, n, h, w, c, mn, mx = PATHS[path]
    logits, image = _inputs(rng, b, n, h, w, c)
    t_mn, t_mx = _bounds(mn, mx, torch.from_numpy)
    lg, im = torch.from_numpy(logits), torch.from_numpy(image)
    g_disp, g_pan = _loss_cotangents(med_outputs(lg, im, t_mn, t_mx, ret_disp=True, ret_pan=True))
    gl, gi = med_vjp(lg, im, t_mn, t_mx, g_disp, g_pan)
    jax_head = jax_med_outputs_fused if w >= 640 else jax_med_outputs
    kw = dict(interpret=True) if w >= 640 else {}
    head = lambda lg_, im_, a, z: jax_head(lg_, im_, a, z, ret_disp=True, ret_pan=True, **kw)
    jl, ji = jax.grad(_jax_loss(head, *_bounds(mn, mx, jnp.asarray)), argnums=(0, 1))(_nhwc(logits), _nhwc(image))
    np.testing.assert_allclose(gl.numpy(), _nchw(jl), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gi.numpy(), _nchw(ji), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_plain_vjp_matches_jax_pallas_interpret(rng):
    """The JAX package's own backward kernel (Pallas, interpret mode) at the
    unaligned width of the cp.async path."""
    b, n, h, w, c, mn, mx = 1, 9, 8, 187, 3, 2.0, 300.0
    logits, image = _inputs(rng, b, n, h, w, c)
    lg, im = torch.from_numpy(logits), torch.from_numpy(image)
    gl, gi = med_vjp(lg, im, mn, mx, *_loss_cotangents(med_outputs(lg, im, mn, mx, ret_disp=True, ret_pan=True)))
    head = lambda lg_, im_, a, z: jax_med_outputs_fused(lg_, im_, a, z, ret_disp=True, ret_pan=True, interpret=True)
    jl, ji = jax.grad(_jax_loss(head, mn, mx), argnums=(0, 1))(_nhwc(logits), _nhwc(image))
    np.testing.assert_allclose(gl.numpy(), _nchw(jl), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gi.numpy(), _nchw(ji), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MED kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_inputs(path, dev):
    b, n, h, w, c, mn, mx = PATHS[path]
    rng = np.random.default_rng(0)
    draw = lambda ch: torch.from_numpy(rng.standard_normal((b, ch, h, w), np.float32)).to(dev)
    mn, mx = _bounds(mn, mx, lambda a: torch.from_numpy(a).to(dev))
    return draw(n), draw(c), draw(1), draw(c), mn, mx


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FWD_MODES))
@pytest.mark.parametrize("path", list(PATHS))
def test_k1_matches_plain_on_gpu(cuda_device, path, mode):
    logits, image, _, _, mn, mx = _cuda_inputs(path, cuda_device)
    launches = MedForward.launches
    got = med_outputs_fused(logits, image, mn, mx, **FWD_MODES[mode])
    torch.cuda.synchronize()
    assert MedForward.launches == launches + 1
    want = med_outputs(logits, image, mn, mx, **FWD_MODES[mode])
    for name, (rtol, atol) in TOL.items():
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("path", list(PATHS))
def test_k2_matches_plain_on_gpu(cuda_device, path, mode):
    logits, image, g_disp, g_pan, mn, mx = _cuda_inputs(path, cuda_device)
    want_d, want_p, image_grad = BWD_MODES[mode]
    gd, gp = (g_disp if want_d else None), (g_pan if want_p else None)
    launches = MedForward.bwd_launches
    got = med_vjp_fused(logits, image, mn, mx, gd, gp, image_grad=image_grad)
    torch.cuda.synchronize()
    assert MedForward.bwd_launches == launches + 1
    want = med_vjp(logits, image, mn, mx, gd, gp, image_grad=image_grad)
    torch.testing.assert_close(got[0], want[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        torch.testing.assert_close(got[1], want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_stage_plans_on_gpu(cuda_device):
    """The main path's plans, and three times the serving width planned in
    every mode."""
    train = stage_plan("med_bwd", 49, 3, 640, disp=True, pan=True)
    assert train["whole"] and train["group"] == 7 and train["slots"] == 7 and train["consumers"] == 640
    assert not train["direct"]
    assert stage_plan("med_fwd", 49, 3, 640, disp=True, pan=True)["whole"]
    for kernel in ("med_fwd", "med_bwd"):
        ring = stage_plan(kernel, 49, 3, 1280, disp=True, pan=True)
        assert not ring["whole"] and ring["cpt"] == 2 and ring["consumers"] == 640
    assert stage_plan("med_bwd", 49, 3, 1280, disp=True, pan=True)["sweeps"] == 2
    for n in (2, 49, 128):
        for c in (1, 3, 4):
            for flags in FWD_PLANS:
                p = stage_plan("med_fwd", n, c, 3840, **flags)
                assert p["smem"] <= 232_448 and p["slots"] >= 1
            for d, pn, img in BWD_MODES.values():
                p = stage_plan("med_bwd", n, c, 3840, disp=d, pan=pn, image_grad=img)
                assert p["smem"] <= 232_448 and p["slots"] >= 1
    with pytest.raises(ValueError, match="no plan"):  # a shift margin past a chunk's 1,280 columns
        stage_plan("med_bwd", 49, 3, 100_000, disp=True, pan=True, max_disp=3000.0)
    # K1's staged plans at the training and serving widths (bytes and labels
    # unchanged by the direct path)
    keys = ("group", "slots", "whole", "loads", "smem", "direct")
    for w, flags, want in (
        (640, dict(disp=True), (7, 7, 1, 7, 130_816, 0)),
        (640, dict(disp=True, pan=True), (7, 7, 1, 7, 141_088, 0)),
        (640, dict(disp=True, pan=True, subocc=True), (7, 7, 1, 7, 146_208, 0)),
        (1280, dict(disp=True), (7, 6, 0, 7, 222_736, 0)),
        (1280, dict(disp=True, pan=True), (7, 5, 0, 7, 207_168, 0)),
        (1280, dict(disp=True, pan=True, subocc=True), (7, 5, 0, 14, 217_408, 0)),
    ):
        p = stage_plan("med_fwd", 49, 3, w, **flags)
        assert tuple(p[k] for k in keys) == want, (w, flags, p)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_stage_on_gpu(cuda_device):
    """What no plan fits raises from the C entry and launches nothing: on
    the direct path, only a shift margin wider than a chunk (disparities of
    3,000 px here), and the error names the margin, not W."""
    logits = torch.zeros(1, 49, 1, 100_000, device=cuda_device)
    image = torch.zeros(1, 3, 1, 100_000, device=cuda_device)
    k1, k2 = MedForward.launches, MedForward.bwd_launches
    with pytest.raises(ValueError, match="margin of 3004 columns.*limits"):
        med_outputs_fused(logits, image, 2.0, 3000.0, ret_disp=True, ret_pan=True)
    with pytest.raises(ValueError, match="margin of 3004 columns.*limits"):
        med_vjp_fused(logits, image, 2.0, 3000.0, torch.zeros_like(logits[:, :1]), torch.zeros_like(image))
    assert (MedForward.launches, MedForward.bwd_launches) == (k1, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [32_768, 65_536])
@pytest.mark.parametrize("mode", list(FWD_MODES))
def test_k1_direct_path_wide_on_gpu(cuda_device, w, mode):
    """K1 on the direct path (chunk windows with the shift margin in the
    slots) at widths past every staged plan: each mode matches the plain head."""
    rng = np.random.default_rng(w)
    draw = lambda ch: torch.from_numpy(rng.standard_normal((1, ch, 2, w), np.float32)).to(cuda_device)
    logits, image = draw(49), draw(3)
    kw = FWD_MODES[mode]
    plan = stage_plan("med_fwd", 49, 3, w, disp=kw.get("ret_disp", False), pan=kw.get("ret_pan", False),
                      subocc=kw.get("ret_subocc", False))
    assert plan["direct"] and plan["chunks"] == -(-w // 1280)
    assert plan["margin"] == (304 if kw.get("ret_pan") or kw.get("ret_subocc") else 0)
    got = med_outputs_fused(logits, image, 2.0, 300.0, **kw)
    torch.cuda.synchronize()
    want = med_outputs(logits, image, 2.0, 300.0, **kw)
    for name, (rtol, atol) in TOL.items():
        g, ww = getattr(got, name), getattr(want, name)
        assert (g is None) == (ww is None), name
        if g is not None:
            torch.testing.assert_close(g, ww, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [32_768, 65_536])
@pytest.mark.parametrize("mode", list(BWD_MODES))
def test_k2_direct_path_wide_on_gpu(cuda_device, w, mode):
    """K2 on the direct path at widths past every staged plan, each
    cotangent mode against the plain VJP."""
    rng = np.random.default_rng(w + 1)
    draw = lambda ch: torch.from_numpy(rng.standard_normal((1, ch, 2, w), np.float32)).to(cuda_device)
    logits, image, g_disp, g_pan = draw(49), draw(3), draw(1), draw(3)
    want_d, want_p, image_grad = BWD_MODES[mode]
    assert stage_plan("med_bwd", 49, 3, w, disp=want_d, pan=want_p, image_grad=image_grad)["direct"]
    gd, gp = (g_disp if want_d else None), (g_pan if want_p else None)
    got = med_vjp_fused(logits, image, 2.0, 300.0, gd, gp, image_grad=image_grad)
    torch.cuda.synchronize()
    want = med_vjp(logits, image, 2.0, 300.0, gd, gp, image_grad=image_grad)
    torch.testing.assert_close(got[0], want[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        torch.testing.assert_close(got[1], want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_direct_path_per_sample_bounds_on_gpu(cuda_device):
    """Per-sample bound tensors on the direct path: the margin comes from
    their largest magnitude (here a negative one), and both kernels match
    the plain versions."""
    w = 20_000
    rng = np.random.default_rng(3)
    draw = lambda ch: torch.from_numpy(rng.standard_normal((2, ch, 2, w), np.float32)).to(cuda_device)
    logits, image, g_disp, g_pan = draw(49), draw(3), draw(1), draw(3)
    mn = torch.tensor([2.0, -1.0], device=cuda_device)
    mx = torch.tensor([300.0, -420.0], device=cuda_device)
    got = med_outputs_fused(logits, image, mn, mx, **ALL)
    torch.cuda.synchronize()
    want = med_outputs(logits, image, mn, mx, **ALL)
    for name, (rtol, atol) in TOL.items():
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=rtol, atol=atol)
    got = med_vjp_fused(logits, image, mn, mx, g_disp, g_pan, image_grad=True)
    torch.cuda.synchronize()
    want = med_vjp(logits, image, mn, mx, g_disp, g_pan, image_grad=True)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BWD_MODES))
def test_k2_direct_path_at_w5000_on_gpu(cuda_device, mode):
    """Rows too wide to stage the image and g_pan rows beside the ring (pan
    cotangents at N = 49 past W = 4,449, 4,131 with g_img): K2 reads them
    from device memory and still matches the plain VJP."""
    rng = np.random.default_rng(0)
    draw = lambda ch: torch.from_numpy(rng.standard_normal((1, ch, 4, 5000), np.float32)).to(cuda_device)
    logits, image, g_disp, g_pan = draw(49), draw(3), draw(1), draw(3)
    want_d, want_p, image_grad = BWD_MODES[mode]
    plan = stage_plan("med_bwd", 49, 3, 5000, disp=want_d, pan=want_p, image_grad=image_grad)
    assert not plan["whole"] and plan["direct"] == want_p
    gd, gp = (g_disp if want_d else None), (g_pan if want_p else None)
    got = med_vjp_fused(logits, image, 2.0, 300.0, gd, gp, image_grad=image_grad)
    torch.cuda.synchronize()
    want = med_vjp(logits, image, 2.0, 300.0, gd, gp, image_grad=image_grad)
    torch.testing.assert_close(got[0], want[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        torch.testing.assert_close(got[1], want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FWD_MODES))
def test_k1_at_k2_pan_width_on_gpu(cuda_device, mode):
    """K1 takes every width K2 trains at: at N = 49, W = 11,572 (K2's widest
    with pan cotangents), pan modes read the image row from device memory
    (the direct path) and every mode matches the plain head."""
    w = 11_572
    rng = np.random.default_rng(0)
    draw = lambda ch: torch.from_numpy(rng.standard_normal((1, ch, 2, w), np.float32)).to(cuda_device)
    logits, image = draw(49), draw(3)
    kw = FWD_MODES[mode]
    plan = stage_plan("med_fwd", 49, 3, w, disp=kw.get("ret_disp", False), pan=kw.get("ret_pan", False),
                      subocc=kw.get("ret_subocc", False))
    assert plan["direct"] == kw.get("ret_pan", False)
    got = med_outputs_fused(logits, image, 2.0, 300.0, **kw)
    torch.cuda.synchronize()
    want = med_outputs(logits, image, 2.0, 300.0, **kw)
    for name, (rtol, atol) in TOL.items():
        g, ww = getattr(got, name), getattr(want, name)
        assert (g is None) == (ww is None), name
        if g is not None:
            torch.testing.assert_close(g, ww, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_maskr_quirk_runs_k1_on_gpu(cuda_device):
    """FalNet(a_maskr_quirk=True) on the card: K1 gives disp, pan and maskL
    (one disp+pan+subocc launch) and the plain quirk sampler gives maskR;
    all four equal the plain head with the quirk on the same logits."""
    from fal_net_torch.models import create_model

    model = create_model("tiny", 9, device=cuda_device, generator=torch.Generator().manual_seed(0),
                         a_maskr_quirk=True).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 32, 64), np.float32)).to(cuda_device)
    with torch.no_grad():
        logits = model.logits(x, 30.0).contiguous()
        model.logits = lambda left, max_disp: logits  # one set of logits for both heads
        before = MedForward.mode_launches.get("disp+pan+subocc", 0)
        got = model(x, 2.0, 30.0, **ALL)
        torch.cuda.synchronize()
        want = med_outputs(logits, x, 2.0, 30.0, maskr_quirk=True, **ALL)
    assert MedForward.mode_launches.get("disp+pan+subocc", 0) == before + 1
    for name, (rtol, atol) in TOL.items():
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=rtol, atol=atol)

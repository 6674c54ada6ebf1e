"""The plain MED VJP (fal_net_torch.ops.med_vjp, the plain version of K2)
against torch autograd of the plain head and against jax.grad of the JAX
head, on the same seeded numpy inputs.

Shapes and bounds are those of tests/test_med_pallas.py's gradient tests;
tolerances are theirs too: rtol 1e-4, atol 1e-5.
"""

from torch_lane import nchw
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.ops.med import med_outputs as jax_med_outputs
from fal_net_tpu.ops.med_pallas import med_outputs_fused as jax_med_outputs_fused
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_vjp import med_vjp

RTOL, ATOL = 1e-4, 1e-5
GRAD_CASES = [(7, 2.0, 60.0), (33, 2.0, 18.0), (49, 2.0, 300.0)]  # test_med_pallas.py:102-110


def _data(rng, b, n, h, w, c=3):
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    return draw(b, n, h, w), draw(b, c, h, w)


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _torch_loss_grads(logits, image, mn, mx, disp_term=True, pan_term=True):
    """Autograd of the plain head under the JAX tests' loss
    sum(sin(pan)) + sum(cos(disp / 300))."""
    lg = torch.from_numpy(logits).requires_grad_()
    im = torch.from_numpy(image).requires_grad_()
    o = med_outputs(lg, im, mn, mx, ret_disp=True, ret_pan=True)
    loss = 0.0
    if pan_term:
        loss = loss + torch.sin(o.pan).sum()
    if disp_term:
        loss = loss + torch.cos(o.disp / 300.0).sum()
    gl, gi = torch.autograd.grad(loss, (lg, im), allow_unused=True)
    return o, gl, gi


def _cotangents(o, disp_term=True, pan_term=True):
    """d loss / d disp and d loss / d pan of that loss."""
    g_disp = -torch.sin(o.disp.detach() / 300.0) / 300.0 if disp_term else None
    g_pan = torch.cos(o.pan.detach()) if pan_term else None
    return g_disp, g_pan


@pytest.mark.parametrize("n,min_disp,max_disp", GRAD_CASES)
def test_med_vjp_matches_autograd_and_jax_grad(rng, n, min_disp, max_disp):
    logits, image = _data(rng, 2, n, 8, 128)
    o, gl_auto, gi_auto = _torch_loss_grads(logits, image, min_disp, max_disp)
    g_disp, g_pan = _cotangents(o)
    gl, gi = med_vjp(
        torch.from_numpy(logits), torch.from_numpy(image), min_disp, max_disp, g_disp, g_pan
    )
    np.testing.assert_allclose(gl.numpy(), gl_auto.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gi.numpy(), gi_auto.numpy(), rtol=RTOL, atol=ATOL)

    def jax_loss(lg, im):
        out = jax_med_outputs(lg, im, min_disp, max_disp, ret_disp=True, ret_pan=True)
        return jnp.sum(jnp.sin(out.pan)) + jnp.sum(jnp.cos(out.disp / 300.0))

    jl, ji = jax.grad(jax_loss, argnums=(0, 1))(_nhwc(logits), _nhwc(image))
    np.testing.assert_allclose(gl.numpy(), nchw(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gi.numpy(), nchw(ji), rtol=RTOL, atol=ATOL)


def test_med_vjp_matches_jax_fused_interpret(rng):
    """The JAX package's own K2 (its Pallas backward in interpret mode)."""
    n, min_disp, max_disp = 7, 2.0, 60.0
    logits, image = _data(rng, 1, n, 8, 128)
    o, _, _ = _torch_loss_grads(logits, image, min_disp, max_disp)
    gl, gi = med_vjp(
        torch.from_numpy(logits), torch.from_numpy(image), min_disp, max_disp, *_cotangents(o)
    )

    def jax_loss(lg, im):
        out = jax_med_outputs_fused(
            lg, im, min_disp, max_disp, ret_disp=True, ret_pan=True, interpret=True
        )
        return jnp.sum(jnp.sin(out.pan)) + jnp.sum(jnp.cos(out.disp / 300.0))

    jl, ji = jax.grad(jax_loss, argnums=(0, 1))(_nhwc(logits), _nhwc(image))
    np.testing.assert_allclose(gl.numpy(), nchw(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gi.numpy(), nchw(ji), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("disp_term,pan_term", [(True, False), (False, True)])
def test_med_vjp_single_cotangent(rng, disp_term, pan_term):
    """A disp-only or pan-only cotangent, as K2's want_disp / want_pan modes;
    without a pan cotangent there is no image gradient."""
    logits, image = _data(rng, 2, 9, 8, 96)
    o, gl_auto, gi_auto = _torch_loss_grads(logits, image, 2.0, 300.0, disp_term, pan_term)
    gl, gi = med_vjp(
        torch.from_numpy(logits), torch.from_numpy(image), 2.0, 300.0,
        *_cotangents(o, disp_term, pan_term),
    )
    np.testing.assert_allclose(gl.numpy(), gl_auto.numpy(), rtol=RTOL, atol=ATOL)
    if pan_term:
        np.testing.assert_allclose(gi.numpy(), gi_auto.numpy(), rtol=RTOL, atol=ATOL)
    else:
        assert gi is None and gi_auto is None
    _, gi_off = med_vjp(
        torch.from_numpy(logits), torch.from_numpy(image), 2.0, 300.0,
        *_cotangents(o, disp_term, pan_term), image_grad=False,
    )
    assert gi_off is None


def test_med_vjp_per_sample_bounds(rng):
    """(B,) bounds, negated ones included (swapped samples), against autograd
    and jax.grad of the per-sample heads."""
    logits, image = _data(rng, 3, 9, 8, 96)
    mn_np = np.asarray([2.0, -1.0, 1.0], np.float32)
    mx_np = np.asarray([300.0, -30.0, 30.0], np.float32)
    mn, mx = torch.from_numpy(mn_np), torch.from_numpy(mx_np)
    o, gl_auto, gi_auto = _torch_loss_grads(logits, image, mn, mx)
    gl, gi = med_vjp(torch.from_numpy(logits), torch.from_numpy(image), mn, mx, *_cotangents(o))
    np.testing.assert_allclose(gl.numpy(), gl_auto.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gi.numpy(), gi_auto.numpy(), rtol=RTOL, atol=ATOL)

    def jax_loss(lg, im):
        out = jax_med_outputs(lg, im, jnp.asarray(mn_np), jnp.asarray(mx_np), ret_disp=True, ret_pan=True)
        return jnp.sum(jnp.sin(out.pan)) + jnp.sum(jnp.cos(out.disp / 300.0))

    jl, ji = jax.grad(jax_loss, argnums=(0, 1))(_nhwc(logits), _nhwc(image))
    np.testing.assert_allclose(gl.numpy(), nchw(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gi.numpy(), nchw(ji), rtol=RTOL, atol=ATOL)


def test_masks_carry_no_gradient(rng):
    """maskL and maskR are stop-gradient in the plain head, as in JAX
    (test_med_pallas.py:131-143): a loss on the masks alone gives zero."""
    logits, image = _data(rng, 1, 5, 8, 128)
    lg = torch.from_numpy(logits).requires_grad_()
    o = med_outputs(lg, torch.from_numpy(image), 2.0, 60.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    assert not o.maskL.requires_grad and not o.maskR.requires_grad
    (g,) = torch.autograd.grad(o.maskL.sum() + o.maskR.sum() + 0 * o.disp.sum(), lg)
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-7)

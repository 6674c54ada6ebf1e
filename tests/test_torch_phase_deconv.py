"""``phase_deconv`` in the port against the JAX package: the op
(ops/phase_deconv.py) against the plain upsample and conv and against JAX's
``conv3x3_on_up2`` with its gradients against ``jax.grad``, ``Deconv`` at a
2x and at a non-2x size, JAX's default FAL-net (``create_model`` with
``phase_deconv=True`` and its other default rewrites) against the port with
``phase_deconv=True`` on carried weights, and the stage-1 gradients.

Tolerances: the composed kernel exactly (the same sums in the same order);
the op at fp32 rounding (rtol 1e-5, atol 1e-5 on O(1) values; gradients
within 1e-5 of their largest magnitude); the models at
tests/test_torch_models.py's (logits rtol/atol 1e-3, disp and pan rtol 1e-3,
atol 5e-3); the stage-1 loss at rtol 1e-5 and each gradient within 1e-4 of
its largest magnitude (tests/test_torch_stages.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_tpu.ops import phase_deconv as jax_phase
from fal_net_tpu.train.stages import stage1_loss as jax_stage1_loss
from fal_net_torch.models import create_model
from fal_net_torch.models import layers
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.ops.phase_deconv import composed_kernel, conv3x3_on_up2
from fal_net_torch.train.stages import stage1_loss

N = 9
OIHW_TO_HWIO = (2, 3, 1, 0)


def _draw(rng, b=2, cin=6, cout=5, h=7, w=11):
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    w3 = (rng.standard_normal((cout, cin, 3, 3)) * 0.3).astype(np.float32)
    return x, w3


def _plain(x, w3):
    return F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w3, padding=1)


def test_composed_kernel_matches_jax(rng):
    _, w3 = _draw(rng)
    got = composed_kernel(torch.from_numpy(w3)).numpy()
    want = np.asarray(jax_phase.composed_kernel(jnp.asarray(w3.transpose(OIHW_TO_HWIO))))
    assert got.shape == (5, 6, 4, 4)
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
    w64 = torch.from_numpy(w3).double()
    assert composed_kernel(w64).dtype == torch.float64


@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 11), (1, 3, 8, 1, 1), (3, 8, 4, 6, 20)])
def test_op_matches_plain_and_jax(rng, shape):
    b, cin, cout, h, w = shape
    x, w3 = _draw(rng, b, cin, cout, h, w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w3)
    got = conv3x3_on_up2(tx, tw)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    torch.testing.assert_close(got, _plain(tx, tw), rtol=1e-5, atol=1e-5)
    # float64: the same function, to the last digits
    torch.testing.assert_close(conv3x3_on_up2(tx.double(), tw.double()), _plain(tx.double(), tw.double()),
                               rtol=1e-12, atol=1e-12)
    want = jax_phase.conv3x3_on_up2(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w3.transpose(OIHW_TO_HWIO)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)


def test_op_gradients_match_jax(rng):
    x, w3 = _draw(rng)
    g = rng.standard_normal((2, 5, 14, 22)).astype(np.float32)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w3).requires_grad_()
    (conv3x3_on_up2(tx, tw) * torch.from_numpy(g)).sum().backward()
    jx, jw = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w3.transpose(OIHW_TO_HWIO))
    gx, gw = jax.grad(lambda a, k: (jax_phase.conv3x3_on_up2(a, k) * jnp.asarray(g.transpose(0, 2, 3, 1))).sum(),
                      argnums=(0, 1))(jx, jw)
    for got, want in ((tx.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2)),
                      (tw.grad.numpy(), np.asarray(gw).transpose(3, 2, 0, 1))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # and the plain path's gradients
    px, pw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w3).requires_grad_()
    (_plain(px, pw) * torch.from_numpy(g)).sum().backward()
    torch.testing.assert_close(tx.grad, px.grad, rtol=0, atol=1e-5 * float(px.grad.abs().max()))
    torch.testing.assert_close(tw.grad, pw.grad, rtol=0, atol=1e-5 * float(pw.grad.abs().max()))


@pytest.mark.parametrize("size,skip", [((6, 10), (12, 20)), ((12, 39), (24, 78)), ((6, 20), (12, 39)),
                                       ((188, 621), (375, 1242))])
def test_deconv_phase_only_at_2x(rng, monkeypatch, size, skip):
    """Deconv(phase=True) takes the transposed conv where the skip is
    exactly 2x (within fp32 rounding of the plain path) and falls back to
    the plain path, bit for bit, elsewhere: the decoder at 375x1242 has
    both (its 12x39 -> 24x78 deconv is exact, its 6x20 -> 12x39 is not)."""
    plain = layers.Deconv(4, 3)
    phase = layers.Deconv(4, 3, phase=True)
    phase.load_state_dict(plain.state_dict())
    assert list(phase.state_dict()) == ["conv1.weight"]
    calls = []
    monkeypatch.setattr(layers, "conv3x3_on_up2", lambda x, w: calls.append(1) or conv3x3_on_up2(x, w))
    x = torch.from_numpy(rng.standard_normal((1, 4, *size)).astype(np.float32))
    with torch.no_grad():
        got, want = phase(x, skip), plain(x, skip)
    assert got.shape == want.shape == (1, 3, *skip)
    exact = skip == (2 * size[0], 2 * size[1])
    assert calls == ([1] if exact else [])
    torch.testing.assert_close(got, want, rtol=1e-5 if exact else 0, atol=1e-5 if exact else 0)


def _jax_default(variant):
    """JAX's default model: phase_deconv and the other default rewrites on,
    the MED head through its Pallas kernel in interpret mode."""
    return jax_create_model(variant, N, med_impl="fused", med_interpret=True)


@pytest.mark.parametrize("variant,h,w", [("tiny", 32, 64), ("tiny", 47, 78), ("B", 64, 128), ("B", 47, 78)])
def test_default_model_matches_jax(rng, variant, h, w):
    """47x78 mixes both paths (two of its six deconvs are exactly 2x in
    both axes), as 375x1242 does (one of six: 12x39 -> 24x78)."""
    jax_model = _jax_default(variant)
    assert jax_model.phase_deconv
    x = (rng.standard_normal((2, h, w, 3)) * 0.3).astype(np.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), 2.0, 300.0, ret_disp=True)
    want, inter = jax_model.apply(variables, jnp.asarray(x), 2.0, 300.0, ret_disp=True, ret_pan=True,
                                  capture_intermediates=True, mutable=["intermediates"])
    want_logits = np.asarray(inter["intermediates"]["backbone"]["__call__"][0])  # fuse_logits: the logits

    port = create_model(variant, N, device="cpu", phase_deconv=True)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], variant).items()})
    left = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        logits = port.logits(left, 300.0)
        got = port(left, 2.0, 300.0, ret_disp=True, ret_pan=True)
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(logits.numpy(), to_nchw(want_logits), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.disp.numpy(), to_nchw(want.disp), rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(got.pan.numpy(), to_nchw(want.pan), rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("per_sample", [False, True])
def test_stage1_grads_match_jax(rng, per_sample):
    """The stage-1 loss and every parameter gradient of the tiny model with
    phase_deconv on both sides (JAX's default model, plain MED head)."""
    b, h, w = 2, 32, 64
    jax_model = jax_create_model("tiny", 5, med_impl="reference")
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), 2.0, 30.0, ret_disp=True)
    left, right = ((rng.standard_normal((b, h, w, 3)) * 0.3).astype(np.float32) for _ in range(2))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    jb, tb = {"left": jnp.asarray(left), "right": jnp.asarray(right)}, {"left": nchw(left), "right": nchw(right)}
    if per_sample:
        mx = np.asarray([30.0, -20.0], np.float32)
        jb["max_disp"], tb["max_disp"] = jnp.asarray(mx), torch.from_numpy(mx)
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=0.2 * 2 / 512 * 50)
    (want, _), jax_grads = jax.value_and_grad(lambda p: jax_stage1_loss(p, jb, jax_model.apply, **kw),
                                              has_aux=True)(variables)
    port = create_model("tiny", 5, med_impl="reference", device="cpu", phase_deconv=True)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], "tiny").items()})
    loss, _ = stage1_loss(port, tb, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = convert_state_dict({k: p.grad.numpy() for k, p in port.named_parameters()}, JAX_VARIANTS["tiny"])

    def close(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=jax.tree_util.keystr(path))

    assert jax.tree.structure(grads) == jax.tree.structure(jax_grads["params"])
    jax.tree_util.tree_map_with_path(close, grads, jax_grads["params"])


def test_phase_deconv_is_recorded(tmp_path):
    """A checkpoint and an artifact record the model's phase_deconv, and
    load_checkpoint rebuilds it."""
    from fal_net_torch import serve
    from fal_net_torch.models.checkpoint import load_checkpoint, save_checkpoint

    model = create_model("tiny", 5, device="cpu", phase_deconv=True, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pt")
    save_checkpoint(path, model)
    assert load_checkpoint(path, device="cpu").phase_deconv
    save_checkpoint(str(tmp_path / "plain.pt"), create_model("tiny", 5, device="cpu"))
    assert not load_checkpoint(str(tmp_path / "plain.pt"), device="cpu").phase_deconv
    assert load_checkpoint(path, device="cpu", dtype="bfloat16").phase_deconv
    art = str(tmp_path / "a.pt2z")
    serve.save_exported(art, serve.export_forward(model, batch=1, height=32, width=64, device="cpu"))
    fwd = serve.load_exported(art, device="cpu")
    assert fwd.meta["phase_deconv"] is True
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 64, 3)).astype(np.float32))
    with torch.no_grad():
        (got,) = fwd(x)
        want = model(x.permute(0, 3, 1, 2), 2.0, 300.0).disp.permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # the exported graph's conv, fp32 rounding apart

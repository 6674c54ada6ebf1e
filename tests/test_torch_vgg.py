"""The VGG19 perceptual term in the port vs the JAX package: the feature
slices on carried random weights, the torchvision-layout importer on both
sides from one file, and the three stages' losses with a_p = 0.01 and their
parameter gradients against jax.value_and_grad.

VGG weights are random (no pretrained ones are in the repository): JAX's
``init_vgg19`` makes them and ``models/jax_import.py`` carries them.
Tolerances: features at rtol 1e-5 and atol 1e-5 of the slice's largest
magnitude; losses at rtol 1e-5 and each parameter gradient within 1e-4 of
that tensor's largest magnitude, as tests/test_torch_stages.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.losses import vgg as jax_vgg
from fal_net_tpu.train import stages as jax_stages
from fal_net_torch.losses import vgg
from fal_net_torch.models.jax_import import vgg_state_dict_from_jax
from fal_net_torch.train import stages
from test_torch_stages import A_SM, B, H, W, _batches, _check, _port_model, tiny  # noqa: F401

A_P = 0.01
# every conv of torchvision's vgg19().features, so that a file holds layers the slices skip
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def _port_vgg(params, full=False):
    model = vgg.Vgg19Features(full=full)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in vgg_state_dict_from_jax(params).items()})
    return model


@pytest.fixture(scope="module")
def jax_vgg19():
    model, params = jax_vgg.init_vgg19(full=True, seed=3)
    return model, params


def _assert_features(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("full", [False, True])
def test_features_match_jax(jax_vgg19, rng, full):
    jmodel, params = jax_vgg19
    x = (rng.standard_normal((2, H, W, 3)) * 0.5).astype(np.float32)
    jm = jax_vgg.Vgg19Features(full=full)
    sub = {"params": {k: v for k, v in params["params"].items() if full or int(k[4:]) < 19}}
    want = jm.apply(sub, jnp.asarray(x))
    port = _port_vgg(sub, full=full)
    assert not any(p.requires_grad for p in port.parameters()) and not port.train().training
    got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
    _assert_features(got, want)
    assert [t.shape[1] for t in got] == [64, 128, 256, 512][: 4 if full else 3]


def _torchvision_state_dict(rng, prefix):
    sd, cin = {}, 3
    for idx in TORCHVISION_CONVS:
        cout = 64 if idx < 5 else 128 if idx < 10 else 256 if idx < 19 else 512
        sd[f"{prefix}{idx}.weight"] = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.05).astype(np.float32))
        sd[f"{prefix}{idx}.bias"] = torch.from_numpy((rng.standard_normal(cout) * 0.01).astype(np.float32))
        cin = cout
    sd[f"{prefix}0.weight_extra"] = torch.zeros(1)  # keys the importer ignores
    return sd


@pytest.mark.parametrize("layout", ["features.", "", "module"])
def test_torchvision_file_loads_alike_on_both_sides(tmp_path, rng, layout):
    """One .pth in torchvision's layout (vgg19().state_dict(), its
    .features.state_dict(), or a pickled module): both packages' loaders
    give the same features."""
    path = str(tmp_path / "vgg19.pth")
    if layout == "module":
        module = vgg.Vgg19Features(full=True)
        module.load_state_dict({k: v for k, v in _torchvision_state_dict(rng, "features.").items()
                                if int(k.split(".")[1]) <= 25 and "extra" not in k})
        torch.save(module, path)
    else:
        torch.save(_torchvision_state_dict(rng, layout), path)
    for full in (False, True):
        jm, jparams = jax_vgg.load_torch_vgg19(path, full=full)
        port = vgg.load_torch_vgg19(path, full=full)
        x = (rng.standard_normal((1, H, W, 3)) * 0.5).astype(np.float32)
        _assert_features(port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous()), jm.apply(jparams, jnp.asarray(x)))
    with pytest.raises(KeyError, match="index 0"):
        vgg.convert_torch_vgg19({})


def test_build_vgg_needs_weights_or_opt_in(tmp_path):
    assert vgg.build_vgg(None, False, 0.0, 0, "cpu") is None
    with pytest.raises(ValueError, match="--vgg_weights"):
        vgg.build_vgg(None, False, A_P, 0, "cpu")
    a, b = vgg.build_vgg(None, True, A_P, 5, "cpu"), vgg.init_vgg19(seed=5)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    path = str(tmp_path / "w.pth")
    torch.save(a.state_dict(), path)
    c = vgg.build_vgg(path, False, A_P, 0, "cpu")
    assert all(torch.equal(v, c.state_dict()[k]) for k, v in a.state_dict().items())


def _vgg_pair(jax_vgg19):
    jmodel, params = jax_vgg19
    sub = {"params": {k: v for k, v in params["params"].items() if int(k[4:]) < 19}}
    jm = jax_vgg.Vgg19Features()
    return (lambda im: jm.apply(sub, im)), _port_vgg(sub)


@pytest.mark.parametrize("stage", ["stage1", "stage1_slow"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_stage1_losses_with_perceptual_term_match_jax(tiny, jax_vgg19, rng, stage, per_sample):  # noqa: F811
    jax_model, variables, _ = tiny
    jb, tb = _batches(rng, per_sample)
    jfn, port_vgg = _vgg_pair(jax_vgg19)
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=A_P, a_sm=A_SM * 50)
    jloss = getattr(jax_stages, f"{stage}_loss")
    (want, want_aux), jax_grads = jax.value_and_grad(
        lambda p: jloss(p, jb, jax_model.apply, vgg_fn=jfn, **kw), has_aux=True
    )(variables)
    port = _port_model(variables)
    loss, aux = getattr(stages, f"{stage}_loss")(port, tb, vgg_fn=port_vgg, **kw)
    # the perceptual term is there: the same loss without it is smaller
    no_p, _ = getattr(stages, f"{stage}_loss")(_port_model(variables), tb, **{**kw, "a_p": 0.0})
    assert loss.item() > no_p.item()
    _check(port, loss, aux, want, want_aux, jax_grads)


@pytest.mark.parametrize("a_mr", [0.0, 1.0])
def test_stage2_loss_with_perceptual_term_matches_jax(tiny, jax_vgg19, rng, a_mr):  # noqa: F811
    """The occlusion-masked composite goes to VGG in both packages; the
    label features carry no gradient."""
    jax_model, variables, teacher_vars = tiny
    jb, tb = _batches(rng, True)
    jfn, port_vgg = _vgg_pair(jax_vgg19)
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=A_P, a_sm=A_SM * 50, a_mr=a_mr)
    (want, want_aux), jax_grads = jax.value_and_grad(
        lambda p: jax_stages.stage2_loss(p, jb, jax_model.apply, jax_model.apply, teacher_vars, vgg_fn=jfn, **kw),
        has_aux=True,
    )(variables)
    port, teacher = _port_model(variables), _port_model(teacher_vars)
    teacher.requires_grad_(False)
    labels = []
    fn = lambda im: labels.append(im.requires_grad) or port_vgg(im)
    loss, aux = stages.stage2_loss(port, tb, teacher, vgg_fn=fn, **kw)
    assert labels == [False, False, True, True]  # right and left labels, then the two composites
    _check(port, loss, aux, want, want_aux, jax_grads)
    assert all(p.grad is None for p in port_vgg.parameters())

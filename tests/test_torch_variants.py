"""FAL_netA and FAL_netC in the port against the JAX package, and on a card
against the plain versions of their kernels.

On the CPU, on weights carried by ``models/jax_import.py::state_dict_from_jax``:
- A and C at their default N = 33 (64x128, B = 2): logits and the
  disp+pan+subocc forward against the JAX model in plain form with
  ``med_impl="reference"``, and A with ``a_maskr_quirk`` on both sides, at
  the tolerances of tests/test_torch_models.py (logits rtol/atol 1e-3; the
  outputs rtol 1e-3, atol 5e-3: fp32 conv summation order, XLA vs oneDNN);
- A and C at N = 9 (64x128, B = 2): the stage-1 loss at rtol 1e-5 and every
  parameter gradient within 1e-4 of that tensor's largest magnitude against
  ``jax.value_and_grad`` of ``fal_net_tpu.train.stages.stage1_loss``, as
  tests/test_torch_train.py holds the tiny model;
- ``scripts/jax_init.py``: the initial weights JAX's model draws from a
  PRNGKey, drawn without JAX, against JAX's own init (A, C, and tiny at another
  key), within a few ulps;
- ``scripts/verify_variants.py``: ``check_training`` for 2 steps and
  ``check_variant`` untimed, small; it and ``scripts/med_times.py`` (both
  of its modes) raise without a card.

On a card (``cuda`` marker), per variant at N = 33 and (2, 3, 64, 128): the
forward's K1 against the plain head on the model's own logits in every mode
(the TPU kernel tests' tolerances), K2 against the plain VJP on those
logits with the stage-1 loss's cotangents (rtol 1e-4, atol 1e-5) and the
parameter gradients through K1 and K2 against those through the plain head
(TF32 off; 1e-4 of each tensor's largest magnitude), L1 at 33 output
channels against its plain version (rtol 1e-5, atol 1e-5 max|plain|) with
the bf16 forward launching it, and ``scripts/jax_init.py``'s weights drawn
on the card against those drawn on the CPU.
"""

from torch_lane import cuda_device, nchw  # noqa: F401  (cuda_device: a fixture)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fal_net_torch.models import create_model
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.scripts.jax_init import jax_init_state_dict
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.scripts import verify_variants
from fal_net_torch.train.stages import stage1_loss

H, W, B = 64, 128, 2
ALL = dict(ret_disp=True, ret_pan=True, ret_subocc=True)
STAGE1 = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=0.2 * 2 / 512 * 50)  # as tests/test_torch_train.py
MODES = {
    "disp": dict(ret_disp=True),
    "pan": dict(ret_disp=False, ret_pan=True),
    "disp+pan": dict(ret_disp=True, ret_pan=True),
    "disp+pan+subocc": ALL,
}
TOL = verify_variants.TOL
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
L1_TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported by the CPU tests only: the card's machine,
    which runs the cuda-marked tests, lacks the JAX package's flax."""
    import jax
    import jax.numpy as jnp

    from fal_net_tpu.models import VARIANTS
    from fal_net_tpu.models import create_model as jax_create_model
    from fal_net_tpu.models.torch_import import convert_state_dict
    from fal_net_tpu.train.stages import stage1_loss

    def model(variant, num_levels=None, **kw):
        """The JAX model in plain form (no TPU layout rewrites), its MED head plain."""
        return jax_create_model(
            variant, num_levels, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
            stem_flow_analytic=False, fuse_logits=False, phase_deconv=False, **kw,
        )

    def variables(variant, num_levels):
        """Seeded JAX parameters at the shapes of the plain model's init
        (traced, not run): conv kernels (HWIO) normal with variance 2 /
        fan-in, biases normal times 0.01."""
        shapes = jax.eval_shape(lambda: model(variant, num_levels).init(
            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), 2.0, 300.0, ret_disp=True))
        rng = np.random.default_rng(0)

        def draw(s):
            scale = np.sqrt(2.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 else 0.01
            return jnp.asarray((rng.standard_normal(s.shape) * scale).astype(np.float32))

        return jax.tree.map(draw, shapes)

    return SimpleNamespace(jax=jax, jnp=jnp, VARIANTS=VARIANTS, convert_state_dict=convert_state_dict,
                           stage1_loss=stage1_loss, model=model, variables=variables)


def _carried(variables, variant, num_levels=None, **kw):
    port = create_model(variant, num_levels, device="cpu", **kw)
    sd = state_dict_from_jax(variables["params"], variant)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port


def _images(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("variant,quirk", [("A", False), ("A", True), ("C", False)])
def test_default_levels_forward_matches_jax(jx, variant, quirk):
    jax_model = jx.model(variant, a_maskr_quirk=quirk)
    assert jax_model.num_levels == 33
    x = _images(1, B, H, W, 3)
    variables = jx.variables(variant, 33)
    want, inter = jx.jax.jit(lambda v, x: jax_model.apply(v, x, 2.0, 300.0, **ALL, capture_intermediates=True,
                                                       mutable=["intermediates"]))(variables, x)
    want_logits = np.asarray(inter["intermediates"]["logits_1x1"]["__call__"][0])

    port = _carried(variables, variant, a_maskr_quirk=quirk)
    assert port.num_levels == 33
    left = torch.from_numpy(nchw(x))
    with torch.no_grad():
        logits = port.logits(left, 300.0)
        got = port(left, 2.0, 300.0, **ALL)
    np.testing.assert_allclose(logits.numpy(), nchw(want_logits), rtol=1e-3, atol=1e-3)
    for name in ("disp", "pan", "maskL", "maskR"):
        np.testing.assert_allclose(getattr(got, name).numpy(), nchw(getattr(want, name)), rtol=1e-3,
                                   atol=5e-3, err_msg=name)


@pytest.mark.parametrize("variant", ["A", "C"])
def test_stage1_loss_and_grads_match_jax(jx, variant):
    """A's separable (3,1)/(1,3) residuals and C's 512-wide encoder and
    iconv6 in the backward, against jax.value_and_grad."""
    jax, jax_model = jx.jax, jx.model(variant, 9)
    left, right = _images(2, B, H, W, 3), _images(3, B, H, W, 3)
    variables = jx.variables(variant, 9)
    jb = {"left": jx.jnp.asarray(left), "right": jx.jnp.asarray(right)}
    (want, want_aux), jax_grads = jax.jit(jax.value_and_grad(
        lambda p: jx.stage1_loss(p, jb, jax_model.apply, **STAGE1), has_aux=True
    ))(variables)

    port = _carried(variables, variant, 9)
    tb = {"left": torch.from_numpy(nchw(left)), "right": torch.from_numpy(nchw(right))}
    loss, aux = stage1_loss(port, tb, **STAGE1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k in ("rec_loss", "sm_loss"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=1e-5)

    # C's amask head is declared and never called (models/backbone.py): no gradient, zeros in JAX
    grads = jx.convert_state_dict({k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                                   for k, p in port.named_parameters()}, jx.VARIANTS[variant])

    def close(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=jax.tree_util.keystr(path))

    assert jax.tree.structure(grads) == jax.tree.structure(jax_grads["params"])
    jax.tree_util.tree_map_with_path(close, grads, jax_grads["params"])


@pytest.mark.parametrize("variant,num_levels,seed", [("A", 33, 0), ("C", 33, 0), ("tiny", 9, 3)])
def test_jax_init_draws_jaxs_initial_weights(jx, variant, num_levels, seed):
    """scripts/jax_init.py against the JAX model's own init from PRNGKey(seed):
    the same parameters (a wrong key would give other numbers entirely),
    within a few ulps (scipy's erfinv against XLA's)."""
    jax = jx.jax
    model = jx.model(variant, num_levels)
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(seed), x, 2.0, 18.0, ret_disp=True))(
        jx.jnp.zeros((1, 32, 64, 3)))
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]), variant)
    got = jax_init_state_dict(variant, num_levels, seed)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("variant", ["A", "C"])
def test_verify_variants_check_training_on_cpu(variant):
    res = verify_variants.check_training(variant, steps=2, h=32, w=64, b=2, device="cpu")
    assert np.isfinite(res["first"]) and np.isfinite(res["last"])
    assert res["launches"] == (0, 0)  # on the CPU the model's MED head is the plain one
    assert 2.0 <= res["median"] <= 18.0


@pytest.mark.parametrize("variant", ["A", "C"])
def test_verify_variants_check_variant_on_cpu(variant):
    """Untimed and small: the forward's checks, and for A the quirk model on
    the default one's weights (maskR differs, the rest bit-identical)."""
    res = verify_variants.check_variant(variant, h=32, w=64, batches=(1,), device="cpu", timed=False)
    assert res["ok"] and res["num_levels"] == 33
    if variant == "A":
        assert res["quirk"]["mask_diff"] > 1e-4


def _gpu_model(variant, dev, **kw):
    return create_model(variant, generator=torch.Generator().manual_seed(0), device=dev, **kw)


def _gpu_images(dev, seed=0):
    return torch.from_numpy(_images(seed, B, 3, H, W)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["A", "C"])
def test_forward_k1_matches_plain_on_gpu(cuda_device, variant):
    from fal_net_torch.ops.med_kernel import MedForward

    model = _gpu_model(variant, cuda_device).eval()
    assert model.num_levels == 33
    x = _gpu_images(cuda_device)
    with torch.no_grad():
        logits = model.logits(x, 300.0).contiguous()
        model.logits = lambda left, max_disp: logits  # one set of logits for the kernel and the plain head
        for mode, kw in MODES.items():
            before = MedForward.mode_launches.get(mode, 0)
            got = model(x, 2.0, 300.0, **kw)
            torch.cuda.synchronize()
            assert MedForward.mode_launches.get(mode, 0) == before + 1, mode
            want = med_outputs(logits, x, 2.0, 300.0, **kw)
            for name, (rtol, atol) in TOL.items():
                g, w = getattr(got, name), getattr(want, name)
                assert (g is None) == (w is None), (mode, name)
                if g is not None:
                    torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=f"{mode} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["A", "C"])
def test_stage1_grads_through_k2_match_plain_on_gpu(cuda_device, variant):
    from fal_net_torch.losses.photometric import rec_loss
    from fal_net_torch.losses.smoothness import smoothness
    from fal_net_torch.ops.med_kernel import MedForward, med_outputs_fused
    from fal_net_torch.ops.med_vjp import med_vjp
    from fal_net_torch.utils.timing import tf32

    model = _gpu_model(variant, cuda_device)
    plain = _gpu_model(variant, cuda_device, med_impl="reference")
    plain.load_state_dict(model.state_dict())
    batch = {"left": _gpu_images(cuda_device, 2), "right": _gpu_images(cuda_device, 3)}
    mn, mx = STAGE1["min_disp"], STAGE1["max_disp"]

    # K2 on the model's own logits with the stage-1 loss's cotangents, in sum form (O(1) cotangents)
    with torch.no_grad():
        logits = model.logits(batch["left"], mx)
    lg = logits.clone().requires_grad_()
    out = med_outputs_fused(lg, batch["left"], mn, mx, ret_disp=True, ret_pan=True)
    x0 = int(0.2 * W)
    loss = out.pan.numel() * (rec_loss(1.0, out.pan, batch["right"], None, 0.0)
                              + STAGE1["a_sm"] * smoothness(batch["left"][..., x0:], out.disp[..., x0:], gamma=2.0))
    g_disp, g_pan = torch.autograd.grad(loss, (out.disp, out.pan), retain_graph=True)
    (g_k2,) = torch.autograd.grad(loss, lg)
    g_plain, _ = med_vjp(logits, batch["left"], mn, mx, g_disp, g_pan, image_grad=False)
    torch.testing.assert_close(g_k2, g_plain, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    # every parameter gradient through K1 and K2 against the plain head's autograd
    grads = {}
    with tf32(False):
        for name, m in (("kernels", model), ("plain", plain)):
            k2 = MedForward.bwd_launches
            loss, _ = stage1_loss(m, batch, **STAGE1)
            loss.backward()
            torch.cuda.synchronize()
            assert MedForward.bwd_launches - k2 == (name == "kernels")
            grads[name] = (loss.item(), {k: p.grad for k, p in m.named_parameters()})
    np.testing.assert_allclose(grads["kernels"][0], grads["plain"][0], rtol=1e-5)
    for k, g in grads["kernels"][1].items():
        w = grads["plain"][1][k]
        assert (g is None) == (w is None), k  # C's amask head is never called: no gradient on either side
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["A", "C"])
def test_l1_at_33_channels_on_gpu(cuda_device, variant):
    from fal_net_torch.ops.logits_conv import LAUNCHES, logits_conv, logits_conv_plain
    from fal_net_torch.ops.med_kernel import MedForward
    from fal_net_torch.utils.timing import tf32

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((B, 96, H, W), device=cuda_device, generator=gen).to(torch.bfloat16)
    k = (torch.randn((33, 96, 3, 3), device=cuda_device, generator=gen) / np.sqrt(9 * 96)).to(torch.bfloat16)
    bias = torch.randn(33, device=cuda_device, generator=gen)
    before = LAUNCHES["logits_conv"]
    got = logits_conv(x, k, bias, 1)
    torch.cuda.synchronize()
    assert LAUNCHES["logits_conv"] == before + 1
    with tf32(False):
        want = logits_conv_plain(x, k, bias, 1)
    torch.testing.assert_close(got, want, rtol=L1_TOL, atol=L1_TOL * float(want.abs().max()))

    model = _gpu_model(variant, cuda_device, dtype="bfloat16").eval()
    l1, k1 = LAUNCHES["logits_conv"], MedForward.launches
    with torch.no_grad():
        out = model(_gpu_images(cuda_device), 2.0, 300.0, **ALL)
    torch.cuda.synchronize()
    assert (LAUNCHES["logits_conv"] - l1, MedForward.launches - k1) == (1, 1)
    assert all(bool(torch.isfinite(t).all()) for t in out) and out.disp.dtype == torch.float32


@pytest.mark.cuda
def test_jax_init_draws_the_same_weights_on_gpu(cuda_device):
    """The random words made on the card (as verify_variants makes them)
    give the CPU's weights: integer arithmetic, then fp32 and fp64 ops."""
    cpu, gpu = jax_init_state_dict("tiny", 9, 3), jax_init_state_dict("tiny", 9, 3, cuda_device)
    assert gpu.keys() == cpu.keys()
    for k, w in cpu.items():
        np.testing.assert_allclose(gpu[k], w, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("script,argv", [("verify_variants", ["--no_train"]), ("med_times", []),
                                         ("med_times", ["--l1"])])
def test_scripts_need_cuda(script, argv):
    """The scripts run on the card or raise; never on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the script would run for real")
    with pytest.raises(RuntimeError, match="is_available"):
        importlib.import_module(f"fal_net_torch.scripts.{script}").main(argv)

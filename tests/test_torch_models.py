"""The port's models vs the JAX package: parameter counts, weights carried
both ways, and the forward on shared weights and inputs.

The JAX model is built in its plain form (no s2d stem, no fused logits, no
phase deconvs) with the MED head through its Pallas kernel in interpret
mode.  Tolerances: logits rtol/atol 1e-3 (fp32 conv summation order, XLA vs
oneDNN); disp and pan rtol 1e-3 / atol 5e-3, as tests/test_models.py:93.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_torch.models import create_model, registry
from fal_net_torch.models.checkpoint import detect_variant
from fal_net_torch.models.jax_import import state_dict_from_jax

EXPECTED_PARAM_COUNTS = {("A", 33): 6_582_530, ("B", 49): 16_974_354, ("C", 33): 25_807_074}


def _jax_model(variant, num_levels):
    return jax_create_model(
        variant, num_levels, med_impl="fused", med_interpret=True, s2d_stem=False,
        stem_input_fuse=False, stem_flow_analytic=False, fuse_logits=False, phase_deconv=False,
    )


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)), a, b)


@pytest.mark.parametrize("variant,num_levels", sorted(EXPECTED_PARAM_COUNTS))
def test_param_count(variant, num_levels):
    model = create_model(variant, num_levels, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == EXPECTED_PARAM_COUNTS[(variant, num_levels)]


def test_registry_names():
    for name in ("FAL_netA", "FAL_netB", "FAL_netC", "A", "B", "C", "falnet_a", "falnet_b", "falnet_c"):
        model = registry.get(name, device="cpu")
        assert model.num_levels == JAX_VARIANTS[name[-1].upper()].default_levels
        assert model.spec.name == name[-1].upper()
    with pytest.raises(ValueError, match="unknown variant"):
        registry.get("FAL_netD", device="cpu")


@pytest.mark.parametrize("variant", ["A", "B", "C", "tiny"])
def test_weights_round_trip(variant):
    """convert_state_dict(port state_dict) is the JAX tree, and
    state_dict_from_jax inverts it exactly, both ways."""
    num_levels = 9
    shapes = jax.eval_shape(
        lambda: _jax_model(variant, num_levels).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)), 2.0, 300.0, ret_disp=True
        )
    )["params"]
    rng = np.random.default_rng(0)
    jax_params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)

    port = create_model(variant, num_levels, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(jax_params, variant).items()})
    assert detect_variant(port.state_dict()).name == variant
    _assert_trees_equal(convert_state_dict(_numpy_sd(port), JAX_VARIANTS[variant]), jax_params)

    port = create_model(variant, num_levels, generator=torch.Generator().manual_seed(1), device="cpu")
    sd = _numpy_sd(port)
    back = state_dict_from_jax(convert_state_dict(sd, JAX_VARIANTS[variant]), variant)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.mark.parametrize(
    "variant,h,w",
    [("tiny", 32, 64), ("tiny", 60, 96), ("B", 64, 128), ("A", 64, 128), ("C", 64, 128)],  # 60: a non-2x upsample
)
def test_forward_matches_jax(rng, variant, h, w):
    num_levels = 9
    jax_model = _jax_model(variant, num_levels)
    x = (rng.standard_normal((2, h, w, 3)) * 0.3).astype(np.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), 2.0, 300.0, ret_disp=True)
    want, inter = jax_model.apply(
        variables, jnp.asarray(x), 2.0, 300.0, ret_disp=True, ret_pan=True,
        capture_intermediates=True, mutable=["intermediates"],
    )
    want_logits = np.asarray(inter["intermediates"]["logits_1x1"]["__call__"][0])

    port = create_model(variant, num_levels, device="cpu")
    port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], variant).items()}
    )
    left = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        logits = port.logits(left, 300.0)
        got = port(left, 2.0, 300.0, ret_disp=True, ret_pan=True)
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(logits.numpy(), to_nchw(want_logits), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.disp.numpy(), to_nchw(want.disp), rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(got.pan.numpy(), to_nchw(want.pan), rtol=1e-3, atol=5e-3)
    assert got.maskL is None and got.maskR is None


def test_med_impl_reference_matches_auto_on_cpu(rng):
    """On CPU tensors "auto" selects the plain head, the same as "reference"."""
    auto = create_model("tiny", 5, generator=torch.Generator().manual_seed(0), device="cpu")
    ref = create_model("tiny", 5, med_impl="reference", device="cpu")
    ref.load_state_dict(auto.state_dict())
    left = torch.from_numpy(rng.standard_normal((1, 3, 32, 64)).astype(np.float32))
    with torch.no_grad():
        a = auto(left, 2.0, 30.0, ret_disp=True, ret_pan=True, ret_subocc=True)
        r = ref(left, 2.0, 30.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    for name in a._fields:
        torch.testing.assert_close(getattr(a, name), getattr(r, name), rtol=0, atol=0)

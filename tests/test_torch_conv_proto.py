"""The port of the kernel scripts (K3, K4, K5) vs the JAX scripts' own Pallas
kernels.

scripts/proto_conv_kernel.py, proto_conv_kernel_v2.py and probe_roll_bug.py
are loaded by path with ``pl.pallas_call`` run in TPU interpret mode, so the
plain versions of fal_net_torch.ops.conv3x3 and .roll_probe are held
against the TPU kernels themselves on the same seeded numpy inputs.  The
fp32 convs agree within atol 1e-5 (fp32 sums of up to 72 terms in another
order); the TF32 conv, which the CUDA kernel computes, within the TF32
bound 2^-9 (|x| conv |w|) + 1e-5; the weight layouts and the roll exactly.
The tests marked cuda hold each CUDA kernel against its plain versions and
skip without a card.
"""

from torch_lane import cuda_device  # noqa: F401  (cuda_device: a fixture)
import contextlib
import functools
import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fal_net_torch.ops import conv3x3, roll_probe
from fal_net_torch.ops.conv3x3 import (
    conv3x3_packed,
    conv3x3_packed_plain,
    conv3x3_tf32_plain,
    conv3x3_v2,
    conv3x3_v2_plain,
    permuted_weights,
    repack_weights,
    tf32_round,
)
from fal_net_torch.ops.roll_probe import roll_window, roll_window_plain
from fal_net_torch.utils.timing import tf32

TF32_REL = 2.0**-9  # two operands truncated to TF32: each product within 2^-9 of its fp32 value
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_scripts():
    """The three JAX scripts, with pallas_call in TPU interpret mode while
    this module's tests run; loading the probe runs its sweep."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            probe = _load("probe_roll_bug")
        yield {
            "k3": _load("proto_conv_kernel"),
            "k4": _load("proto_conv_kernel_v2"),
            "k5": probe,
            "probe_output": printed.getvalue(),
        }


def _conv_inputs(seed, b, cin, h, w, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    w_oihw = (rng.standard_normal((cout, cin, 3, 3)) * 0.05).astype(np.float32)
    return x, w_oihw


def _hwio(w_oihw):
    return jnp.asarray(w_oihw.transpose(2, 3, 1, 0))


def test_probe_script_passes_in_interpret_mode(jax_scripts):
    assert "ROLL PROBE: PASS" in jax_scripts["probe_output"]


@pytest.mark.parametrize("cout", [1, 5])
@pytest.mark.parametrize("cin", [3, 8])
@pytest.mark.parametrize("h", [8, 16])
def test_conv_plain_matches_tpu_kernels(jax_scripts, h, cin, cout):
    x, w = _conv_inputs(h * 100 + cin * 10 + cout, 2, cin, h, 37, cout)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got3 = conv3x3_packed_plain(xt, repack_weights(wt)).numpy()
    want3 = np.asarray(jax_scripts["k3"].conv3x3_packed(jnp.asarray(x), jax_scripts["k3"].repack_weights(_hwio(w))))
    np.testing.assert_allclose(got3, want3, rtol=0, atol=1e-5)
    got4 = conv3x3_v2_plain(xt, permuted_weights(wt)).numpy()
    want4 = np.asarray(jax_scripts["k4"].conv3x3_v2(jnp.asarray(x), jax_scripts["k4"].permuted_weights(_hwio(w))))
    np.testing.assert_allclose(got4, want4, rtol=0, atol=1e-5)


def test_weight_layouts_match_jax(jax_scripts):
    _, w = _conv_inputs(1, 1, 6, 8, 8, 7)
    wt = torch.from_numpy(w)
    np.testing.assert_array_equal(repack_weights(wt).numpy(), np.asarray(jax_scripts["k3"].repack_weights(_hwio(w))))
    np.testing.assert_array_equal(permuted_weights(wt).numpy(), np.asarray(jax_scripts["k4"].permuted_weights(_hwio(w))))


def _within_tf32_bound(got, want, x, w2, atol):
    """|got - want| <= 2^-9 (|x| conv |w2|) + atol elementwise, want being
    the fp32 conv of x with w2."""
    slack = TF32_REL * conv3x3_packed_plain(x.abs(), w2.abs()) + atol
    err = (got - want).abs()
    assert bool((err <= slack).all()), f"max err {float(err.max()):.3e}, worst ratio {float((err / slack).max()):.3f}"


def _bits(values):
    return torch.tensor(values, dtype=torch.float32).view(torch.int32).tolist()


def test_tf32_round_fixed_bit_patterns():
    """Truncation toward zero to 10 mantissa bits, as the tensor cores read
    fp32: a tie (halfway between two TF32 values) goes down, a negative value
    toward zero, a representable value and inf stay as they are."""
    tie, neg = 1 + 2.0**-11, -(1 + 2.0**-10 + 2.0**-11 + 2.0**-20)
    got = tf32_round(torch.tensor([tie, neg, 1.5 + 2.0**-10, 3.0 * 2.0**-130, float("inf"), float("-inf")]))
    want = [1.0, -(1 + 2.0**-10), 1.5 + 2.0**-10, 3.0 * 2.0**-130, float("inf"), float("-inf")]
    assert _bits(got.tolist()) == _bits(want)
    # the bit pattern itself: the low 13 bits cleared, nothing else changed
    x = torch.tensor([0x3F80_1FFF, -0x407F_E001], dtype=torch.int32).view(torch.float32)
    assert tf32_round(x).view(torch.int32).tolist() == [0x3F80_0000, -0x407F_E001 & -(1 << 13)]


def test_permuted_weights_variant0_is_repack():
    """K4 hands the kernel w3[0]: variant p = 0 maps slot s to dy = s."""
    _, w = _conv_inputs(2, 1, 7, 8, 8, 5)
    wt = torch.from_numpy(w)
    assert torch.equal(permuted_weights(wt)[0], repack_weights(wt))


@pytest.mark.parametrize("cout", [1, 5])
@pytest.mark.parametrize("cin", [3, 8])
@pytest.mark.parametrize("h", [8, 16])
def test_conv_tf32_plain_within_bound_of_tpu_kernels(jax_scripts, h, cin, cout):
    """The TF32 plain conv (the CUDA kernel's function) against the fp32 plain
    version and against both TPU kernels, within the TF32 bound."""
    x, w = _conv_inputs(h * 100 + cin * 10 + cout, 2, cin, h, 37, cout)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    w2 = repack_weights(wt)
    got = conv3x3_tf32_plain(xt, w2)
    assert not torch.equal(got, conv3x3_packed_plain(xt, w2))  # the rounding is really applied
    _within_tf32_bound(got, conv3x3_packed_plain(xt, w2), xt, w2, 1e-5)
    k3, k4 = jax_scripts["k3"], jax_scripts["k4"]
    _within_tf32_bound(got, torch.from_numpy(np.array(k3.conv3x3_packed(jnp.asarray(x), k3.repack_weights(_hwio(w))))), xt, w2, 1e-5)
    _within_tf32_bound(got, torch.from_numpy(np.array(k4.conv3x3_v2(jnp.asarray(x), k4.permuted_weights(_hwio(w))))), xt, w2, 1e-5)


@pytest.mark.parametrize("b,cin,h,w,cout", [(2, 3, 13, 37, 5), (1, 8, 5, 20, 1), (1, 20, 11, 9, 70)])
def test_conv_plain_matches_conv2d_at_any_height(b, cin, h, w, cout):
    x, wt = (torch.from_numpy(a) for a in _conv_inputs(7, b, cin, h, w, cout))
    want = F.conv2d(x, wt, padding=1)
    torch.testing.assert_close(conv3x3_packed_plain(x, repack_weights(wt)), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(conv3x3_v2_plain(x, permuted_weights(wt)), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tiles", [3, 4, 5, 6, 8])
def test_roll_plain_matches_tpu_probe(jax_scripts, tiles):
    k5 = jax_scripts["k5"]
    wp = tiles * 128
    run = k5.make_fn(wp)
    x = np.random.default_rng(tiles).standard_normal((k5.H, k5.W)).astype(np.float32)
    for f in (0, 1, 5, 17, 127, wp - 1, -3, wp + 5):
        want = np.asarray(run(jnp.asarray([f], jnp.int32), jnp.asarray(x)))
        got = roll_window_plain(torch.from_numpy(x), torch.tensor([f], dtype=torch.int32), wp, k5.L)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"wp={wp} f={f}")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,cin,h,w,cout",
    [(2, 3, 13, 37, 5), (1, 20, 35, 300, 70), (2, 64, 24, 130, 64), (1, 96, 16, 128, 49)],
)
def test_conv_kernels_match_plain_on_gpu(cuda_device, b, cin, h, w, cout):
    """K3 and K4, both through the TF32 wgmma kernel, against the TF32 plain
    version at (1e-5, 1e-4) and the fp32 plain version within the TF32 bound.
    W = 37 and 130 take the cp.async staging, W = 300 and 128 TMA; Cout = 49
    pads N to 56, Cout = 70 takes two channel tiles."""
    x, wt = (torch.from_numpy(a).to(cuda_device) for a in _conv_inputs(3, b, cin, h, w, cout))
    counts = dict(conv3x3.LAUNCHES)
    w2 = repack_weights(wt)
    with tf32(False):  # the plain versions' einsum in fp32
        want_tf32, want_fp32 = conv3x3_tf32_plain(x, w2), conv3x3_packed_plain(x, w2)
        for kernel, wk in ((conv3x3_packed, w2), (conv3x3_v2, permuted_weights(wt))):
            got = kernel(x, wk)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want_tf32, rtol=1e-5, atol=1e-4)
            _within_tf32_bound(got, want_fp32, x, w2, 1e-4)
    assert {k: conv3x3.LAUNCHES[k] - counts[k] for k in counts} == {"conv3x3": 2}  # one op for K3 and K4


@pytest.mark.cuda
def test_conv_v2_runs_past_102_channels(cuda_device):
    """K4's old body held all Cin channels of four rows in shared memory and
    refused Cin = 103; the wgmma kernel stages 8 channels at a time."""
    x, wt = (torch.from_numpy(a).to(cuda_device) for a in _conv_inputs(5, 1, 103, 9, 40, 4))
    with tf32(False):
        got = conv3x3_v2(x, permuted_weights(wt))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, conv3x3_tf32_plain(x, repack_weights(wt)), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_conv_entry_refuses_empty_batch(cuda_device):
    """The C entry refuses a size below 1; the wrapper raises without counting
    a launch."""
    x = torch.zeros(0, 4, 8, 8, device=cuda_device)
    w2 = repack_weights(torch.zeros(4, 4, 3, 3, device=cuda_device))
    counts = dict(conv3x3.LAUNCHES)
    with pytest.raises(ValueError, match="conv3x3_wgmma"):
        conv3x3_packed(x, w2)
    assert conv3x3.LAUNCHES == counts


@pytest.mark.cuda
@pytest.mark.parametrize("wp", [384, 640, 1024])
def test_roll_kernel_matches_plain_on_gpu(cuda_device, wp):
    x = torch.from_numpy(np.random.default_rng(wp).standard_normal((8, 128)).astype(np.float32)).to(cuda_device)
    for f in (0, 17, wp - 1, -3, wp + 5, -2 * wp - 7):
        ft = torch.tensor([f], dtype=torch.int32, device=cuda_device)
        assert torch.equal(roll_window(x, ft, wp), roll_window_plain(x, ft, wp)), f

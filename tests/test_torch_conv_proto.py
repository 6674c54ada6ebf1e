"""The port of the kernel scripts (K3, K4, K5) vs the JAX scripts' own Pallas
kernels.

scripts/proto_conv_kernel.py, proto_conv_kernel_v2.py and probe_roll_bug.py
are loaded by path with ``pl.pallas_call`` run in TPU interpret mode, so the
plain versions of fal_net_torch.ops.conv3x3 and .roll_probe are held
against the TPU kernels themselves on the same seeded numpy inputs.  The
convs agree within atol 1e-5 (fp32 sums of up to 72 terms in another
order); the weight layouts and the roll exactly.  The tests marked cuda
hold each CUDA kernel against its plain version and skip without a card.
"""

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
    conv3x3_v2,
    conv3x3_v2_plain,
    permuted_weights,
    repack_weights,
)
from fal_net_torch.ops.roll_probe import roll_window, roll_window_plain
from fal_net_torch.utils.timing import tf32

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the conv and roll kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,h,w,cout", [(2, 3, 13, 37, 5), (1, 20, 35, 300, 70), (2, 64, 24, 130, 64)])
def test_conv_kernels_match_plain_on_gpu(cuda_device, b, cin, h, w, cout):
    x, wt = (torch.from_numpy(a).to(cuda_device) for a in _conv_inputs(3, b, cin, h, w, cout))
    counts = dict(conv3x3.LAUNCHES)
    with tf32(False):  # the plain versions' einsum in fp32
        for kernel, plain, layout in (
            (conv3x3_packed, conv3x3_packed_plain, repack_weights),
            (conv3x3_v2, conv3x3_v2_plain, permuted_weights),
        ):
            wk = layout(wt)
            got = kernel(x, wk)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, plain(x, wk), rtol=1e-5, atol=1e-4)
    assert {k: conv3x3.LAUNCHES[k] - counts[k] for k in counts} == {"conv3x3_packed": 1, "conv3x3_v2": 1}


@pytest.mark.cuda
def test_conv_v2_refuses_what_shared_memory_cannot_hold(cuda_device):
    """K4 holds four rows of all Cin channels in shared memory: its C entry
    refuses Cin = 103 and the wrapper raises without counting a launch."""
    x = torch.zeros(1, 103, 8, 8, device=cuda_device)
    w3 = permuted_weights(torch.zeros(4, 103, 3, 3, device=cuda_device))
    counts = dict(conv3x3.LAUNCHES)
    with pytest.raises(ValueError, match="conv3x3_v2"):
        conv3x3_v2(x, w3)
    assert conv3x3.LAUNCHES == counts


@pytest.mark.cuda
@pytest.mark.parametrize("wp", [384, 640, 1024])
def test_roll_kernel_matches_plain_on_gpu(cuda_device, wp):
    x = torch.from_numpy(np.random.default_rng(wp).standard_normal((8, 128)).astype(np.float32)).to(cuda_device)
    for f in (0, 17, wp - 1, -3, wp + 5, -2 * wp - 7):
        ft = torch.tensor([f], dtype=torch.int32, device=cuda_device)
        assert torch.equal(roll_window(x, ft, wp), roll_window_plain(x, ft, wp)), f

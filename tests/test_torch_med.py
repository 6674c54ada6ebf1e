"""The port's plain MED head and shift ops vs the JAX package.

Same seeded numpy inputs go through fal_net_tpu (NHWC) and fal_net_torch
(NCHW); the JAX side runs its plain head and its Pallas kernel in interpret
mode.  Tolerances are those of tests/test_med_pallas.py.
"""

import torch_lane  # noqa: F401  (torch's threads sized to the xdist worker)
import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from fal_net_tpu.ops.med import med_outputs as jax_med_outputs
from fal_net_tpu.ops.med_pallas import med_outputs_fused as jax_med_outputs_fused
from fal_net_tpu.ops.shift import hshift as jax_hshift
from fal_net_torch.ops.med import med_outputs, pixel_shifts
from fal_net_torch.ops.med_kernel import plane_tables
from fal_net_torch.ops.shift import hflip, hshift, hshift_planes

TOL = {"disp": (1e-5, 1e-4), "pan": (1e-4, 1e-4), "maskL": (1e-4, 1e-4), "maskR": (1e-4, 1e-4)}
ALL = dict(ret_disp=True, ret_pan=True, ret_subocc=True)


def _inputs(rng, b, h, w, n, c):
    logits = rng.standard_normal((b, n, h, w)).astype(np.float32)
    image = rng.standard_normal((b, c, h, w)).astype(np.float32)
    return logits, image


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _assert_matches_jax(got, want_nhwc, fields=TOL):
    for name in fields:
        g, w = getattr(got, name), getattr(want_nhwc, name)
        assert (g is None) == (w is None), name
        if g is None:
            continue
        rtol, atol = TOL[name]
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rtol=rtol, atol=atol, err_msg=name
        )


@pytest.mark.parametrize(
    "b,h,w,n,c,min_disp,max_disp",
    [
        (1, 16, 256, 9, 3, 2.0, 300.0),  # test_med_pallas.py:23 bound pairs
        (1, 16, 256, 9, 3, 1.0, 30.0),
        (1, 13, 256, 9, 3, 2.0, 300.0),  # odd H
        (1, 16, 187, 9, 3, 2.0, 300.0),  # unaligned W
        (3, 16, 96, 2, 3, 2.0, 300.0),  # the adversarial set of :155-162
        (1, 3, 64, 5, 1, 2.0, 300.0),
        (2, 16, 48, 7, 4, 2.0, 300.0),
        (1, 8, 140, 49, 3, 2.0, 300.0),
        (1, 8, 96, 9, 3, -1.0, -30.0),  # negative bounds (swapped samples)
    ],
)
def test_med_outputs_matches_jax(rng, b, h, w, n, c, min_disp, max_disp):
    logits, image = _inputs(rng, b, h, w, n, c)
    got = med_outputs(torch.from_numpy(logits), torch.from_numpy(image), min_disp, max_disp, **ALL)
    want = jax_med_outputs(_nhwc(logits), _nhwc(image), min_disp, max_disp, **ALL)
    _assert_matches_jax(got, want)
    fused = jax_med_outputs_fused(
        _nhwc(logits), _nhwc(image), min_disp, max_disp, interpret=True, **ALL
    )
    _assert_matches_jax(got, fused)


@pytest.mark.parametrize(
    "mode", [dict(ret_disp=True), dict(ret_disp=False, ret_pan=True), dict(ret_disp=True, ret_pan=True)]
)
def test_med_outputs_modes_match_jax(rng, mode):
    logits, image = _inputs(rng, 2, 8, 140, 49, 3)
    got = med_outputs(torch.from_numpy(logits), torch.from_numpy(image), 2.0, 300.0, **mode)
    want = jax_med_outputs(_nhwc(logits), _nhwc(image), 2.0, 300.0, **mode)
    _assert_matches_jax(got, want)
    assert got.maskL is None and got.maskR is None


def test_med_outputs_per_sample_tensor_bounds(rng):
    """Per-sample (B,) bounds, including negated ones
    (test_round2_fixes.py::test_med_negative_bounds_parity)."""
    logits, image = _inputs(rng, 3, 8, 96, 9, 3)
    mn = np.asarray([2.0, -1.0, 1.0], np.float32)
    mx = np.asarray([300.0, -30.0, 30.0], np.float32)
    got = med_outputs(
        torch.from_numpy(logits), torch.from_numpy(image), torch.from_numpy(mn), torch.from_numpy(mx), **ALL
    )
    want = jax_med_outputs(_nhwc(logits), _nhwc(image), jnp.asarray(mn), jnp.asarray(mx), **ALL)
    _assert_matches_jax(got, want)


def test_plane_tables_match_pixel_shifts():
    """The kernel's tables and the plain head's shifts are the same float64
    numbers, so both sample at the same positions (floors clamped to
    [-W-1, W+1], where every read is out of range, as hshift clamps)."""
    for n, w in ((49, 1280), (7, 48), (33, 140)):
        tabs = plane_tables(2.0, 300.0, n, w)
        assert tabs.shape == (1, 5, n) and tabs.dtype == torch.float32
        lev, f_fw, t_fw, f_bw, t_bw = tabs[0].numpy()
        s = pixel_shifts(2.0, 300.0, n, w).numpy()
        clamp = lambda f: np.clip(f, -w - 1, w + 1)
        np.testing.assert_array_equal(f_fw, clamp(np.floor(s)))
        np.testing.assert_allclose(t_fw, s - np.floor(s), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(f_bw, clamp(np.floor(-s)))
        np.testing.assert_allclose(t_bw, -s - np.floor(-s), rtol=0, atol=1e-7)
        np.testing.assert_allclose(lev, s * w / (w - 1), rtol=1e-7)


def test_plane_tables_per_sample_bounds():
    """(B,) bounds give one table per sample, each the table of that
    sample's scalar bounds; a 0-d bound broadcasts over the batch."""
    mn = torch.tensor([2.0, -1.0, 1.0])
    mx = torch.tensor([300.0, -30.0, 30.0])
    tabs = plane_tables(mn, mx, 9, 96)
    assert tabs.shape == (3, 5, 9) and torch.isfinite(tabs).all()
    for i in range(3):
        torch.testing.assert_close(tabs[i : i + 1], plane_tables(float(mn[i]), float(mx[i]), 9, 96), rtol=0, atol=0)
    mx_pos = torch.tensor([300.0, 30.0, 20.0])
    mixed = plane_tables(torch.tensor(2.0), mx_pos, 9, 96)
    assert torch.isfinite(mixed).all()
    for i in range(3):
        torch.testing.assert_close(mixed[i : i + 1], plane_tables(2.0, float(mx_pos[i]), 9, 96), rtol=0, atol=0)


def _grid_sample_hshift(x_nchw: np.ndarray, x_of: float) -> np.ndarray:
    """Reference-style horizontal warp via affine_grid + grid_sample."""
    t = torch.from_numpy(x_nchw)
    b, c, h, w = t.shape
    theta = torch.zeros(b, 2, 3)
    theta[:, 0, 0] = 1
    theta[:, 1, 1] = 1
    grid = F.affine_grid(theta, [b, c, h, w], align_corners=True).clone()
    grid[:, :, :, 0] = grid[:, :, :, 0] + x_of
    return F.grid_sample(t, grid, align_corners=True, padding_mode="zeros").numpy()


@pytest.mark.parametrize("disp_px", [0.0, 1.0, 2.7, 37.51, -5.25, 300.0, 640.0])
def test_hshift_matches_grid_sample_and_jax(rng, disp_px):
    b, c, h, w = 2, 3, 8, 64
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    shift = disp_px * (w - 1) / w
    got = hshift(torch.from_numpy(x), shift).numpy()
    # grid_sample round-trips pixel->normalized->pixel in fp32, which moves
    # the interpolation weight by ~1e-5 (tests/test_shift.py)
    np.testing.assert_allclose(got, _grid_sample_hshift(x, 2.0 * disp_px / w), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_hshift(jnp.asarray(x), shift, axis=-1)), rtol=1e-4, atol=2e-4
    )


def test_hshift_planes_matches_per_plane_loop(rng):
    b, n, h, w = 2, 7, 6, 48
    x = torch.from_numpy(rng.standard_normal((b, n, h, w)).astype(np.float32))
    shifts = np.linspace(-3.3, 17.9, n)
    got = hshift_planes(x, torch.from_numpy(shifts))
    for i in range(n):
        torch.testing.assert_close(got[:, i], hshift(x[:, i], float(shifts[i])), rtol=1e-5, atol=1e-6)
    # an image broadcast over planes, sampled on its own plane axis
    img = x[:, :3]
    got_img = hshift_planes(img[:, :, None], torch.from_numpy(shifts), plane_dim=2)
    for i in range(n):
        torch.testing.assert_close(got_img[:, :, i], hshift(img, float(shifts[i])), rtol=1e-5, atol=1e-6)


def test_hflip_is_exact_mirror(rng):
    x = rng.standard_normal((1, 3, 5, 16)).astype(np.float32)
    t = torch.from_numpy(x)
    theta = torch.zeros(1, 2, 3)
    theta[:, 0, 0] = 1
    theta[:, 1, 1] = 1
    for ac in (True, False):
        grid = F.affine_grid(theta, [1, 3, 5, 16], align_corners=ac).clone()
        grid[:, :, :, 0] = -grid[:, :, :, 0]
        want = F.grid_sample(t, grid, align_corners=ac).numpy()
        np.testing.assert_allclose(hflip(t).numpy(), want, rtol=1e-5, atol=1e-5)

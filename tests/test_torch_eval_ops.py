"""The port's evaluation building blocks vs the JAX package on the same
seeded numpy inputs: resizes at KITTI's evaluation ratios, the FAL_netA
maskR quirk sampler, flip and multi-scale post-processing (on the tiny model
with the same weights), the per-image percentile, the depth and image
metrics, the EPE losses, the exporters (the plasma PNG against matplotlib's
``plt.imsave``) and the meters.

Tolerances, stated per test: nearest resizes, the numpy metrics and the
exporters are the same arithmetic and compare exactly (or to 1e-12 where
numpy's reduction order may differ); bilinear resizes 1e-3 (see the test);
the quirk
sampler 1e-5 and its maskR 1e-4 (fp32 plane levels vs the port's float64
levels rounded once); whole-model post-processing rtol 1e-3 / atol 5e-3 as
tests/test_models.py:93 (fp32 conv summation order, XLA vs oneDNN).
"""

import torch_lane  # noqa: F401  (torch's threads sized to the xdist worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fal_net_tpu.eval import export as jexport
from fal_net_tpu.eval import metrics as jmetrics
from fal_net_tpu.eval.postprocess import flip_post_process as jax_flip_pp
from fal_net_tpu.eval.postprocess import ms_post_process as jax_ms_pp
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.ops.med import disparity_levels as jax_levels
from fal_net_tpu.ops.med import med_outputs as jax_med_outputs
from fal_net_tpu.ops.resize import resize_bilinear_align_corners as jax_bilinear
from fal_net_tpu.ops.resize import resize_nearest_torch as jax_nearest
from fal_net_tpu.ops.shift import hshift_planes_quirk as jax_quirk
from fal_net_tpu.utils.meters import MultiAverageMeter as JaxMultiAverageMeter
from fal_net_tpu.utils.viz import local_normalization as jax_local_normalization
from fal_net_torch.eval import export, metrics
from fal_net_torch.eval.postprocess import flip_post_process, ms_post_process, percentile95
from fal_net_torch.models import create_model
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.ops.med import disparity_levels, med_outputs
from fal_net_torch.ops.resize import resize_bilinear_align_corners, resize_nearest_torch
from fal_net_torch.ops.shift import hshift_planes_quirk
from fal_net_torch.utils.meters import MultiAverageMeter, count_params
from fal_net_torch.utils.viz import local_normalization

# the EPE modules (each package's losses/__init__ exports a function of the same name)
jepe = importlib.import_module("fal_net_tpu.losses.epe")
epe = importlib.import_module("fal_net_torch.losses.epe")

# KITTI's image sizes and their 2/3 shapes (the multi-scale post-process)
KITTI_RATIOS = [((375, 1242), (250, 828)), ((370, 1224), (246, 816)), ((376, 1241), (250, 827))]
RESIZES = [(a, b) for a, b in KITTI_RATIOS] + [(b, a) for a, b in KITTI_RATIOS]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_nearest_matches_jax(src, dst):
    """Exact: both take floor(dst * float32(in / out)); a float64 scale
    would move an index of 246 -> 370."""
    x = np.arange(src[0] * src[1], dtype=np.float32).reshape(1, src[0], src[1], 1)
    got = resize_nearest_torch(nchw(x), dst)
    np.testing.assert_array_equal(nhwc(got), np.asarray(jax_nearest(jnp.asarray(x), dst)))


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bilinear_matches_jax(rng, src, dst):
    """atol 1e-3 on unit-normal noise: torch (the semantics) takes the
    source position dst * (in-1)/(out-1) in fp32, the JAX package in
    float64; at 1,242 columns they differ by up to ~1e-4 px, times noise's
    neighbour differences of up to ~5."""
    x = rng.standard_normal((1, src[0], src[1], 2)).astype(np.float32)
    got = resize_bilinear_align_corners(nchw(x), dst)
    np.testing.assert_allclose(nhwc(got), np.asarray(jax_bilinear(jnp.asarray(x), dst)), rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,w", [(5, 33), (12, 64)])
def test_hshift_planes_quirk_matches_jax(rng, h, w):
    lev = np.float32([0.3, 2.0, 7.5, 31.0, -1.2])
    x = rng.standard_normal((2, 5, h, w)).astype(np.float32)
    got = hshift_planes_quirk(torch.from_numpy(x), torch.from_numpy(lev))
    want = jax_quirk(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(lev), axis=-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bounds", [(2.0, 30.0), ([2.0, 1.0], [30.0, 20.0])])
def test_med_outputs_maskr_quirk_matches_jax(rng, bounds):
    mn, mx = bounds
    logits = rng.standard_normal((2, 9, 6, 40)).astype(np.float32)
    image = rng.standard_normal((2, 3, 6, 40)).astype(np.float32)
    as_t = lambda v: torch.tensor(v) if isinstance(v, list) else v
    got = med_outputs(torch.from_numpy(logits), torch.from_numpy(image), as_t(mn), as_t(mx), ret_disp=True,
                      ret_pan=True, ret_subocc=True, maskr_quirk=True)
    as_j = lambda v: jnp.asarray(v, jnp.float32) if isinstance(v, list) else v
    want = jax_med_outputs(jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(image.transpose(0, 2, 3, 1)),
                           as_j(mn), as_j(mx), ret_disp=True, ret_pan=True, ret_subocc=True, maskr_quirk=True)
    for name in ("disp", "pan", "maskL", "maskR"):
        np.testing.assert_allclose(nhwc(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    plain = med_outputs(torch.from_numpy(logits), torch.from_numpy(image), as_t(mn), as_t(mx), ret_subocc=True)
    assert not torch.allclose(plain.maskR, got.maskR, atol=1e-3)  # the quirk changes maskR


def test_quirk_levels_are_the_plane_levels():
    np.testing.assert_allclose(disparity_levels(2.0, 300.0, 49).numpy(), np.asarray(jax_levels(2.0, 300.0, 49)),
                               rtol=1e-6)


def test_percentile95_matches_jnp_with_ties(rng):
    """Per-image 95th percentile, linear rule, on disparities with ties
    (quarter-pixel steps) and with an image whose values are all equal."""
    d = np.round(rng.random((3, 1, 37, 53)) * 40 * 4).astype(np.float32) / 4
    d[2] = 7.25
    want = np.asarray(jnp.percentile(jnp.asarray(d.transpose(0, 2, 3, 1)), 95, axis=(1, 2, 3), keepdims=True))
    got = percentile95(torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy().reshape(-1), want.reshape(-1), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy().reshape(-1), np.percentile(d.reshape(3, -1), 95, axis=1), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny model, N = 5, in both packages with the same weights."""
    jax_model = jax_create_model("tiny", 5, med_impl="reference")
    variables = jax_model.init(jax.random.PRNGKey(3), jnp.zeros((1, 75, 250, 3)), 2.0, 30.0, ret_disp=True)
    port = create_model("tiny", 5, device="cpu")
    port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], "tiny").items()}
    )
    return jax_model, variables, port.eval()


@pytest.mark.parametrize("kind", ["flip", "ms"])
def test_post_process_on_the_tiny_model_matches_jax(tiny_pair, kind):
    """75x250 (a 2/3 shape of 50x166; odd heights take the decoder's non-2x
    upsample), two different images in one batch."""
    jax_model, variables, port = tiny_pair
    x = (np.random.default_rng(5).standard_normal((2, 75, 250, 3)) * 0.3).astype(np.float32)
    jfn = lambda im: jax_model.apply(variables, im, 2.0, 30.0, ret_disp=True).disp
    jx = jnp.asarray(x)
    want = (jax_flip_pp if kind == "flip" else jax_ms_pp)(jx, jfn, jfn(jx))
    tfn = lambda im: port(im.contiguous(), 2.0, 30.0, ret_disp=True).disp
    with torch.no_grad():
        tx = nchw(x)
        got = (flip_post_process if kind == "flip" else ms_post_process)(tx, tfn, tfn(tx))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-3, atol=5e-3)


def test_maskr_quirk_model_matches_jax(tiny_pair):
    """FalNet(a_maskr_quirk=True): the plain head with the quirk sampler,
    as the JAX model's a_maskr_quirk."""
    jax_model, variables, port = tiny_pair
    quirk = create_model("tiny", 5, device="cpu", a_maskr_quirk=True)
    quirk.load_state_dict(port.state_dict())
    x = (np.random.default_rng(6).standard_normal((1, 32, 64, 3)) * 0.3).astype(np.float32)
    jq = jax_create_model("tiny", 5, med_impl="reference", a_maskr_quirk=True)
    want = jq.apply(variables, jnp.asarray(x), 2.0, 30.0, ret_disp=True, ret_subocc=True)
    with torch.no_grad():
        got = quirk(nchw(x), 2.0, 30.0, ret_disp=True, ret_subocc=True)
    for name in ("disp", "maskL", "maskR"):
        np.testing.assert_allclose(nhwc(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-3, atol=5e-3,
                                   err_msg=name)


def test_maskr_quirk_keeps_the_kernel_but_for_maskr(tiny_pair, monkeypatch):
    """FalNet(a_maskr_quirk=True, med_impl="fused"): one kernel call with
    the masks requested gives disp, pan and maskL, and maskR alone comes from
    the plain quirk sampler, replacing the kernel's.  The CUDA kernel cannot
    run on the CPU, so the plain head (without the quirk) stands in for it
    here; the result equals the JAX model's a_maskr_quirk at the tolerance
    of the test above."""
    from fal_net_torch.models import falnet

    jax_model, variables, port = tiny_pair
    calls = []

    def kernel_stand_in(*args, **kw):
        calls.append(kw)
        out = med_outputs(*args, **kw)
        calls.append(out.maskR)
        return out

    monkeypatch.setattr(falnet, "med_outputs_fused", kernel_stand_in)
    quirk = create_model("tiny", 5, device="cpu", med_impl="fused", a_maskr_quirk=True)
    quirk.load_state_dict(port.state_dict())
    x = (np.random.default_rng(7).standard_normal((2, 32, 64, 3)) * 0.3).astype(np.float32)
    jq = jax_create_model("tiny", 5, med_impl="reference", a_maskr_quirk=True)
    want = jq.apply(variables, jnp.asarray(x), 2.0, 30.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    with torch.no_grad():
        got = quirk(nchw(x), 2.0, 30.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    assert calls[0] == dict(ret_disp=True, ret_pan=True, ret_subocc=True)
    assert not torch.allclose(calls[1], got.maskR, atol=1e-3)  # the kernel's maskR was replaced
    for name in ("disp", "pan", "maskL", "maskR"):
        np.testing.assert_allclose(nhwc(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-3, atol=5e-3,
                                   err_msg=name)


# ---- metrics ----

def _depths(rng, h=240, w=1242):
    gt = (rng.random((h, w)) * 90).astype(np.float32)
    gt[rng.random((h, w)) < 0.6] = 0
    pred = (rng.random((h, w)) * 90 + 0.5).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("use_median", [False, True])
def test_kitti_errors_match_jax(rng, use_median):
    gt, pred = _depths(rng)
    s_got, s_want = [], []
    got = metrics.compute_kitti_errors(gt, pred, use_median=use_median, scale_out=s_got)
    want = jmetrics.compute_kitti_errors(gt, pred, use_median=use_median, scale_out=s_want)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert s_got == s_want and len(s_got) == int(use_median)


@pytest.mark.parametrize("width", [1242, 1241, 1224, 1238, 1226])
def test_depth_conversions_match_jax(rng, width):
    gt, disp = _depths(rng, 250, width)
    for fn in ("disps_to_depths_kitti", "disps_to_depths_kitti2015", "disps_to_depths_make"):
        g, p = getattr(metrics, fn)(gt[None], disp[None])
        jg, jp = getattr(jmetrics, fn)(gt[None], disp[None])
        np.testing.assert_array_equal(g[0], jg[0], err_msg=fn)
        np.testing.assert_array_equal(p[0], jp[0], err_msg=fn)
    g, p = metrics.disps_to_depths_make(gt[None], disp[None])
    np.testing.assert_allclose(metrics.compute_make_errors(g[0], p[0]), jmetrics.compute_make_errors(g[0], p[0]),
                               rtol=1e-12)
    assert metrics.KITTI_ERROR_NAMES == jmetrics.KITTI_ERROR_NAMES
    assert (metrics.WIDTH_TO_FOCAL, metrics.WIDTH_TO_BASELINE, metrics.GARG_CROP) == (
        jmetrics.WIDTH_TO_FOCAL, jmetrics.WIDTH_TO_BASELINE, jmetrics.GARG_CROP)


def test_image_metrics_match_jax(rng):
    out = (rng.standard_normal((2, 9, 13, 3)) * 0.3).astype(np.float32)
    lab = (rng.standard_normal((2, 9, 13, 3)) * 0.3).astype(np.float32)
    for name in ("image_rmse", "image_mae", "image_psnr"):
        got = float(getattr(metrics, name)(nchw(out), nchw(lab)))
        want = float(getattr(jmetrics, name)(jnp.asarray(out), jnp.asarray(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


# ---- EPE ----

@pytest.mark.parametrize("sparse", [False, True])
def test_epe_and_real_epe_match_jax(rng, sparse):
    pred = (rng.random((2, 13, 21, 2)) * 20).astype(np.float32)
    target = (rng.random((2, 26, 42, 2)) * 20).astype(np.float32)
    target[target < 8] = 0
    for mean in (True, False):
        got = float(epe.epe(nchw(pred), nchw(target[:, ::2, ::2]), sparse=sparse, mean=mean))
        want = float(jepe.epe(jnp.asarray(pred), jnp.asarray(target[:, ::2, ::2]), sparse=sparse, mean=mean))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = float(epe.real_epe(nchw(pred), nchw(target), sparse=sparse))
    want = float(jepe.real_epe(jnp.asarray(pred), jnp.asarray(target), sparse=sparse))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    p1, t1 = pred[0, ..., 0], target[0, ::2, ::2, 0]
    assert epe.real_epe_np(p1, t1) == jepe.real_epe_np(p1, t1)


@pytest.mark.parametrize("sparse", [False, True])
def test_multiscale_epe_and_sparse_max_pool_match_jax(rng, sparse):
    target = (rng.standard_normal((2, 30, 44, 1)) * 10).astype(np.float32)
    target[np.abs(target) < 6] = 0
    outs = [(rng.standard_normal((2, 30 // k, 44 // k, 1)) * 10).astype(np.float32) for k in (1, 2, 3)]
    w = [0.5, 0.3, 0.2]
    got = float(epe.multiscale_epe([nchw(o) for o in outs], nchw(target), w, sparse=sparse))
    want = float(jepe.multiscale_epe([jnp.asarray(o) for o in outs], jnp.asarray(target), w, sparse=sparse))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(nhwc(epe.sparse_max_pool(nchw(target), (7, 9))),
                                  np.asarray(jepe.sparse_max_pool(jnp.asarray(target), (7, 9))))


# ---- exporters, viz, meters ----

def test_plasma_png_matches_plt_imsave(rng, tmp_path):
    plt = pytest.importorskip("matplotlib.pyplot", reason="the reference PNG is drawn by matplotlib")
    disp = (rng.random((37, 61)) * 80).astype(np.float32)
    disp[:3] = 500.0  # above the 95th percentile: the colour map's top entry
    export.save_disparity_png(str(tmp_path / "port.png"), disp)
    jexport.save_disparity_png(str(tmp_path / "jax.png"), disp)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape == want.shape == (37, 61, 4)
    np.testing.assert_array_equal(got, want)
    table = plt.get_cmap("plasma")(np.arange(256), bytes=True)
    np.testing.assert_array_equal(export.PLASMA_RGB, table[:, :3])


def test_image_feature_and_point_cloud_exports_match_jax(rng, tmp_path):
    img = (rng.standard_normal((9, 1242, 3)) * 0.3).astype(np.float32)
    disp = (rng.random((9, 1242)) * 60 + 1).astype(np.float32)
    for mod, tag in ((export, "port"), (jexport, "jax")):
        mod.save_image_png(str(tmp_path / f"{tag}_img.png"), img)
        mod.save_feature_pngs(str(tmp_path / tag), "f", img[..., :2])
        mod.save_point_cloud_ply(str(tmp_path / f"{tag}.ply"), mod.disparity_to_point_cloud(img * 255, disp))
    read = lambda p: np.asarray(Image.open(p))
    np.testing.assert_array_equal(read(tmp_path / "port_img.png"), read(tmp_path / "jax_img.png"))
    for c in range(2):
        np.testing.assert_array_equal(read(tmp_path / "port" / f"f_c{c}.png"), read(tmp_path / "jax" / f"f_c{c}.png"))
    assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()


def test_local_normalization_and_meters_match_jax(rng):
    img = (rng.standard_normal((11, 17, 3)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(local_normalization(img), jax_local_normalization(img), rtol=1e-6, atol=1e-6)
    got, want = MultiAverageMeter(["a", "b"]), JaxMultiAverageMeter(["a", "b"])
    for vals, n in (([1.0, 2.0], 1), ([3.0, 5.0], 3)):
        got.update(vals, n)
        want.update(vals, n)
    np.testing.assert_array_equal(got.avg, want.avg)
    assert repr(got) == repr(want)
    model = create_model("tiny", 5, device="cpu")
    assert count_params(model) == sum(p.numel() for p in model.parameters()) > 0

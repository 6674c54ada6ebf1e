"""The port's native image IO (fal_net_torch/native: its own copy of the
C++ decoder, built into the port's build directory) against the JAX
package's and PIL: 8-bit RGB, gray, RGBA and palette PNGs, 16-bit gray and
RGB PNGs, JPEG, corrupt input and a batch with a bad index; the numpy
16-bit PNG codec the port falls back to where the library does not build;
the KITTI flow loader against JAX's; and cli.infer's disparity PNG, the
same uint16 values whichever encoder writes it.  Pixels compare exactly.
"""

import torch_lane  # noqa: F401  (torch's threads sized to the xdist worker)
import io as _io
import os

import numpy as np
import pytest
from PIL import Image

from fal_net_tpu.data.datasets import load_kitti_flow_png as jax_load_flow
from fal_net_tpu.native import io as jax_nio
from fal_net_torch.cli import infer
from fal_net_torch.data import datasets
from fal_net_torch.native import build, png16
from fal_net_torch.native import io as nio

pytestmark = pytest.mark.skipif(not nio.available(), reason="the native IO library did not build")


def _png(arr, fmt="PNG", **kw):
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


def _palette_png(rng):
    pal = Image.fromarray(rng.integers(0, 256, (16, 17, 3), dtype=np.uint8)).quantize(colors=64)
    buf = _io.BytesIO()
    pal.save(buf, "PNG")
    return buf.getvalue()


def _cases(rng):
    """(name, encoded bytes, the pixels PIL or the writer says they hold)."""
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (41, 29), dtype=np.uint8)
    rgba = rng.integers(0, 256, (11, 13, 4), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (23, 31), dtype=np.uint16)
    rgb16 = rng.integers(0, 65536, (19, 27, 3), dtype=np.uint16)
    pal = _palette_png(rng)
    jpg = _png(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), fmt="JPEG", quality=90)
    jpg_gray = _png(rng.integers(0, 256, (32, 40), dtype=np.uint8), fmt="JPEG", quality=95)
    return [
        ("rgb8", _png(rgb), rgb),
        ("gray8", _png(gray), gray),
        ("rgba8", _png(rgba), rgba),
        ("palette", pal, np.asarray(Image.open(_io.BytesIO(pal)).convert("RGB"))),
        ("gray16", _png(g16), g16),
        ("rgb16", jax_nio.encode_png16(rgb16), rgb16),
        ("jpeg", jpg, np.asarray(Image.open(_io.BytesIO(jpg)))),
        ("jpeg gray", jpg_gray, np.asarray(Image.open(_io.BytesIO(jpg_gray)))),
    ]


def test_decode_matches_jax_and_pil(rng):
    cases = _cases(rng)
    for name, buf, want in cases:
        got = nio.decode(buf)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, jax_nio.decode(buf), err_msg=name)
    outs = nio.decode_batch([buf for _, buf, _ in cases], nthreads=4)
    for (name, _, want), got in zip(cases, outs):
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert nio.decode_batch([]) == []


def test_corrupt_input_and_bad_batch_index_raise():
    for bad in (b"\x89PNG\r\n\x1a\n" + b"garbage" * 10, b"not an image at all"):
        with pytest.raises(ValueError):
            nio.decode(bad)
    good = _png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):  # fails its probe
        nio.decode_batch([good, b"broken bytes"])
    cut = _png(np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8))[:200]
    with pytest.raises(ValueError, match=r"indices \[1\]"):  # probes, then fails to decode
        nio.decode_batch([good, cut, good])
    with pytest.raises(ValueError):
        nio.encode_png16(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        nio.encode_png16(np.zeros((4, 4, 2), np.uint16))


@pytest.mark.parametrize("shape", [(21, 33), (19, 27, 3), (8, 9, 1)])
def test_png16_roundtrip_on_both_codecs(tmp_path, rng, shape):
    """The native encoder and the numpy fallback write the same uint16
    pixels (their row filters differ), and each reads the other's file."""
    a = rng.integers(0, 65536, shape, dtype=np.uint16)
    want = a[..., 0] if shape[-1] == 1 else a
    native, fallback = nio.encode_png16(a), png16.encode(a)
    for buf in (native, fallback, jax_nio.encode_png16(a)):
        np.testing.assert_array_equal(nio.decode(buf), want)
        np.testing.assert_array_equal(png16.decode(buf), want)
    nio.imwrite_png16(tmp_path / "a.png", a)
    np.testing.assert_array_equal(nio.imread(tmp_path / "a.png"), want)
    np.testing.assert_array_equal(nio.imread_batch([tmp_path / "a.png"] * 2)[1], want)
    if len(shape) == 2:  # PIL reads 16-bit gray right (its downcast is RGB-only)
        np.testing.assert_array_equal(np.asarray(Image.open(_io.BytesIO(fallback)), np.uint16), a)


def test_png16_fallback_filters_and_errors(rng):
    """Every row filter libpng and PIL choose (a smooth image draws Sub,
    Up, Average and Paeth), 8-bit and truncated input raise."""
    yy, xx = np.mgrid[0:40, 0:60]
    smooth = (np.stack([xx * 500 + yy * 30, yy * 700, xx * yy], -1) % 65536).astype(np.uint16)
    np.testing.assert_array_equal(png16.decode(nio.encode_png16(smooth)), smooth)
    np.testing.assert_array_equal(png16.decode(_png(smooth[..., 0])), smooth[..., 0])
    with pytest.raises(ValueError, match="16-bit"):
        png16.decode(_png(smooth.astype(np.uint8)))
    with pytest.raises(ValueError):
        png16.decode(nio.encode_png16(smooth)[:-40])
    with pytest.raises(ValueError):
        png16.decode(b"not a png")


def _no_native(monkeypatch):
    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_load_failed", True)


def test_flow_loader_matches_jax_either_way(tmp_path, monkeypatch):
    """KITTI's flow encoding (R = u*64 + 2^15, G = v*64 + 2^15, B = valid),
    read by the native decoder and by the numpy fallback, equals JAX's
    loader; an 8-bit PNG raises on both paths."""
    u = np.array([[1.0, -2.5, 7.0], [0.25, 300.0, -0.5]], np.float32)
    v = np.array([[-1.0, 0.5, 2.0], [10.0, -300.0, 1.5]], np.float32)
    valid = np.array([[1, 1, 0], [0, 1, 1]], np.float32)
    raw = np.stack([u * 64 + 2.0**15, v * 64 + 2.0**15, valid], axis=-1).astype(np.uint16)
    p = str(tmp_path / "flow.png")
    nio.imwrite_png16(p, raw)
    eight = tmp_path / "not_flow.png"
    eight.write_bytes(_png(np.zeros((4, 4, 3), np.uint8)))
    want = jax_load_flow(p)
    np.testing.assert_array_equal(want[..., 0], u * valid)
    for fallback in (False, True):
        if fallback:
            _no_native(monkeypatch)
            assert nio.decoder().startswith("PIL")
        got = datasets.load_kitti_flow_png(p)
        assert got.dtype == np.float32 and got.shape == (2, 3, 3)
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="flow"):
            datasets.load_kitti_flow_png(str(eight))


def test_imread_native_pil_fallback_and_cmyk(tmp_path, monkeypatch, rng):
    a = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    p = tmp_path / "img.png"
    p.write_bytes(_png(a))
    assert nio.decoder() == "native"
    np.testing.assert_array_equal(datasets._imread(str(p)), a)
    cmyk = tmp_path / "cmyk.jpg"  # libjpeg does not convert CMYK: PIL reads this one
    Image.new("CMYK", (20, 10), (10, 20, 30, 40)).save(cmyk, "JPEG")
    assert datasets._imread(str(cmyk)).shape[:2] == (10, 20)
    _no_native(monkeypatch)
    np.testing.assert_array_equal(datasets._imread(str(p)), a)


def test_infer_disparity_png_same_values_either_way(tmp_path, monkeypatch, rng):
    """cli.infer's uint16 disparity PNG holds the same values written by the
    native encoder or by PIL, and PIL and both decoders read them back."""
    disp = (rng.random((13, 17)) * 300).astype(np.float32)
    want = np.clip(disp.astype(np.float64) * 256, 0, 65535).astype(np.uint16)
    infer.save_disp16(str(tmp_path / "native.png"), disp)
    _no_native(monkeypatch)
    infer.save_disp16(str(tmp_path / "pil.png"), disp)
    monkeypatch.undo()
    for name in ("native.png", "pil.png"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(np.asarray(Image.open(path), np.uint16), want)
        np.testing.assert_array_equal(nio.imread(path), want)
        np.testing.assert_array_equal(jax_nio.imread(path), want)


def test_library_goes_to_the_port_build_dir(monkeypatch, tmp_path):
    from fal_net_torch.ops import _build

    assert os.path.dirname(build.lib_path()) == _build.build_dir()
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "b"))
    assert os.path.dirname(build.lib_path()) == str(tmp_path / "b")
    assert os.path.isfile(build.build())  # a fresh directory builds from the source

"""The port's serving path vs the JAX package: DisparityPipeline on the same
weights and images, and the inference CLI on a .pt checkpoint.

Disparities compare at rtol 1e-3 / atol 5e-3 (fp32 conv summation order,
XLA vs oneDNN, as tests/test_models.py:93); the 16-bit path adds one
quantization step of 1/256 px, since a value near a rounding boundary may
land on either side.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fal_net_tpu.eval.pipeline import DisparityPipeline as JaxDisparityPipeline
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_torch.cli import infer
from fal_net_torch.data.transforms import RGB_MEAN, normalize, normalize_device
from fal_net_torch.eval.pipeline import DisparityPipeline
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import load_checkpoint, save_checkpoint
from fal_net_torch.models.jax_import import state_dict_from_jax

H, W, N = 32, 64, 5


@pytest.fixture(scope="module")
def models():
    jax_model = jax_create_model("tiny", N, med_impl="reference")
    variables = jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), 2.0, 30.0, ret_disp=True
    )
    port = create_model("tiny", N, device="cpu")
    port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], "tiny").items()}
    )
    return jax_model, variables, port


def _raw_images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"img{i:02d}", (rng.random((H, W, 3)) * 255).astype(np.uint8)) for i in range(n)]


@pytest.mark.parametrize(
    "device_normalize,quantize_uint16", [(False, False), (True, False), (True, True)]
)
def test_pipeline_matches_jax(models, device_normalize, quantize_uint16):
    """Ragged tail (5 images, batch 2), host-normalized floats or raw uint8
    with on-device normalization, fp32 or 16-bit fetch."""
    jax_model, variables, port = models
    raw = _raw_images(5)
    items = raw if device_normalize else [(k, normalize(v)) for k, v in raw]
    kw = dict(batch_size=2, max_disp=30.0, device_normalize=device_normalize,
              quantize_uint16=quantize_uint16)
    want = dict(JaxDisparityPipeline(jax_model, variables, **kw).run(iter(items)))
    got = list(DisparityPipeline(port, **kw).run(iter(items)))
    assert [name for name, _ in got] == [name for name, _ in raw]
    atol = 5e-3 + (1 / 256 if quantize_uint16 else 0)
    for name, disp in got:
        assert disp.shape == (H, W) and disp.dtype == np.float32
        np.testing.assert_allclose(disp, want[name], rtol=1e-3, atol=atol, err_msg=name)


def test_pipeline_rejects_floats_with_device_normalize(models):
    pipe = DisparityPipeline(models[2], batch_size=2, device_normalize=True)
    with pytest.raises(TypeError, match="expects uint8"):
        list(pipe.run(iter([("x", np.zeros((H, W, 3), np.float32))])))


def test_normalize_device_matches_host():
    img = _raw_images(1)[0][1]
    dev = normalize_device(torch.from_numpy(img).permute(2, 0, 1)[None])[0].permute(1, 2, 0)
    np.testing.assert_allclose(dev.numpy(), normalize(img), rtol=0, atol=1e-7)
    assert RGB_MEAN.dtype == np.float32


def test_infer_cli_writes_one_png_per_image(models, tmp_path):
    _, _, port = models
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, port)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    sizes = {"a": (H, W), "b": (H, W), "c": (40, 96)}  # c is resized and restored
    for i, (stem, hw) in enumerate(sizes.items()):
        arr = (np.random.default_rng(i).random(hw + (3,)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{stem}.png")
    out_dir = tmp_path / "out"
    n = infer.main([
        "--pretrained", ckpt, "--images", str(img_dir), "--out_dir", str(out_dir),
        "--height", str(H), "--width", str(W), "--batch_size", "2",
        "--max_disp", "30", "--device", "cpu",
    ])
    assert n == 3
    assert sorted(os.listdir(out_dir)) == [f"{s}_disp.png" for s in sizes]
    for stem, hw in sizes.items():
        disp = np.asarray(Image.open(out_dir / f"{stem}_disp.png")).astype(np.float64) / 256
        assert disp.shape == hw
        scale = hw[1] / W  # disparity rescales with the width ratio
        assert disp.min() >= (2.0 - 1e-2) * scale and disp.max() <= (30.0 + 1e-2) * scale

    # The CLI's disparity for an image at the model size is the pipeline's,
    # floor-quantized to 1/256 px; a batch of another size sums in another
    # order, so a value at a step boundary may land one step off.
    img = np.asarray(Image.open(img_dir / "a.png"))
    want = dict(DisparityPipeline(port, batch_size=1, max_disp=30.0, device_normalize=True).run(
        iter([("a", img)])
    ))["a"]
    got = np.asarray(Image.open(out_dir / "a_disp.png")).astype(np.float64) / 256
    np.testing.assert_allclose(got, np.floor(want * 256) / 256, rtol=0, atol=1 / 256 + 1e-9)


def test_load_reference_style_checkpoint(models, tmp_path):
    """A reference .pth.tar: DataParallel ``module.`` keys, epoch and name
    fields; the variant comes from the backbone key, N from conv0."""
    port = models[2]
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save(
        {"epoch": 3, "m_model": "FAL_netB",
         "state_dict": {f"module.{k}": v for k, v in port.state_dict().items()}},
        path,
    )
    model = load_checkpoint(path, device="cpu")
    assert model.spec.name == "tiny" and model.num_levels == N
    for k, v in port.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)

"""The port's stage-1 training slice vs the JAX package: losses, the stage-1
loss and its parameter gradients, Adam with its schedule, the data path and
the training CLI.

Tolerances: the losses compare at rtol 1e-5 (fp32, the same expressions);
the stage-1 loss at rtol 1e-5 and each parameter gradient within 1e-4 of
that tensor's largest magnitude (measured: 6e-6; fp32 conv summation order,
XLA vs oneDNN); Adam steps fed the same gradients at rtol 1e-6; the data
path exactly.
"""

from torch_lane import default_threads, nchw  # noqa: F401  (default_threads: a fixture)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fal_net_tpu.data.datasets import kitti_train as jax_kitti_train
from fal_net_tpu.data.loader import DataLoader as JaxDataLoader
from fal_net_tpu.data.transforms import default_train_transform as jax_default_train_transform
from fal_net_tpu.losses.photometric import rec_loss as jax_rec_loss
from fal_net_tpu.losses.smoothness import smoothness as jax_smoothness
from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_tpu.train.stages import stage1_loss as jax_stage1_loss
from fal_net_tpu.train.state import create_train_state, make_lr_schedule
from fal_net_torch.cli import train as train_cli
from fal_net_torch.data.datasets import kitti_train
from fal_net_torch.data.lists import bundled_list_lines
from fal_net_torch.data.loader import DataLoader, to_device
from fal_net_torch.data.transforms import default_train_transform
from fal_net_torch.losses.photometric import rec_loss
from fal_net_torch.losses.smoothness import smoothness
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import load_checkpoint
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.train.stages import stage1_loss
from fal_net_torch.train.state import create_optimizer

H, W, N, B = 32, 64, 5, 2
A_SM = 0.2 * 2 / 512


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model in plain form and its variables."""
    jax_model = jax_create_model(
        "tiny", N, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
        stem_flow_analytic=False, fuse_logits=False, phase_deconv=False,
    )
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), 2.0, 30.0, ret_disp=True)
    return jax_model, variables


def _port_model(variables):
    port = create_model("tiny", N, med_impl="reference", device="cpu")
    sd = state_dict_from_jax(variables["params"], "tiny")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port


def test_rec_loss_and_smoothness_match_jax(rng):
    draw = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    synth, label, img = draw(B, H, W, 3), draw(B, H, W, 3), draw(B, H, W, 3)
    disp = np.abs(draw(B, H, W, 1)) * 50
    mask = rng.random((B, H, W, 1)).astype(np.float32)
    for m_np in (1.0, mask):
        m_t = m_np if isinstance(m_np, float) else torch.from_numpy(nchw(m_np))
        got = rec_loss(m_t, torch.from_numpy(nchw(synth)), torch.from_numpy(nchw(label)), None, 0.0)
        want = jax_rec_loss(m_np, jnp.asarray(synth), jnp.asarray(label), None, 0.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for x0 in (0, int(0.2 * W)):
        got = smoothness(torch.from_numpy(nchw(img))[..., x0:], torch.from_numpy(nchw(disp))[..., x0:], gamma=2.0)
        want = jax_smoothness(jnp.asarray(img)[:, :, x0:], jnp.asarray(disp)[:, :, x0:], gamma=2.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("per_sample", [False, True])
def test_stage1_loss_and_grads_match_jax(tiny, rng, per_sample):
    """Float bounds (fix_order) and per-sample max_disp, one swapped."""
    jax_model, variables = tiny
    left = (rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32)
    right = (rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32)
    jb = {"left": jnp.asarray(left), "right": jnp.asarray(right)}
    tb = {"left": torch.from_numpy(nchw(left)), "right": torch.from_numpy(nchw(right))}
    if per_sample:
        mx = np.asarray([30.0, -20.0], np.float32)
        jb["max_disp"], tb["max_disp"] = jnp.asarray(mx), torch.from_numpy(mx)
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=A_SM * 50)

    (want, want_aux), jax_grads = jax.value_and_grad(
        lambda p: jax_stage1_loss(p, jb, jax_model.apply, **kw), has_aux=True
    )(variables)
    port = _port_model(variables)
    loss, aux = stage1_loss(port, tb, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k in ("rec_loss", "sm_loss"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), rtol=1e-5)

    grads = convert_state_dict(
        {k: p.grad.numpy() for k, p in port.named_parameters()}, JAX_VARIANTS["tiny"]
    )

    def close(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=jax.tree_util.keystr(path)
        )

    assert jax.tree.structure(grads) == jax.tree.structure(jax_grads["params"])
    jax.tree_util.tree_map_with_path(close, grads, jax_grads["params"])


def test_three_adam_steps_match_jax(tiny):
    """Adam(0.5, 0.999) with weight and bias decay and a milestone at the
    third step: the same gradients give the same params as JAX's
    create_train_state."""
    jax_model, variables = tiny
    hp = dict(lr=1e-3, beta1=0.5, beta2=0.999, milestones=(2,), lr_gamma=0.5,
              steps_per_epoch=1, weight_decay=0.01, bias_decay=0.1)
    state = create_train_state(jax_model, variables, **hp)
    port = _port_model(variables)
    opt, sched = create_optimizer(port, **hp)
    rng = np.random.default_rng(1)
    params = dict(port.named_parameters())
    for _ in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), variables["params"])
        state = state.apply_gradients({"params": g})
        for k, v in state_dict_from_jax(g, "tiny").items():
            params[k].grad = torch.from_numpy(v)
        opt.step()
        sched.step()
    got = convert_state_dict({k: p.detach().numpy() for k, p in params.items()}, JAX_VARIANTS["tiny"])
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7),
        got, state.params["params"],
    )


@pytest.mark.parametrize("start_step", [0, 3, 7])
def test_schedule_and_start_step_match_jax(start_step):
    """The per-step learning rate, shifted by a warm start's steps."""
    spe, milestones = 2, (2, 4)
    want = make_lr_schedule(1e-4, milestones, 0.5, spe)
    opt, sched = create_optimizer(
        torch.nn.Linear(1, 1), lr=1e-4, beta1=0.5, beta2=0.999, milestones=milestones,
        lr_gamma=0.5, steps_per_epoch=spe, start_step=start_step,
    )
    for k in range(10):
        for group in opt.param_groups:
            np.testing.assert_allclose(group["lr"], float(want(k + start_step)), rtol=1e-6)
        opt.step()
        sched.step()


def _write_tree(root, n_pairs=6, hw=(40, 120), seed=0):
    """A synthetic KITTI-raw tree and its list file (Eigen-style lines)."""
    rng = np.random.default_rng(seed)
    lines = []
    stem = "2011_09_26/2011_09_26_drive_0001_sync"
    for i in range(n_pairs):
        for cam in ("image_02", "image_03"):
            d = os.path.join(root, stem, cam, "data")
            os.makedirs(d, exist_ok=True)
            img = (rng.random(hw + (3,)) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{i:010d}.png"))
        lines.append(f"{stem}/image_02/data/{i:010d}.png {stem}/image_03/data/{i:010d}.png")
    with open(os.path.join(root, "kitti_eigen_train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("fix", [True, False])
def test_data_path_identical_to_jax(tmp_path, fix):
    """The co-transforms, StereoTrainDataset.get and the loader's first
    batch equal JAX's bit for bit for the same seed."""
    root = _write_tree(tmp_path)
    crop = (32, 64)
    kw = dict(split=1, max_pix=300.0, fix=fix, lists_dir=root)
    ds, _ = kitti_train(root, co_transform=default_train_transform(crop), **kw)
    jds, _ = jax_kitti_train(root, co_transform=jax_default_train_transform(crop), **kw)
    assert ds.pairs == jds.pairs and len(ds) == 6
    for i in range(len(ds)):
        got = ds.get(i, np.random.default_rng((3, i)))
        want = jds.get(i, np.random.default_rng((3, i)))
        assert got.keys() == want.keys()
        for k in ("left", "right", "max_disp"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} of item {i}")
        assert got["name"] == want["name"]
    batch = next(iter(DataLoader(ds, batch_size=4, num_workers=2, seed=5)))
    jbatch = next(iter(JaxDataLoader(jds, batch_size=4, num_workers=2, seed=5)))
    for k in ("left", "right", "max_disp"):
        np.testing.assert_array_equal(batch[k], jbatch[k])
    assert batch["name"] == jbatch["name"]
    dev = to_device(batch, torch.device("cpu"))
    assert dev["left"].shape == (4, 3) + crop
    np.testing.assert_array_equal(dev["left"].numpy(), batch["left"].transpose(0, 3, 1, 2))


def test_bundled_lists_match_jax():
    from fal_net_tpu.data.lists import bundled_list_lines as jax_lines

    for name in ("kitti_eigen_train.txt", "kitti_eigen_test_improved.txt", "kitti_eigen_test_original.txt"):
        assert bundled_list_lines(name) == jax_lines(name)


def test_train_cli_two_steps_on_cpu(tmp_path):
    """cli.train --device cpu: two steps of the tiny model on a synthetic
    tree, a checkpoint that load_checkpoint reads."""
    root = _write_tree(tmp_path / "data", n_pairs=4)
    result = train_cli.main([
        "--stage", "1", "--model", "tiny", "--no_levels", str(N), "--data_root", root,
        "--lists_dir", root, "--batch_size", "2", "--a_p", "0", "--epochs", "1",
        "--crop_height", str(H), "--crop_width", str(W), "--workers", "2",
        "--save_path", str(tmp_path / "runs"), "--device", "cpu", "--print_freq", "1",
    ])
    (epoch,) = result["history"]
    assert np.isfinite(epoch["loss"]) and epoch["loss"] > 0
    ckpt = os.path.join(result["save_path"], "checkpoint.pt")
    model = load_checkpoint(ckpt, device="cpu")
    assert model.spec.name == "tiny" and model.num_levels == N
    meta = torch.load(ckpt, weights_only=True)
    assert meta["epoch"] == 0 and meta["step"] == 2 and meta["m_model"] == "FAL_netTiny"
    assert os.path.isfile(os.path.join(result["save_path"], "model_best.pt"))


def test_warm_start_continues_the_schedule(tmp_path):
    """--pretrained with --start_epoch: training starts from the checkpoint
    at that epoch, and the step count goes on from it."""
    root = _write_tree(tmp_path / "data", n_pairs=4)
    common = [
        "--stage", "1", "--model", "tiny", "--no_levels", str(N), "--data_root", root,
        "--lists_dir", root, "--batch_size", "2", "--a_p", "0", "--crop_height", str(H),
        "--crop_width", str(W), "--workers", "2", "--device", "cpu",
    ]
    first = train_cli.main(common + ["--epochs", "1", "--save_path", str(tmp_path / "a")])
    ckpt = os.path.join(first["save_path"], "checkpoint.pt")
    second = train_cli.main(common + [
        "--epochs", "2", "--start_epoch", "1", "--pretrained", ckpt, "--save_path", str(tmp_path / "b"),
    ])
    assert [h["epoch"] for h in second["history"]] == [1]
    meta = torch.load(os.path.join(second["save_path"], "checkpoint.pt"), weights_only=True)
    assert meta["epoch"] == 1 and meta["step"] == 4


@pytest.mark.usefixtures("default_threads")  # one thread: 1.96 tolerance units (iconv1.weight); 2-8: 0.17-0.34
def test_grad_accum_gives_the_full_batch_gradient(tmp_path):
    """grad_accum=2 applies the mean of two half-batch gradients: the full
    batch's gradient up to fp32 summation order."""
    from fal_net_torch.train.config import Stage1Config
    from fal_net_torch.train.trainer import Trainer

    root = _write_tree(tmp_path, n_pairs=4)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy((rng.standard_normal((4, 3, H, W)) * 0.3).astype(np.float32))
             for k in ("left", "right")}
    grads = []
    for accum in (1, 2):
        cfg = Stage1Config(model="tiny", num_levels=N, data_root=root, lists_dir=root, batch_size=4,
                           crop_size=(H, W), a_p=0.0, grad_accum=accum, workers=1)
        trainer = Trainer(cfg, device="cpu")
        trainer.setup()
        trainer.train_step(batch)
        grads.append({k: p.grad.clone() for k, p in trainer.model.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-4, atol=1e-6 * float(g.abs().max()), msg=k)


def test_perceptual_term_needs_weights(tmp_path):
    """a_p > 0 without --vgg_weights raises, as in JAX (trainer.py:114-130)."""
    root = _write_tree(tmp_path, n_pairs=2)
    with pytest.raises(ValueError, match="vgg_weights"):
        train_cli.main(["--data_root", root, "--lists_dir", root, "--model", "tiny",
                        "--device", "cpu", "--a_p", "0.01"])

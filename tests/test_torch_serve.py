"""The port's serving artifacts and the CLIs around them vs the JAX package:
``fal_net_torch.serve`` against ``fal_net_tpu.serve`` (JAX's artifact
exported for the CPU) on weights carried by ``models/jax_import.py``,
``Evaluator.from_artifact`` and ``cli.test --artifact`` against JAX's on a
synthetic Eigen tree, ``cli.infer --artifact --colormap --save_pc``
against JAX's ``cli.infer``, ``cli.convert`` against JAX's, ``cli.export``
and ``cli.selfcheck`` on the CPU, and the refusals.

An artifact exported on the CPU runs the op ``fal_net_torch::med_fwd``'s
plain CPU kernel; one exported on the card runs K1 (chip_smoke.py phase
11).  Tolerances: disp and pan rtol 1e-3 / atol 5e-3 as
tests/test_torch_models.py (fp32 conv summation order, XLA vs oneDNN);
masks likewise; metrics.json at rtol 5e-4 / atol 5e-4 as
tests/test_torch_eval.py.
"""

from torch_lane import env
import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fal_net_tpu import serve as jax_serve
from fal_net_tpu.data import datasets as jds
from fal_net_tpu.eval.evaluate import EvalConfig as JaxEvalConfig
from fal_net_tpu.eval.evaluate import Evaluator as JaxEvaluator
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_torch import serve
from fal_net_torch.cli import convert as cli_convert
from fal_net_torch.cli import export as cli_export
from fal_net_torch.cli import infer as cli_infer
from fal_net_torch.cli import selfcheck as cli_selfcheck
from fal_net_torch.cli import test as cli_test
from fal_net_torch.data import datasets
from fal_net_torch.eval.evaluate import EvalConfig, Evaluator
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import save_checkpoint
from fal_net_torch.models.jax_import import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 5
H, W = 32, 64
FWD_TOL = dict(rtol=1e-3, atol=5e-3)
METRIC_TOL = dict(rtol=5e-4, atol=5e-4)
KITTI_H, KITTI_W = 48, 1242  # a width of the KITTI intrinsics table
DRIVE = "2011_09_26/2011_09_26_drive_0002_sync"


def _pair(quirk=False):
    jax_model = jax_create_model("tiny", N, a_maskr_quirk=quirk)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), 2.0, 300.0, ret_disp=True)
    port = create_model("tiny", N, device="cpu", a_maskr_quirk=quirk)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], "tiny").items()})
    return jax_model, variables, port


@pytest.fixture(scope="module")
def models():
    return _pair()


def _save(tmp_path, name, blob):
    path = str(tmp_path / name)
    serve.save_exported(path, blob)
    return path


def _inputs(uint8, b=2, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    raw = (rng.random((b, h, w, 3)) * 255).astype(np.uint8)
    return raw if uint8 else (raw / 255.0 - np.asarray([0.411, 0.432, 0.45])).astype(np.float32)


@pytest.mark.parametrize("ret_pan,ret_subocc,uint8,quirk", [
    (False, False, False, False),  # disp only
    (True, True, False, False),  # every output
    (True, False, True, False),  # uint8 input, normalized on the device
    (False, True, False, True),  # the FAL_netA maskR quirk, carried into the artifact
])
def test_artifact_matches_jax_artifact(tmp_path, models, ret_pan, ret_subocc, uint8, quirk):
    jax_model, variables, port = _pair(quirk) if quirk else models
    kw = dict(batch=2, height=H, width=W, ret_pan=ret_pan, ret_subocc=ret_subocc, uint8_input=uint8)
    got_fwd = serve.load_exported(_save(tmp_path, "port.pt2z", serve.export_forward(port, device="cpu", **kw)),
                                  device="cpu")
    jax_serve.save_exported(str(tmp_path / "jax.jaxexp"),
                            jax_serve.export_forward(jax_model, variables, platforms=("cpu",), **kw))
    want_fwd = jax_serve.load_exported(str(tmp_path / "jax.jaxexp"))
    meta_keys = ("batch", "height", "width", "min_disp", "max_disp", "outputs", "variant", "num_levels", "input",
                 "dtype", "n_params")
    assert {k: got_fwd.meta[k] for k in meta_keys} == {k: want_fwd.meta[k] for k in meta_keys}
    assert got_fwd.meta["device"] == "cpu"
    x = _inputs(uint8)
    got, want = got_fwd(x), want_fwd(x)
    assert len(got) == len(want) == len(got_fwd.meta["outputs"])
    for name, g, w in zip(got_fwd.meta["outputs"], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **FWD_TOL)
    # the artifact computes what the live model does
    left = torch.from_numpy(x).permute(0, 3, 1, 2)
    if uint8:
        left = left.float() / 255.0 - torch.tensor([0.411, 0.432, 0.45]).view(1, 3, 1, 1)
    with torch.no_grad():
        live = port(left.contiguous(), 2.0, 300.0, ret_disp=True, ret_pan=ret_pan, ret_subocc=ret_subocc)
    for name, g in zip(got_fwd.meta["outputs"], got):
        torch.testing.assert_close(g, getattr(live, name).permute(0, 2, 3, 1), rtol=1e-6, atol=1e-6)


def test_bundle_dispatches_by_shape_and_matches_jax(tmp_path, models):
    jax_model, variables, port = models
    shapes = [(H, W), (24, 48)]
    got_fwd = serve.load_exported(_save(tmp_path, "b.pt2z", serve.export_bundle(port, shapes, batch=2, device="cpu")),
                                  device="cpu")
    jax_serve.save_exported(str(tmp_path / "b.jaxexp"),
                            jax_serve.export_bundle(jax_model, variables, shapes, batch=2, platforms=("cpu",)))
    want_fwd = jax_serve.load_exported(str(tmp_path / "b.jaxexp"))
    assert got_fwd.meta["shapes"] == want_fwd.meta["shapes"] == [list(s) for s in shapes]
    assert got_fwd.meta["count"] == 2 and sorted(got_fwd.by_shape) == sorted(shapes)
    for h, w in shapes:
        x = _inputs(False, h=h, w=w, seed=h)
        (got,), (want,) = got_fwd(x), want_fwd(x)
        assert got.shape == (2, h, w, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    for fwd in (got_fwd, want_fwd):
        with pytest.raises(ValueError, match="not in bundle"):
            fwd(_inputs(False, h=30, w=W))


def test_exported_graph_calls_the_med_op(tmp_path, models):
    """One med_fwd node; the plane tables the trace made are a real tensor in
    the wrappers' cache (a fake one there would break every later call)."""
    from fal_net_torch.ops import med_kernel

    med_kernel._scalar_tables.cache_clear()
    blob = serve.export_forward(models[2], batch=1, height=H, width=W, ret_pan=True, device="cpu")
    tables = med_kernel._scalar_tables(2.0, 300.0, N, W, torch.device("cpu"))
    assert type(tables) is torch.Tensor and med_kernel._scalar_tables.cache_info().hits == 1
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        program = torch.export.load(io.BytesIO(z.read("program_0.pt2")))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("fal_net_torch.med_fwd.default") == 1, targets
    bf16 = serve.export_forward(models[2].with_dtype("bfloat16"), height=H, width=W, device="cpu")
    with zipfile.ZipFile(io.BytesIO(bf16)) as z:
        assert json.loads(z.read("meta.json"))["programs"][0]["dtype"] == "bfloat16"
        program = torch.export.load(io.BytesIO(z.read("program_0.pt2")))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("fal_net_torch.med_fwd.default") == 1, targets


def test_fresh_interpreter_loads_without_models_or_jax(tmp_path, models):
    path = _save(tmp_path, "a.pt2z", serve.export_forward(models[2], batch=1, height=H, width=W, uint8_input=True,
                                                          device="cpu"))
    code = f"""
import sys, numpy as np
from fal_net_torch.serve import load_exported
fwd = load_exported({path!r}, device="cpu")
(disp,) = fwd(np.zeros((1, {H}, {W}, 3), np.uint8))
assert disp.shape == (1, {H}, {W}, 1) and bool(disp.isfinite().all())
bad = sorted(m for m in sys.modules if m == "fal_net_torch.models" or m.startswith("fal_net_torch.models.")
             or m.split(".")[0] in ("jax", "jaxlib", "flax", "fal_net_tpu"))
print("IMPORTED", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env(["PYTHONPATH"]), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED []" in proc.stdout


def test_foreign_files_and_devices_are_rejected(tmp_path, models):
    (tmp_path / "garbage.pt2z").write_bytes(b"not an artifact" * 10)
    with pytest.raises(ValueError, match="not a fal_net_torch export artifact"):
        serve.load_exported(str(tmp_path / "garbage.pt2z"), device="cpu")
    with zipfile.ZipFile(tmp_path / "other.zip", "w") as z:
        z.writestr("meta.json", json.dumps({"format": "something else"}))
    with pytest.raises(ValueError, match="not a fal_net_torch export artifact"):
        serve.load_exported(str(tmp_path / "other.zip"), device="cpu")
    # an artifact made for the card is never moved to the CPU
    blob = serve.export_forward(models[2], batch=1, height=H, width=W, device="cpu")
    src = zipfile.ZipFile(io.BytesIO(blob))
    meta = json.loads(src.read("meta.json"))
    meta["programs"][0]["device"] = "cuda"
    with zipfile.ZipFile(tmp_path / "cuda.pt2z", "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("program_0.pt2", src.read("program_0.pt2"))
    with pytest.raises(ValueError, match="never moved"):
        serve.load_exported(str(tmp_path / "cuda.pt2z"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            serve.load_exported(str(tmp_path / "cuda.pt2z"))  # the default device: the card
    fwd = serve.load_exported(_save(tmp_path, "f.pt2z", blob), device="cpu")
    with pytest.raises(TypeError, match="float32_normalized"):
        fwd(np.zeros((1, H, W, 3), np.uint8))  # a uint8 dataset goes only to a uint8 artifact


@pytest.fixture(scope="module")
def eigen_tree(tmp_path_factory):
    """A KITTI-raw tree for Kitti_eigen_test_improved: 3 frames at a KITTI
    width, sparse uint16 groundtruth and velodyne depth PNGs."""
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.default_rng(0)
    lines = []
    for i in (3, 7, 42):
        frame = f"{i:010d}.png"
        for cam in ("image_02", "image_03"):
            d = root / DRIVE / cam / "data"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 255, (KITTI_H, KITTI_W, 3), dtype=np.uint8)).save(d / frame)
        for kind in ("groundtruth", "velodyne_raw"):
            d = root / DRIVE / "proj_depth" / kind / "image_02"
            d.mkdir(parents=True, exist_ok=True)
            depth = (rng.random((KITTI_H, KITTI_W)) * 80 * 256).astype(np.uint16)
            depth[rng.random((KITTI_H, KITTI_W)) < 0.7] = 0
            Image.fromarray(depth).save(d / frame)
        lines.append(f"{DRIVE}/image_02/data/{frame} {DRIVE}/image_03/data/{frame}")
    (root / "lists").mkdir()
    (root / "lists" / "kitti_eigen_test_improved.txt").write_text("\n".join(lines))
    return root


@pytest.fixture(scope="module")
def eigen_artifacts(tmp_path_factory, models):
    """Both packages' bundles of the tiny model at the tree's shape and its
    2/3 shape (cli.export --with_ms_pp), batch 2."""
    jax_model, variables, port = models
    out = tmp_path_factory.mktemp("artifacts")
    shapes = cli_export.shapes_of(f"{KITTI_H}x{KITTI_W}", True, 0, 0)
    assert shapes == [(KITTI_H, KITTI_W), (32, 828)]
    serve.save_exported(str(out / "port.pt2z"), serve.export_bundle(port, shapes, batch=2, device="cpu"))
    jax_serve.save_exported(str(out / "jax.jaxexp"),
                            jax_serve.export_bundle(jax_model, variables, shapes, batch=2, platforms=("cpu",)))
    return out


def test_evaluator_from_artifact_matches_jax(tmp_path, eigen_tree, eigen_artifacts):
    lists = str(eigen_tree / "lists")
    name = "Kitti_eigen_test_improved"
    results = {}
    for label, reg, evaluator, config, load in (
        ("port", datasets.REGISTRY, Evaluator, EvalConfig, lambda p: serve.load_exported(p, device="cpu")),
        ("jax", jds.REGISTRY, JaxEvaluator, JaxEvalConfig, jax_serve.load_exported),
    ):
        fwd = load(str(eigen_artifacts / ("port.pt2z" if label == "port" else "jax.jaxexp")))
        _, ds = reg[name](str(eigen_tree), split=0, lists_dir=lists)
        cfg = config(dataset=name, batch_size=8, save_path=str(tmp_path / label), print_freq=1)
        ev = evaluator.from_artifact(fwd, cfg)
        assert cfg.batch_size == 2  # forced to the artifact's
        results[label] = ev.run(ds)
    files = [json.loads((tmp_path / d / "metrics.json").read_text()) for d in ("port", "jax")]
    assert files[0].keys() == files[1].keys()
    assert files[0]["n_params"] == files[1]["n_params"] and files[0]["n_images"] == files[1]["n_images"] == 3
    for k in (k for k in files[1] if k not in ("n_params", "n_images", "sec_per_image")):
        np.testing.assert_allclose(files[0][k], files[1][k], err_msg=k, **METRIC_TOL)
    assert np.isfinite(results["port"]["abs_rel"])


def test_evaluator_from_artifact_rules(tmp_path, models):
    port = models[2]
    uint8 = serve.load_exported(_save(tmp_path, "u.pt2z", serve.export_forward(
        port, batch=1, height=H, width=W, uint8_input=True, device="cpu")), device="cpu")
    with pytest.raises(ValueError, match="float32-input"):
        Evaluator.from_artifact(uint8, EvalConfig())  # ms-pp on by default
    with pytest.raises(ValueError, match="float32-input"):
        Evaluator.from_artifact(uint8, EvalConfig(ms_post_process=False, f_post_process=True))
    Evaluator.from_artifact(uint8, EvalConfig(ms_post_process=False))
    disp_only = serve.load_exported(_save(tmp_path, "d.pt2z", serve.export_forward(
        port, batch=1, height=H, width=W, ret_pan=True, device="cpu")), device="cpu")
    with pytest.raises(ValueError, match="save_pan needs"):
        Evaluator.from_artifact(disp_only, EvalConfig(save=True, save_pan=True))


def test_cli_test_artifact_equals_pretrained(tmp_path, models, eigen_tree, eigen_artifacts):
    """cli.test --artifact on the CPU: the metrics of --pretrained on the same
    weights (both run the plain MED head here), and of the Evaluator."""
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, models[2])
    base = ["--data_root", str(eigen_tree), "--lists_dir", str(eigen_tree / "lists"), "--device", "cpu"]
    got = cli_test.main(base + ["--artifact", str(eigen_artifacts / "port.pt2z"), "--save_path", str(tmp_path / "a")])
    want = cli_test.main(base + ["--pretrained", ckpt, "--batch_size", "2", "--save_path", str(tmp_path / "p")])
    for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert json.loads((tmp_path / "a" / "metrics.json").read_text())["n_params"] == 42630


@pytest.mark.parametrize("flags", [["--model", "B"], ["--no_levels", "9"], ["--max_disp", "100"], ["--batch_size", "4"],
                                   ["--fp32_upload"], ["--maskr_quirk"], ["--dtype", "bfloat16"],
                                   ["--rel_baseline", "2"], ["--num_devices", "2"]])
def test_cli_test_artifact_refuses_checkpoint_flags(flags):
    with pytest.raises(SystemExit, match="checkpoint-mode flags.*" + flags[0]):
        cli_test.main(["--data_root", "/nonexistent", "--device", "cpu", "--artifact", "x.pt2z", *flags])


def _read_ply(path):
    return np.loadtxt(path, skiprows=10)


def test_cli_infer_artifact_matches_jax(tmp_path, models):
    """cli.infer --artifact --colormap --save_pc against JAX's cli.infer with
    its artifact: a bundle, images of two sizes (one resized), batch 2."""
    from fal_net_tpu.cli import infer as jax_infer

    jax_model, variables, port = models
    shapes = [(H, W), (48, 160)]
    port_path = _save(tmp_path, "p.pt2z", serve.export_bundle(port, shapes, batch=2, device="cpu"))
    jax_serve.save_exported(str(tmp_path / "j.jaxexp"),
                            jax_serve.export_bundle(jax_model, variables, shapes, batch=2, platforms=("cpu",)))
    rng = np.random.default_rng(5)
    (tmp_path / "in").mkdir()
    for i, (h, w) in enumerate([(H, W), (48, 160), (H, W), (50, 150)]):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(tmp_path / "in" / f"f{i}.png")
    extra = ["--colormap", "--save_pc"]
    n = cli_infer.main(["--images", str(tmp_path / "in"), "--out_dir", str(tmp_path / "port"), "--artifact", port_path,
                        "--device", "cpu", *extra])
    jax_infer.main(["--images", str(tmp_path / "in"), "--out_dir", str(tmp_path / "jax"), "--artifact",
                    str(tmp_path / "j.jaxexp"), *extra])
    assert n == 4 and sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for i in range(4):
        got, want = (np.asarray(Image.open(tmp_path / d / f"f{i}_disp.png")).astype(np.float64) / 256
                     for d in ("port", "jax"))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-3 + 1 / 256)  # and the PNG's 1/256 px steps
        got, want = (np.asarray(Image.open(tmp_path / d / f"f{i}_cmap.png").convert("RGBA")).astype(np.int64)
                     for d in ("port", "jax"))
        assert got.shape == want.shape and np.abs(got - want).max() <= 8  # a plasma step at most
        got, want = (_read_ply(tmp_path / d / f"f{i}.ply") for d in ("port", "jax"))
        np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
        np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=5e-3, atol=1e-3)
    with pytest.raises(SystemExit, match="--height"):
        cli_infer.main(["--images", str(tmp_path / "in"), "--out_dir", str(tmp_path / "x"), "--artifact", port_path,
                        "--device", "cpu", "--height", "64"])


def test_cli_infer_pretrained_writes_colormap_and_point_clouds(tmp_path, models):
    """Checkpoint mode writes the same files as artifact mode of the same
    weights and shape."""
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, models[2])
    art = _save(tmp_path, "a.pt2z", serve.export_forward(models[2], batch=8, height=H, width=W, device="cpu"))
    (tmp_path / "in").mkdir()
    Image.fromarray((np.random.default_rng(1).random((H, W, 3)) * 255).astype(np.uint8)).save(tmp_path / "in" / "a.png")
    common = ["--images", str(tmp_path / "in"), "--device", "cpu", "--colormap", "--save_pc"]
    cli_infer.main(common + ["--out_dir", str(tmp_path / "ckpt"), "--pretrained", ckpt, "--height", str(H),
                             "--width", str(W)])
    cli_infer.main(common + ["--out_dir", str(tmp_path / "art"), "--artifact", art])
    for f in ("a_disp.png", "a_cmap.png", "a.ply"):
        assert (tmp_path / "ckpt" / f).read_bytes() == (tmp_path / "art" / f).read_bytes(), f


def test_cli_export_bundle_and_refusals(tmp_path, models):
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, models[2])
    out = str(tmp_path / "b.pt2z")
    size = cli_export.main(["--pretrained", ckpt, "--sizes", "32x64,24x96", "--with_ms_pp", "--batch", "2",
                            "--pan", "--subocc", "--device", "cpu", "--out", out])
    fwd = serve.load_exported(out, device="cpu")
    assert size == os.path.getsize(out)
    assert fwd.meta["shapes"] == [[32, 64], [24, 96], [21, 42], [16, 64]] and fwd.meta["batch"] == 2
    assert fwd.meta["outputs"] == ["disp", "pan", "maskL", "maskR"] and fwd.meta["variant"] == "tiny"
    with pytest.raises(SystemExit, match="float32-input"):
        cli_export.main(["--pretrained", ckpt, "--with_ms_pp", "--uint8_input", "--device", "cpu", "--out", out])
    cli_export.main(["--pretrained", ckpt, "--dtype", "bfloat16", "--height", "32", "--width", "64", "--device",
                     "cpu", "--out", out])
    assert serve.load_exported(out, device="cpu").meta["dtype"] == "bfloat16"


def test_cli_convert_matches_jax(tmp_path):
    """A reference-layout .pth.tar (DataParallel's module. keys) through both
    converters: the port's .pt carries JAX's msgpack's weights exactly."""
    from flax import serialization

    from fal_net_tpu.cli import convert as jax_convert

    ref = create_model("A", 9, generator=torch.Generator().manual_seed(3), device="cpu")
    src = str(tmp_path / "model_best.pth.tar")
    torch.save({"m_model": "FAL_netA", "epoch": 3,
                "state_dict": {f"module.{k}": v for k, v in ref.state_dict().items()}}, src)
    path = cli_convert.main(["--input", src, "--output", str(tmp_path / "port")])
    jax_convert.main(["--input", src, "--output", str(tmp_path / "jax")])
    assert json.loads((tmp_path / "port" / "checkpoint.json").read_text()) == \
        json.loads((tmp_path / "jax" / "checkpoint.json").read_text()) == {"model_name": "FAL_netA", "num_levels": 9}
    got = torch.load(path, weights_only=True)
    assert got["m_model"] == "FAL_netA"
    params = serialization.msgpack_restore((tmp_path / "jax" / "checkpoint.msgpack").read_bytes())
    want = state_dict_from_jax(params, "A")
    assert got["state_dict"].keys() == want.keys() == ref.state_dict().keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got["state_dict"][k].numpy(), v, err_msg=k)
    from fal_net_torch.models.checkpoint import load_checkpoint

    assert load_checkpoint(path, device="cpu").spec.name == "A"


def test_cli_selfcheck_on_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cli_selfcheck.main(["--device", "cpu", "--timeout", "600"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "NOT RUN kernels" in out and "SELFCHECK: PASS" in out
    assert "OK   forward" in out and "OK   train step" in out


def test_cli_selfcheck_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the gate would run for real")
    with pytest.raises(SystemExit) as e:
        cli_selfcheck.main(["--timeout", "600"])
    out = capsys.readouterr().out
    assert e.value.code != 0 and "FAIL device" in out and "SELFCHECK: FAIL" in out

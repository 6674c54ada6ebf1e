"""Multi-device runs of the port on the CPU: the sharded loader against JAX's,
two gloo ranks under DistributedDataParallel against the one-process step of
the global batch and against JAX's Trainer on a 2-device mesh (stage 1, and
stage 2 with a_mr 1 and grad_accum 2), with ``remat`` against without it
(exactly), ``cli.train --num_devices 2``, the
Evaluator and DisparityPipeline on two CPU replicas, and the errors.

Every spawned group rendezvouses through a FileStore under ``tmp_path``
(never a TCP port), sets one thread per child, waits at most 60 s in a
collective and is joined with a timeout.  Tolerances: the 2-rank step's
loss at rtol 1e-5 and its gradients and Adam moments at rtol 1e-4, atol
1e-6 max|g| against the one-process step (fp32 reduction order); against
JAX, those of tests/test_torch_stages.py (loss rtol 1e-5, each gradient
within 1e-4 of its largest magnitude); replicas against one device within
1e-6 relative.
"""

from torch_lane import THREADS, default_threads  # noqa: F401  (default_threads: a fixture)
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_tpu.data.loader import DataLoader as JaxDataLoader
from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_tpu.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh, replicate_sharding
from fal_net_tpu.train import Trainer as JaxTrainer
from fal_net_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from fal_net_tpu.train.config import Stage1Config as JaxStage1Config, Stage2Config as JaxStage2Config
from fal_net_torch.cli import test as cli_test
from fal_net_torch.cli import train as train_cli
from fal_net_torch.data.loader import DataLoader
from fal_net_torch.eval.evaluate import EvalConfig, Evaluator
from fal_net_torch.eval.pipeline import DisparityPipeline
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import read_state_dict, save_checkpoint
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.parallel import ddp, dryrun
from fal_net_torch.parallel.mesh import gather, make_mesh, split_batch
from fal_net_torch.train.config import Stage1Config, Stage2Config
from test_torch_eval import MixedShapes, raw_tree  # noqa: F401  (the Eigen tree fixture)
from test_torch_train import _write_tree

N, H, W = 5, 32, 64
GROUP = dict(timeout=60.0, join_timeout=180.0, threads=THREADS)  # every spawned group in this file


class Indexed:
    """Items that show their index and the rng each was drawn with."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, rng):
        return {"x": np.full((2, 3), i, np.float32) + rng.random((2, 3), np.float32), "i": np.int64(i)}


@pytest.mark.parametrize("n,shards,batch,drop_last", [(7, 2, 2, True), (7, 2, 2, False), (10, 3, 1, True),
                                                      (9, 1, 4, False)])
def test_sharded_loader_matches_jax(n, shards, batch, drop_last):
    for shard in range(shards):
        kw = dict(batch_size=batch, shuffle=True, num_workers=2, seed=5, drop_last=drop_last, shard_id=shard,
                  num_shards=shards)
        got, want = DataLoader(Indexed(n), **kw), JaxDataLoader(Indexed(n), **kw)
        for epoch in (0, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a, b = list(got), list(want)
            assert len(got) == len(want) == len(a) == len(b)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])


def test_shards_make_the_global_batch():
    """The ranks' batch k together are the one-shard loader's batch k."""
    one = list(DataLoader(Indexed(17), batch_size=6, seed=2))
    parts = [list(DataLoader(Indexed(17), batch_size=3, seed=2, shard_id=r, num_shards=2)) for r in range(2)]
    assert len(one) == len(parts[0]) == len(parts[1]) == 2
    for k in range(2):
        assert sorted(np.concatenate([parts[0][k]["i"], parts[1][k]["i"]])) == sorted(one[k]["i"])


def _jax_step(cfg_jax, port_sd, batch, stage):
    """JAX's Trainer on a 2-device mesh: one step from the port's weights;
    returns the loss and the gradients recovered from Adam's first moment."""
    jtr = JaxTrainer(cfg_jax, stage=stage, mesh=jax_make_mesh(2), train_dataset=dryrun.SyntheticStereo(4, H, W))
    jtr.setup()
    params = {"params": convert_state_dict(port_sd, JAX_VARIANTS["tiny"])}
    jtr.state = jtr.state.replace(params=jax.device_put(params, replicate_sharding(jtr.mesh)))
    jb = jax.device_put({k: jnp.asarray(batch[k]) for k in ("left", "right")}, batch_sharding(jtr.mesh))
    new_state, aux = jtr.train_step(jtr.state, jb, jtr.vgg_params, jtr.teacher_params)
    mu = jax.device_get(new_state.opt_state[0].mu["params"])
    return float(aux["loss"]), {k: v / (1 - cfg_jax.beta1) for k, v in state_dict_from_jax(mu, "tiny").items()}


def _global_batch(cfg, dataset):
    loader = DataLoader(dataset, batch_size=cfg.batch_size, seed=cfg.seed, num_workers=1)
    return next(iter(loader))


def _check_against_jax(port_report, jax_loss, jax_grads):
    np.testing.assert_allclose(port_report["aux"]["loss"], jax_loss, rtol=1e-5)
    for k, want in jax_grads.items():
        got = port_report["grads"][k]
        if got is None:  # never used: zero in JAX
            assert not np.any(want), k
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=k)


@pytest.mark.usefixtures("default_threads")  # this process's step at one thread: 1.12 units; 2 and 8: 0.38, 0.87
def test_two_gloo_ranks_stage1(tmp_path):
    """dryrun_multigpu on the CPU: two gloo ranks, one DDP stage-1 step,
    against the one-process step (inside the dry run) and JAX's 2-device
    mesh step."""
    report = dryrun.dryrun_multigpu(2, "cpu", variant="tiny", num_levels=N, height=H, width=W, batch=4,
                                    store_dir=str(tmp_path), **GROUP)
    assert report["backend"] == "gloo" and report["worst"] <= 1.0 and report["mean_worst"] <= 1.0
    assert report["loss"][0] == report["loss"][1]  # all-reduced
    np.testing.assert_allclose(report["loss"][0], report["one_process_loss"], rtol=1e-5)
    cfg = Stage1Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=4, a_p=0.0, workers=2)
    port_sd = {k: v.numpy() for k, v in create_model("tiny", N, device="cpu",
                                                     generator=torch.Generator().manual_seed(0)).state_dict().items()}
    batch = _global_batch(cfg, dryrun.SyntheticStereo(4, H, W))
    jcfg = JaxStage1Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=4, a_p=0.0, workers=1,
                           med_selfcheck=False)
    _check_against_jax(report["rank0"], *_jax_step(jcfg, port_sd, batch, "stage1"))


def test_two_gloo_ranks_stage2_grad_accum(tmp_path):
    """Stage 2 (a_mr 1, the frozen teacher in every rank) with grad_accum 2:
    no_sync on the first microbatch, one all-reduce on the last."""
    # the teacher as a JAX checkpoint, which both trainers read
    t_sd = {k: v.numpy() for k, v in create_model("tiny", N, device="cpu",
                                                  generator=torch.Generator().manual_seed(1)).state_dict().items()}
    jax_save_checkpoint(str(tmp_path / "teacher"), convert_state_dict(t_sd, JAX_VARIANTS["tiny"]),
                        {"model_name": "tiny", "num_levels": N})
    teacher = str(tmp_path / "teacher" / "checkpoint.msgpack")
    cfg = Stage2Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=4, a_p=0.0, workers=2,
                       grad_accum=2, a_mr=1.0, fix_model=teacher)
    dataset = dryrun.SyntheticStereo(4, H, W, seed=3)
    args = (cfg, "stage2", "cpu", dataset)
    ranks = ddp.launch(dryrun.rank_step, 2, args, store_path=str(tmp_path / "store"), device="cpu", **GROUP)
    one = dryrun.rank_step(0, 1, *args)
    assert dryrun.step_error(ranks[0], one) <= 1.0
    assert ranks[0]["aux"] == ranks[1]["aux"] and set(ranks[0]["aux"]) >= {"loss", "mirror_loss"}
    port_sd = {k: v.numpy() for k, v in create_model("tiny", N, device="cpu",
                                                     generator=torch.Generator().manual_seed(0)).state_dict().items()}
    jcfg = JaxStage2Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=4, a_p=0.0, workers=1,
                           grad_accum=2, a_mr=1.0, fix_model=teacher, med_selfcheck=False)
    _check_against_jax(ranks[0], *_jax_step(jcfg, port_sd, _global_batch(cfg, dataset), "stage2"))


def test_two_gloo_ranks_remat(tmp_path):
    """remat under DDP with grad_accum 2: the checkpoint sits inside the
    module DDP wraps, so each microbatch's recompute runs under DDP's hooks
    (no_sync on the first); the all-reduced gradients, Adam's moments and
    the losses equal the same two-rank step without remat exactly."""
    dataset = dryrun.SyntheticStereo(4, H, W, seed=5)
    reports = {}
    for remat in (False, True):
        cfg = Stage1Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=4, a_p=0.0, workers=2,
                           grad_accum=2, remat=remat)
        ranks = ddp.launch(dryrun.rank_step, 2, (cfg, "stage1", "cpu", dataset),
                           store_path=str(tmp_path / f"store{int(remat)}"), device="cpu", **GROUP)
        reports[remat] = ranks[0]
    plain, remat = reports[False], reports[True]
    assert remat["aux"] == plain["aux"]
    for name, g in plain["grads"].items():
        if g is None:
            assert remat["grads"][name] is None, name
            continue
        np.testing.assert_array_equal(remat["grads"][name], g, err_msg=name)
        for a, b in zip(remat["adam"][name], plain["adam"][name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_cli_train_two_cpu_ranks(tmp_path, monkeypatch, capsys):
    """cli.train --num_devices 2 --device cpu: two gloo ranks, one run
    directory, one checkpoint (rank 0's, unprefixed keys), one settings file
    and metrics log; the epoch's loss is the ranks' mean."""
    root = _write_tree(tmp_path, n_pairs=4)
    save = tmp_path / "runs"
    argv = ["--data_root", root, "--lists_dir", root, "--model", "tiny", "--no_levels", str(N), "--a_p", "0",
            "--device", "cpu", "--epochs", "1", "--batch_size", "4", "--crop_height", str(H), "--crop_width",
            str(W), "--workers", "1", "--num_devices", "2", "--save_path", str(save)]
    monkeypatch.setattr(ddp, "launch", functools.partial(ddp.launch, **GROUP))  # this file's group limits
    train_cli.main(argv)
    assert "2 ranks (gloo), 2 samples each" in capsys.readouterr().out
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(save) for f in fs if f == "checkpoint.pt"]
    assert len(ckpts) == 1
    run = os.path.dirname(ckpts[0])
    assert sorted(os.listdir(run)) == ["checkpoint.pt", "metrics.jsonl", "model_best.pt", "settings.txt", "tb"]
    assert len([ln for ln in open(os.path.join(run, "metrics.jsonl")) if '"train/loss"' in ln]) == 1
    sd = read_state_dict(ckpts[0])
    assert not any(k.startswith("module.") for k in sd) and sd.keys() == create_model("tiny", N,
                                                                                      device="cpu").state_dict().keys()
    assert not [f for f in os.listdir(save) if f.startswith(".rendezvous")]


def test_launch_reraises_a_child_failure(tmp_path):
    args = (Stage1Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=4), "bogus", "cpu",
            dryrun.SyntheticStereo(4, H, W))
    with pytest.raises(RuntimeError, match="stage must be one of"):
        ddp.launch(dryrun.rank_step, 2, args, store_path=str(tmp_path / "store"), device="cpu", **GROUP)


@pytest.fixture(scope="module")
def tiny():
    return create_model("tiny", N, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kw", [dict(ms_post_process=True), dict(f_post_process=True, ms_post_process=False)])
def test_evaluator_on_two_cpu_replicas(tiny, tmp_path, kw):
    one = Evaluator(tiny, EvalConfig(dataset="Kitti2015", batch_size=4, save_path=str(tmp_path / "a"), **kw))
    two = Evaluator(tiny, EvalConfig(dataset="Kitti2015", batch_size=4, save_path=str(tmp_path / "b"), **kw),
                    mesh=["cpu", "cpu"])
    assert two.replicas[0] is two.replicas[1] is tiny  # a repeated device shares its replica
    got, want = two.run(MixedShapes()), one.run(MixedShapes())
    for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3", "epe"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_pipeline_on_two_cpu_replicas(tiny, rng):
    """Batches of 4 over two replicas equal one device at the parts' batch
    of 2, bit for bit: each part is that batch's computation (the tail's
    padding included). One device at batch 4 is no exact reference: the
    CPU's convolutions sum in a batch-dependent order (FAL-net's 1x1 level
    6 first), a few fp32 ulps that the decoder carries to the disparities."""
    images = [(f"f{i}", (rng.standard_normal((H, W, 3)) * 0.3).astype(np.float32)) for i in range(5)]
    want = dict(DisparityPipeline(tiny, batch_size=2, ms_post_process=True).run(images))
    got = dict(DisparityPipeline(tiny, batch_size=4, ms_post_process=True, mesh=["cpu", "cpu"]).run(images))
    assert list(got) == [n for n, _ in images]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def test_cli_test_num_devices_on_cpu(tiny, raw_tree, tmp_path):  # noqa: F811
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, tiny)
    base = ["--data_root", str(raw_tree), "--lists_dir", str(raw_tree / "lists"), "--pretrained", ckpt,
            "--device", "cpu", "--batch_size", "2"]
    got = cli_test.main(base + ["--num_devices", "2", "--save_path", str(tmp_path / "two")])
    want = cli_test.main(base + ["--save_path", str(tmp_path / "one")])
    for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    saved = json.loads((tmp_path / "two" / "metrics.json").read_text())
    assert saved["n_images"] == 3


def test_split_and_gather():
    x = torch.arange(24.0).reshape(6, 4)
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    parts = split_batch(x, mesh)
    assert [p.shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(gather(parts), x)


def test_errors(tiny, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):  # the port's device rule
            make_mesh(2)
    with pytest.raises(ValueError, match="a mesh of 3 devices was asked for, but there are 2 devices given"):
        make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch_size 3 is not divisible by the mesh 'data' axis size 2"):
        Evaluator(tiny, EvalConfig(batch_size=3), mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch_size 3 is not divisible"):
        DisparityPipeline(tiny, batch_size=3, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="--spatial 2 must divide the device count 3"):  # JAX's message
        train_cli.main(["--data_root", "/nonexistent", "--device", "cpu", "--num_devices", "3", "--spatial", "2"])
    with pytest.raises(ValueError, match="batch_size 4 is not divisible by --num_devices 3"):
        train_cli.main(["--data_root", "/nonexistent", "--device", "cpu", "--num_devices", "3", "--batch_size", "4"])
    with pytest.raises(SystemExit, match="--num_devices"):  # an artifact refuses it, as JAX's cli.test does
        cli_test.main(["--data_root", "/nonexistent", "--artifact", "x.pt2z", "--device", "cpu",
                       "--num_devices", "2"])
    assert "relay_retries" not in {f.name for f in EvalConfig.__dataclass_fields__.values()}

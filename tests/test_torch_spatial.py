"""Row (spatial) partitioning of the port on the CPU (parallel/spatial.py):
the row collectives, the forward and the training steps on a data x spatial
grid of gloo ranks against the port's unsharded forward and step and against
JAX on ``make_2d_mesh(2, 2)`` (the steps on ``(1, 2)``, see ``_jax_step``)
and against the one-process step (stage 1 slow, the perceptual term, bf16),
and ``cli.train --spatial``.

Two spawned groups, each rendezvousing through a FileStore under
``tmp_path``, one thread a child, collectives waiting at most 60 s, joined
with a timeout: four ranks for the collectives, the forwards and the steps
(started by the first test, run while JAX compiles its side), two for the
CLI.
This module imports neither jax nor fal_net_tpu at its top, so that the
ranks, which import it, start fast.

Shapes: the forwards at 48 x 78, whose levels have 48, 24, 12, 6, 3, 2 and
1 rows (at S = 2, x4 and x6 whole, deconv5's 2 -> 3 rows not 2x; at S = 4,
x3..x6 whole) and whose columns halve to 39 (no deconv 2x in W below); the
steps at 32 x 64.  Tolerances: the forwards rtol 1e-4, atol 1e-4, against
the unsharded forward and JAX's (tests/test_spatial.py:38-43), in bf16
against the unsharded bf16 forward as well; the steps against JAX at
``_check_against_jax``'s (loss rtol 1e-5, each gradient within 1e-4 of its
largest magnitude, tests/test_torch_parallel.py:111-118), stage 1 slow and
the perceptual step at the same against the one-process step; remat against no
remat exactly; the collectives and the row-split losses against autograd
through the unsharded ops at rtol 1e-5, atol 1e-6.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fal_net_torch.cli import train as train_cli
from fal_net_torch.losses.smoothness import smoothness
from fal_net_torch.losses.vgg import init_vgg19
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import read_state_dict
from fal_net_torch.parallel import ddp, dryrun
from fal_net_torch.parallel.spatial import RowShard, make_2d_grid
from fal_net_torch.train.config import Stage1Config, Stage2Config

N, MN, MX = 5, 2.0, 30.0
H, W = 48, 78  # the forwards
SH, SW = 32, 64  # the steps
GROUP = dict(timeout=60.0, join_timeout=180.0, threads=1)  # every spawned group in this file
TOL = dict(rtol=1e-5, atol=1e-6)
OUTPUTS = ("disp", "pan", "maskL", "maskR")


def _images(n, h, w, seed):
    return (np.random.default_rng(seed).standard_normal((n, h, w, 3)) * 0.3).astype(np.float32)


UNIT_RANKS = RowShard(4, 0)  # the collectives' split: 7 rows over 4 ranks, 2, 2, 2 and 1


def _unit_inputs():
    """Seeded whole tensors for the collectives: x (2, 3, 7, 5), cotangents
    of each rank's halo'd slab (its rows and one more above and below) and
    of the gathered tensor, an image and disparity (2, ., 24, 20) for the
    losses."""
    g = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    rows = [UNIT_RANKS.bounds(7, r) for r in range(UNIT_RANKS.size)]
    return {"x": t(2, 3, 7, 5), "w_halo": [t(2, 3, hi - lo + 2, 5) for lo, hi in rows],
            "w_gather": [t(2, 3, 7, 5) for _ in rows], "img": t(2, 3, 24, 20) * 0.3,
            "disp": t(2, 1, 24, 20).abs() * 5}


def _vgg():
    return init_vgg19(seed=3)


def _units(rank, world):
    """One of four ranks: each collective on this rank's rows, forward and
    backward; smoothness and VGG19 features on its rows of 24 (6 a rank:
    a row-local pool, then 3 rows, gathered for the other two)."""
    rows = make_2d_grid(1, world).rows
    u = _unit_inputs()
    out = {}
    x = rows.split(u["x"]).clone().requires_grad_(True)
    halo = rows.halo(x, 1)
    (halo * u["w_halo"][rank]).sum().backward()
    out["halo"], out["halo_grad"], x.grad = halo.detach(), x.grad, None
    whole = rows.gather(x, 7)
    (whole * u["w_gather"][rank]).sum().backward()
    out["gather"], out["gather_grad"], x.grad = whole.detach(), x.grad, None
    mean = rows.mean(x * x)
    mean.backward()
    out["mean"], out["mean_grad"] = mean.detach(), x.grad
    out["amax"] = rows.amax(x.detach())
    img = rows.split(u["img"])
    disp = rows.split(u["disp"]).clone().requires_grad_(True)
    sm = smoothness(img, disp, gamma=2.0, rows=rows)
    sm.backward()
    out["sm"], out["sm_grad"] = sm.detach(), disp.grad
    im = img.clone().requires_grad_(True)
    feats = _vgg()(im, rows=rows, height=24)
    loss = sum(rows.mean(f * f) for f in feats)
    loss.backward()
    out["vgg"], out["vgg_loss"], out["vgg_grad"] = [f.detach() for f in feats], loss.detach(), im.grad
    return {k: [t.numpy() for t in v] if isinstance(v, list) else v.numpy() for k, v in out.items()}


def _rows(parts, axis=2):
    return np.concatenate(parts, axis=axis)


def _configs(teacher):
    s1 = dict(model="tiny", num_levels=N, crop_size=(SH, SW), batch_size=4, workers=1)
    return (Stage1Config(**s1, a_p=0.0), Stage1Config(**s1, a_p=0.0, remat=True),
            Stage2Config(**s1, a_p=0.0, grad_accum=2, a_mr=1.0, fix_model=teacher),
            Stage1Config(**s1, a_p=0.0, compute_dtype="bfloat16"), Stage1Config(**s1, a_p=0.01, allow_random_vgg=True))


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A stage-2 teacher as a JAX msgpack checkpoint, which both trainers read."""
    from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
    from fal_net_tpu.models.torch_import import convert_state_dict
    from fal_net_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    t_sd = {k: v.numpy() for k, v in create_model("tiny", N, device="cpu",
                                                  generator=torch.Generator().manual_seed(1)).state_dict().items()}
    root = tmp_path_factory.mktemp("teacher")
    jax_save_checkpoint(str(root), convert_state_dict(t_sd, JAX_VARIANTS["tiny"]), {"model_name": "tiny",
                                                                                   "num_levels": N})
    return str(root / "checkpoint.msgpack")


DATASETS = (dryrun.SyntheticStereo(4, SH, SW, seed=0), dryrun.SyntheticStereo(4, SH, SW, seed=3))
FORWARDS = {  # (spatial, model_kw)
    "2x2 phase": (2, dict(variant="tiny", num_levels=N, phase_deconv=True)),
    "1x4": (4, dict(variant="tiny", num_levels=N)),
    "1x4 bf16": (4, dict(variant="tiny", num_levels=N, dtype="bfloat16")),
}
STEP0 = 1 + len(FORWARDS)  # the grid's calls: the collectives, the forwards, then the steps
ONE_PROCESS = ("stage1 bf16", "stage1 slow", "stage1 a_p 0.01")  # grid steps STEP0 + 3.. held against one process


@pytest.fixture(scope="module")
def started(tmp_path_factory, teacher):
    """Started by this module's first test: one group of four gloo ranks (the
    row collectives, the forwards of FORWARDS, with disp, pan and masks, then on a 2 x 2 grid a
    stage-1 step, the same with remat, and a stage-2 step with a_mr 1 and
    grad_accum 2, then the steps of ONE_PROCESS: stage 1 in bf16, stage 1
    slow and stage 1 with the perceptual term (a_p 0.01, a seeded VGG19),
    each rank's results in that order), the one-process stage-1 step in fp32
    and the steps of ONE_PROCESS, and JAX's side of the comparisons, each in
    a background thread, so that they run while the tests that spawn their
    own groups do.  Futures, by name."""
    s1, s1_remat, s2, s1_bf16, s1_vgg = _configs(teacher)
    one = ((s1, "stage1"), (s1_bf16, "stage1"), (s1, "stage1_slow"), (s1_vgg, "stage1"))
    calls = [(_units, (), {})]
    calls += [(dryrun.rank_forward, (s, "cpu", _images(4, H, W, 0), MN, MX, kw), dict(ret_pan=True, ret_subocc=True))
              for s, kw in FORWARDS.values()]
    from test_torch_parallel import _global_batch

    reference = _global_batch(s1, DATASETS[0])  # each data group's slice of it, alone (dryrun_multigpu's check)
    calls += [(dryrun.rank_step, (cfg, stage, "cpu", ds), dict(spatial=2, **kw))
              for cfg, stage, ds, kw in ((s1, "stage1", DATASETS[0], dict(reference=reference)),
                                         (s1_remat, "stage1", DATASETS[0], {}), (s2, "stage2", DATASETS[1], {}),
                                         *((cfg, stage, DATASETS[0], {}) for cfg, stage in one[1:]))]
    store = str(tmp_path_factory.mktemp("grid") / "store")
    with ThreadPoolExecutor(2) as ranks, ThreadPoolExecutor(2) as jax_side:
        yield {"grid": ranks.submit(ddp.launch, dryrun.rank_calls, 4, (calls,), store_path=store, device="cpu",
                                    **GROUP),
               "one": ranks.submit(lambda: [dryrun.rank_step(0, 1, cfg, stage, "cpu", DATASETS[0])
                                            for cfg, stage in one]),
               **{stage: jax_side.submit(_jax_step, stage, teacher) for stage in ("stage1", "stage2")},
               "forward": jax_side.submit(_jax_forward)}


def _port_sd():
    return {k: v.numpy() for k, v in create_model("tiny", N, device="cpu",
                                                  generator=torch.Generator().manual_seed(0)).state_dict().items()}


def _jax_step(stage, teacher):
    """One step of JAX's Trainer on make_2d_mesh(1, 2), the rows over 2
    devices, its backbone pinned to them (the model its __init__ builds, the
    teacher as its setup builds it, the step of its _build_train_step: the
    stage loss, the grad_accum microbatches, Adam), from the port's weights
    (setup's eager init of the model is skipped: it alone took 18 s); the
    loss and the gradients recovered from Adam's first moment.  Not on
    make_2d_mesh(2, 2): on these virtual CPU devices JAX's partitioned
    backward, with the backbone's pins or without them, gives encoder
    gradients up to 3x their largest magnitude away from the one-device
    step's (the loss agrees), on (1, 4) and (4, 2) too, while on (1, 2) and
    (2, 1) it agrees; scripts/probe_pinned_grads.py reproduces it."""
    import jax
    import jax.numpy as jnp

    from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
    from fal_net_tpu.models import create_model as jax_create_model
    from fal_net_tpu.train.checkpoint import load_params_any
    from fal_net_tpu.models.torch_import import convert_state_dict
    from fal_net_tpu.parallel.mesh import batch_sharding, replicate_sharding
    from fal_net_tpu.parallel.spatial import make_2d_mesh
    from fal_net_tpu.train import Trainer as JaxTrainer
    from fal_net_tpu.train.state import create_train_state
    from fal_net_tpu.train.config import Stage1Config as JaxStage1Config, Stage2Config as JaxStage2Config
    from fal_net_torch.models.jax_import import state_dict_from_jax
    from test_torch_parallel import _global_batch

    kw = dict(model="tiny", num_levels=N, crop_size=(SH, SW), batch_size=4, a_p=0.0, workers=1, med_selfcheck=False)
    cfg_jax = JaxStage1Config(**kw) if stage == "stage1" else JaxStage2Config(**kw, grad_accum=2, a_mr=1.0,
                                                                              fix_model=teacher)
    batch = _global_batch(_configs(teacher)[0], DATASETS[0 if stage == "stage1" else 1])
    jtr = JaxTrainer(cfg_jax, stage=stage, mesh=make_2d_mesh(1, 2))
    jtr.vgg_model = jtr.teacher_model = jtr.teacher_params = None
    c = cfg_jax
    if stage == "stage2":
        t_vars, t_name, t_levels = load_params_any(cfg_jax.fix_model)
        jtr.teacher_model = jax_create_model(t_name or c.model, t_levels or c.num_levels, med_mesh=jtr.med_mesh,
                                             med_spatial_axis=jtr.med_spatial_axis)
        jtr.teacher_params = jax.device_put(t_vars, replicate_sharding(jtr.mesh))
    state = create_train_state(jtr.model, {"params": convert_state_dict(_port_sd(), JAX_VARIANTS["tiny"])}, lr=c.lr,
                               beta1=c.beta1, beta2=c.beta2, milestones=c.milestones, lr_gamma=c.lr_gamma,
                               steps_per_epoch=1)
    state = jax.device_put(state, replicate_sharding(jtr.mesh))
    jb = jax.device_put({k: jnp.asarray(batch[k]) for k in ("left", "right")}, batch_sharding(jtr.mesh))
    new_state, aux = jtr._build_train_step()(state, jb, None, jtr.teacher_params)
    mu = jax.device_get(new_state.opt_state[0].mu["params"])
    return float(aux["loss"]), {k: v / (1 - c.beta1) for k, v in state_dict_from_jax(mu, "tiny").items()}


def test_cli_train_spatial_on_cpu(tmp_path, monkeypatch, capsys, started):
    """cli.train --spatial 2 --device cpu: two gloo ranks split each image's
    rows, one epoch, one run directory with rank 0's checkpoint.  (The
    module's first test: it starts ``started``, which runs meanwhile.)"""
    from test_torch_train import _write_tree

    root = _write_tree(tmp_path, n_pairs=4)
    save = tmp_path / "runs"
    argv = ["--data_root", root, "--lists_dir", root, "--model", "tiny", "--no_levels", str(N), "--a_p", "0",
            "--device", "cpu", "--epochs", "1", "--batch_size", "2", "--crop_height", str(SH), "--crop_width",
            str(SW), "--workers", "1", "--spatial", "2", "--save_path", str(save)]
    monkeypatch.setattr(ddp, "launch", functools.partial(ddp.launch, **GROUP))  # this file's group limits
    result = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "2 ranks (gloo), 2 samples each, 1 x 2: rows over 2 ranks" in out
    assert len(result["history"]) == 1 and np.isfinite(result["history"][0]["loss"])
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(save) for f in fs if f == "checkpoint.pt"]
    assert len(ckpts) == 1
    assert read_state_dict(ckpts[0]).keys() == create_model("tiny", N, device="cpu").state_dict().keys()


def test_cli_train_spatial_must_divide():
    """JAX's error (fal_net_tpu/cli/train.py:193-196) for a grid that cannot
    be formed, before any rank starts."""
    with pytest.raises(ValueError, match="--spatial 3 must divide the device count 4"):
        train_cli.main(["--data_root", "/nonexistent", "--device", "cpu", "--num_devices", "4", "--spatial", "3"])
    with pytest.raises(ValueError, match="batch_size 4 is not divisible by the 3 data groups of --spatial 2"):
        train_cli.main(["--data_root", "/nonexistent", "--device", "cpu", "--num_devices", "6", "--spatial", "2",
                        "--batch_size", "4"])


def test_row_collectives_match_unsharded(started):
    """halo, gather (7 rows over 4: uneven, two inner ranks), mean and amax:
    values as the unsharded tensor's rows, gradients as autograd's through
    the unsharded ops (the halo slabs are zero-padded rows of x, the
    gathered tensor is x on each rank); the row-split smoothness and VGG19
    features (and the gradients of a loss on them) as the unsharded ones."""
    ranks = [r[0] for r in started["grid"].result()]
    u = _unit_inputs()
    x = u["x"].clone().requires_grad_(True)
    padded = F.pad(x, (0, 0, 1, 1))
    slabs = [padded[..., lo:hi + 2, :] for lo, hi in (UNIT_RANKS.bounds(7, r) for r in range(UNIT_RANKS.size))]
    sum((s * w).sum() for s, w in zip(slabs, u["w_halo"])).backward()
    for r, s in enumerate(slabs):
        np.testing.assert_array_equal(ranks[r]["halo"], s.detach().numpy())
    np.testing.assert_allclose(_rows([r["halo_grad"] for r in ranks]), x.grad.numpy(), **TOL)
    x.grad = None
    sum((x * w).sum() for w in u["w_gather"]).backward()
    for r in ranks:
        np.testing.assert_array_equal(r["gather"], u["x"].numpy())
    np.testing.assert_allclose(_rows([r["gather_grad"] for r in ranks]), x.grad.numpy(), **TOL)
    x.grad = None
    mean = (x * x).mean()
    mean.backward()
    for r in ranks:
        np.testing.assert_allclose(r["mean"], mean.detach().numpy(), **TOL)
        np.testing.assert_array_equal(r["amax"], torch.amax(u["x"], dim=(1, 2, 3), keepdim=True).numpy())
    np.testing.assert_allclose(_rows([r["mean_grad"] for r in ranks]), x.grad.numpy(), **TOL)

    disp = u["disp"].clone().requires_grad_(True)
    sm = smoothness(u["img"], disp, gamma=2.0)
    sm.backward()
    for r in ranks:
        np.testing.assert_allclose(r["sm"], sm.detach().numpy(), **TOL)
    np.testing.assert_allclose(_rows([r["sm_grad"] for r in ranks]), disp.grad.numpy(), **TOL)
    im = u["img"].clone().requires_grad_(True)
    feats = _vgg()(im)
    loss = sum((f * f).mean() for f in feats)
    loss.backward()
    for k, f in enumerate(feats):
        want = f.detach().numpy()
        np.testing.assert_allclose(_rows([r["vgg"][k] for r in ranks]), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    for r in ranks:
        np.testing.assert_allclose(r["vgg_loss"], loss.detach().numpy(), **TOL)
    got = _rows([r["vgg_grad"] for r in ranks])
    np.testing.assert_allclose(got, im.grad.numpy(), rtol=1e-5, atol=1e-6 * np.abs(im.grad.numpy()).max())


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_grid_step_matches_jax(started, stage):
    """A step on the 2 x 2 grid (stage 2: a_mr 1, grad_accum 2, the frozen
    teacher on the ranks' rows): the loss and every gradient against JAX's
    spatial Trainer (see _jax_step), the same global batch, the port's
    weights; every rank logs the global loss."""
    from test_torch_parallel import _check_against_jax

    i = STEP0 + (0 if stage == "stage1" else 2)
    ranks = started["grid"].result()
    assert len({r[i]["aux"]["loss"] for r in ranks}) == 1
    _check_against_jax(ranks[0][i], *started[stage].result())


@pytest.mark.parametrize("name", ONE_PROCESS[1:])
def test_grid_step_matches_one_process(started, name):
    """Stage 1 slow (each rank's rows of the hflipped pair, both sides) and
    the perceptual term (VGG19's convs on halos, its pools on each rank's
    rows or whole, inside rec_loss) on the 2 x 2 grid: the loss and every
    gradient against the one-process step on the same global batch at
    _check_against_jax's tolerances (tests/test_torch_stages.py holds the
    one-process steps against JAX); every rank logs the global loss."""
    from test_torch_parallel import _check_against_jax

    k = ONE_PROCESS.index(name)
    ranks = started["grid"].result()
    assert len({r[STEP0 + 3 + k]["aux"]["loss"] for r in ranks}) == 1
    want = started["one"].result()[1 + k]
    _check_against_jax(ranks[0][STEP0 + 3 + k], want["aux"]["loss"], want["grads"])


def test_grid_data_groups_average_their_slices(started):
    """dryrun_multigpu's check on the 2 x 2 grid: the all-reduced gradients
    are the sum of each data group's ranks' gradients on its slice of the
    global batch alone (their rows' shares), averaged over the data groups."""
    ranks = started["grid"].result()
    step = ranks[0][STEP0]
    assert dryrun.step_error(step, dryrun._mean_of([r[STEP0]["local"] for r in ranks], 2)) <= 1.0


def test_grid_bf16_step_within_the_bf16_gap(started):
    """--dtype bfloat16 on the 2 x 2 grid (halos and gathers of bf16 rows):
    each gradient's distance from the one-process fp32 step's within twice
    the one-process bf16 step's, as tests/test_torch_bf16.py holds the port
    to JAX's bf16 gap."""
    got = started["grid"].result()[0][STEP0 + 3]
    want, one16 = started["one"].result()[:2]
    np.testing.assert_allclose(got["aux"]["loss"], one16["aux"]["loss"], rtol=1e-5)
    for k, w in want["grads"].items():
        if w is None:
            assert got["grads"][k] is None, k
            continue
        gap, one_gap = np.linalg.norm(got["grads"][k] - w), np.linalg.norm(one16["grads"][k] - w)
        assert gap <= 2 * one_gap + 1e-6 * np.linalg.norm(w), (k, gap, one_gap)


def test_grid_remat_is_exact(started):
    """remat on the grid recomputes the forward, its halo exchanges
    included, in the backward: the same loss, gradients and Adam moments."""
    ranks = started["grid"].result()
    plain, remat = ranks[0][STEP0], ranks[0][STEP0 + 1]
    assert remat["aux"] == plain["aux"]
    for name, g in plain["grads"].items():
        if g is None:
            assert remat["grads"][name] is None, name
            continue
        np.testing.assert_array_equal(remat["grads"][name], g, err_msg=name)
        for a, b in zip(remat["adam"][name], plain["adam"][name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def _assembled(ranks, i, spatial):
    """Forward i's outputs, the ranks' rows in place: (batch, ., H, W)."""
    i += 1  # after the collectives
    data = 4 // spatial
    at = {(r[i]["d"], r[i]["s"]): r[i]["outputs"] for r in ranks}
    return {k: np.concatenate([_rows([at[d, s][k] for s in range(spatial)]) for d in range(data)])
            for k in at[0, 0]}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_grid_forward_matches_unsharded(started, name):
    """Each grid's rows, put together, are the unsharded forward's outputs,
    with whole levels and the non-2x deconvs on the path."""
    spatial, kw = FORWARDS[name]
    model = create_model(**kw, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(4, H, W, 0)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = model(x, MN, MX, ret_disp=True, ret_pan=True, ret_subocc=True)
    ranks = started["grid"].result()
    got = _assembled(ranks, list(FORWARDS).index(name), spatial)
    assert sorted(got) == sorted(OUTPUTS)
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k], getattr(want, k).float().numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    levels = ranks[0][1]["levels"]  # the 2x2 grid's
    assert levels.startswith("x0 48 rows split 24 a rank") and "x4 3 rows whole" in levels


def _jax_forward():
    """JAX's default model (phase deconvs) on make_2d_mesh(2, 2) with the
    batch's rows sharded (image_sharding), on the port's weights: its
    disp, pan and masks, NCHW."""
    import jax
    import jax.numpy as jnp

    from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
    from fal_net_tpu.models import create_model as jax_create_model
    from fal_net_tpu.models.torch_import import convert_state_dict
    from fal_net_tpu.parallel.spatial import image_sharding, make_2d_mesh, replicated

    mesh = make_2d_mesh(2, 2)
    model = jax_create_model("tiny", N, med_impl="reference")
    params = jax.device_put({"params": convert_state_dict(_port_sd(), JAX_VARIANTS["tiny"])}, replicated(mesh))
    x = jax.device_put(jnp.asarray(_images(4, H, W, 0)), image_sharding(mesh))
    out = jax.jit(lambda p, x: model.apply(p, x, MN, MX, ret_disp=True, ret_pan=True, ret_subocc=True))(params, x)
    return {k: np.asarray(getattr(out, k)).transpose(0, 3, 1, 2) for k in OUTPUTS}


def test_grid_forward_matches_jax(started):
    """The 2 x 2 grid's forward against JAX's on make_2d_mesh(2, 2) (see
    _jax_forward)."""
    got, want = _assembled(started["grid"].result(), 0, 2), started["forward"].result()
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 are the hand-written kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grid_launches_kernels_on_rows_on_gpu(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0 split the rows: K1 launches once in a forward
    and once in a stage-1 step per rank, on the rank's 16 of 32 rows, and K2
    once in the step."""
    cfg = Stage1Config(model="tiny", num_levels=N, crop_size=(SH, SW), batch_size=4, a_p=0.0, workers=1)
    calls = [(dryrun.rank_forward, (2, "cuda:0", _images(4, SH, SW, 0), MN, MX, dict(variant="tiny", num_levels=N)),
              dict(ret_pan=True)),
             (dryrun.rank_step, (cfg, "stage1", "cuda:0", DATASETS[0]), dict(spatial=2))]
    ranks = ddp.launch(dryrun.rank_calls, 2, (calls,), store_path=str(tmp_path / "store"), backend="gloo",
                       device="cuda:0", **GROUP)
    for fwd, step in ranks:
        assert fwd["k1"] == 1 and fwd["outputs"]["disp"].shape == (4, 1, SH // 2, SW)
        assert step["k1"] == 1 and step["k2"] == 1

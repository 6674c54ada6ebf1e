"""bf16 compute in the port vs the JAX package's bf16 models.

JAX builds its models with ``fuse_logits=True`` (its default) and the other
rewrites off, as tests/test_torch_models.py builds them; the weights are
carried into the port by ``models/jax_import.py``; inputs are seeded numpy
arrays.  Both sides round at different points (JAX's XLA fuses elementwise
work), so the port is held to JAX's own precision: its bf16 outputs lie
within 2x JAX's bf16-to-fp32 gap of JAX's fp32 outputs (max norm), and
every parameter gradient of the three stages within
2 ||g_jax,bf16 - g_jax,fp32||_2 + 1e-6 ||g_jax,fp32||_2 of g_jax,fp32.
The logits conv itself, bf16 operands composed once with fp32
accumulation, matches JAX's ``_conv_accum`` at rtol 1e-5, atol 1e-5 of its
largest magnitude, a bound that a bf16-rounded result fails.  A bf16
artifact equals the live bf16 model exactly on the CPU.
"""

from torch_lane import nchw
import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fal_net_tpu.models import VARIANTS as JAX_VARIANTS
from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.models.torch_import import convert_state_dict
from fal_net_tpu.models.layers import _conv_accum
from fal_net_tpu.train import stages as jax_stages
from fal_net_torch import serve
from fal_net_torch.cli import export as cli_export
from fal_net_torch.cli import test as cli_test
from fal_net_torch.cli import train as train_cli
from fal_net_torch.eval.evaluate import EvalConfig, Evaluator
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import load_checkpoint, read_state_dict, save_checkpoint
from fal_net_torch.models.falnet import composed_logits
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.train import stages
from test_torch_eval import raw_tree  # noqa: F401  (the Eigen tree fixture)
from test_torch_train import _write_tree

N, H, W, B = 5, 32, 64, 2
A_SM = 0.2 * 2 / 512
# The gradients are held on FAL_netB: on the tiny model's 8-channel tensors
# the ratio of two rounding errors' norms is noisy (over 8 seeds of stage 1,
# the port's gap over JAX's had a median of 0.95 but reached 2.6 on one
# 8-element bias), while B's widths make both norms sums of many errors.
GRAD_VARIANT = "B"


def _jax_model(variant, dtype, num_levels=N):
    return jax_create_model(variant, num_levels, dtype=dtype, med_impl="reference", s2d_stem=False,
                            stem_input_fuse=False, stem_flow_analytic=False, fuse_logits=True, phase_deconv=False)


def _port(variables, variant, dtype, num_levels=N):
    port = create_model(variant, num_levels, device="cpu", med_impl="reference", dtype=dtype)
    sd = state_dict_from_jax(variables["params"], variant)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port


class ConvDtypes(TorchDispatchMode):
    """Records (input, weight, output) dtypes of every aten convolution and
    of the logits conv op (fal_net_torch::logits_conv, L1), and whether the
    input and weight are bf16-exact."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.convolution.default, torch.ops.fal_net_torch.logits_conv.default):
            x, w = args[0], args[1]
            exact = lambda t: bool((t.to(torch.bfloat16).to(t.dtype) == t).all())
            self.calls.append((x.dtype, w.dtype, out.dtype, exact(x) and exact(w)))
        return out


@pytest.mark.parametrize("variant", ["A", "B", "tiny"])
def test_every_backbone_conv_runs_on_bf16(variant):
    """Every backbone conv (deconvs included) takes bf16 input and weights and
    gives bf16; the logits conv, the last, is the op L1 on bf16 operands and
    gives fp32.  The declared amask head never runs."""
    model = create_model(variant, N, device="cpu", dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules()) - 1  # conv0 composes into iconv1
    convs -= 2 if model.spec.has_amask else 0
    x = torch.randn(1, 3, H, W)
    with torch.no_grad(), ConvDtypes() as rec:
        out = model(x, 2.0, 300.0, ret_disp=True, ret_pan=True)
    bf16 = torch.bfloat16
    assert len(rec.calls) == convs
    assert all(c[:3] == (bf16, bf16, bf16) for c in rec.calls[:-1]), rec.calls
    assert rec.calls[-1] == (bf16, bf16, torch.float32, True)
    assert out.disp.dtype == out.pan.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_logits_conv_matches_conv_accum(rng):
    """composed_logits against JAX's composed kernel through _conv_accum on
    the same bf16 concat, plus the 1x1's fp32 bias."""
    cin, n = 12, 7
    x = jnp.asarray(rng.standard_normal((2, 16, 24, cin)), jnp.bfloat16)
    ki = rng.standard_normal((3, 3, cin, n)).astype(np.float32)  # HWIO
    k1 = rng.standard_normal((1, 1, n, n)).astype(np.float32)
    b1 = rng.standard_normal(n).astype(np.float32)
    kc = jnp.einsum("abim,mo->abio", ki, k1[0, 0])
    want = np.asarray(_conv_accum(x, kc.astype(jnp.bfloat16), (1, 1), ((1, 1), (1, 1)), jnp.float32) + b1)
    conv1x1 = torch.nn.Conv2d(n, n, 1)
    with torch.no_grad():
        conv1x1.weight.copy_(torch.from_numpy(k1.transpose(3, 2, 0, 1).copy()))
        conv1x1.bias.copy_(torch.from_numpy(b1))
        xt = torch.from_numpy(nchw(x.astype(jnp.float32))).to(torch.bfloat16)
        got = composed_logits(xt, torch.from_numpy(ki.transpose(3, 2, 0, 1).copy()), conv1x1)
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), nchw(want), **tol)
    rounded = got.to(torch.bfloat16).float().numpy()
    assert not np.allclose(rounded, nchw(want), **tol)  # the bound sees a bf16 rounding


def _seeded_variables(variant, seed):
    """JAX variables of a seeded port model's weights (fp32, as JAX keeps
    them in either dtype)."""
    model = create_model(variant, N, device="cpu", generator=torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return {"params": convert_state_dict(sd, JAX_VARIANTS[variant])}


@pytest.fixture(scope="module")
def variables():
    return {v: _seeded_variables(v, 0) for v in ("A", "B", "C", "tiny")}


@pytest.mark.parametrize("variant", ["A", "B", "C"])
def test_forward_within_jaxs_bf16_gap(variables, variant, rng):
    x = (rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32)
    outs = {}
    for dt in (jnp.float32, jnp.bfloat16):
        out, inter = jax.jit(lambda v, x: _jax_model(variant, dt).apply(
            v, x, 2.0, 30.0, ret_disp=True, ret_pan=True, capture_intermediates=True,
            mutable=["intermediates"]))(variables[variant], jnp.asarray(x))
        logits = inter["intermediates"]["backbone"]["__call__"][0]
        outs[dt] = {k: nchw(v).astype(np.float32)
                    for k, v in (("logits", logits), ("disp", out.disp), ("pan", out.pan))}
    ports = {}
    for dt in ("float32", "bfloat16"):
        port = _port(variables[variant], variant, dt)
        with torch.no_grad():
            left = torch.from_numpy(nchw(x))
            out = port(left, 2.0, 30.0, ret_disp=True, ret_pan=True)
            ports[dt] = {"logits": port.logits(left, 30.0).numpy(), "disp": out.disp.numpy(), "pan": out.pan.numpy()}
    for k in ("logits", "disp", "pan"):
        want32, want16 = outs[jnp.float32][k], outs[jnp.bfloat16][k]
        gap = np.abs(want16 - want32).max()
        assert gap > 0, k
        err = np.abs(ports["bfloat16"][k] - want32).max()
        assert err <= 2 * gap, (k, err, gap)
    assert np.abs(ports["bfloat16"]["logits"] - ports["float32"]["logits"]).max() > 0


def _stage_loss_and_grads(stage, variables, teacher_vars, batch_np, dtype, variant=GRAD_VARIANT):
    """JAX: loss and the grads as a port state_dict of numpy arrays."""
    model = _jax_model(variant, dtype)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=A_SM * 50)
    if stage == "stage1":
        f = lambda p: jax_stages.stage1_loss(p, jb, model.apply, **kw)
    elif stage == "stage1_slow":
        f = lambda p: jax_stages.stage1_slow_loss(p, jb, model.apply, **kw)
    else:
        f = lambda p: jax_stages.stage2_loss(p, jb, model.apply, model.apply, teacher_vars, a_mr=1.0, **kw)
    (loss, _), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables)
    return float(loss), state_dict_from_jax(jax.device_get(grads["params"]), variant)


@pytest.mark.parametrize("stage", ["stage1", "stage1_slow", "stage2"])
def test_stage_gradients_within_jaxs_bf16_gap(variables, stage, rng):
    student = variables[GRAD_VARIANT]
    teacher = _seeded_variables(GRAD_VARIANT, 1)
    batch = {k: (rng.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32) for k in ("left", "right")}
    loss32, g32 = _stage_loss_and_grads(stage, student, teacher, batch, jnp.float32)
    loss16, g16 = _stage_loss_and_grads(stage, student, teacher, batch, jnp.bfloat16)

    port = _port(student, GRAD_VARIANT, "bfloat16")
    tb = {k: torch.from_numpy(nchw(v)) for k, v in batch.items()}
    kw = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=A_SM * 50)
    if stage == "stage1":
        loss, _ = stages.stage1_loss(port, tb, **kw)
    elif stage == "stage1_slow":
        loss, _ = stages.stage1_slow_loss(port, tb, **kw)
    else:
        t = _port(teacher, GRAD_VARIANT, "bfloat16").requires_grad_(False)
        loss, _ = stages.stage2_loss(port, tb, t, a_mr=1.0, **kw)
    loss.backward()
    assert abs(loss.item() - loss32) <= 2 * abs(loss16 - loss32) + 1e-6 * abs(loss32)
    got = dict(port.named_parameters())
    assert got.keys() == g32.keys()
    for k, want in g32.items():
        if got[k].grad is None:  # the declared amask head, never run: zero in JAX
            assert "amask" in k and not np.any(want) and not np.any(g16[k]), k
            continue
        port_gap = np.linalg.norm(got[k].grad.numpy() - want)
        jax_gap = np.linalg.norm(g16[k] - want)
        assert port_gap <= 2 * jax_gap + 1e-6 * np.linalg.norm(want), (k, port_gap, jax_gap)
        assert got[k].grad.dtype == torch.float32


def test_cli_train_bf16(tmp_path):
    """cli.train --dtype bfloat16 --device cpu: finite losses; the checkpoint
    and Adam's state stay fp32; stage 2 from it with a bf16 teacher."""
    root = _write_tree(tmp_path, n_pairs=4)
    common = ["--data_root", root, "--lists_dir", root, "--model", "tiny", "--no_levels", str(N), "--a_p", "0",
              "--device", "cpu", "--epochs", "1", "--batch_size", "2", "--crop_height", str(H), "--crop_width",
              str(W), "--workers", "1", "--dtype", "bfloat16", "--save_path", str(tmp_path / "runs")]
    result = train_cli.main(common)
    assert np.isfinite(result["history"][0]["loss"])
    data = torch.load(result["checkpoint"], weights_only=True)
    assert all(v.dtype == torch.float32 for v in data["state_dict"].values())
    assert all(t.dtype == torch.float32 for st in data["optimizer"]["state"].values() for t in st.values()
               if torch.is_tensor(t) and t.ndim > 0)
    result2 = train_cli.main(common + ["--stage", "2", "--fix_model", result["checkpoint"], "--batch_size", "2"])
    assert np.isfinite(result2["history"][0]["loss"])


def test_cli_test_bf16(raw_tree, tmp_path):  # noqa: F811
    """cli.test --dtype bfloat16: finite metrics, equal to an in-process
    Evaluator's on the bf16 model, and not the fp32 model's."""
    model = create_model("tiny", N, device="cpu", generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, model)
    base = ["--data_root", str(raw_tree), "--lists_dir", str(raw_tree / "lists"), "--pretrained", ckpt,
            "--device", "cpu", "--batch_size", "2"]
    got = cli_test.main(base + ["--dtype", "bfloat16", "--save_path", str(tmp_path / "bf16")])
    fp32 = cli_test.main(base + ["--save_path", str(tmp_path / "fp32")])
    assert all(np.isfinite(v) for k, v in got.items() if k != "sec_per_image")
    from fal_net_torch.data.datasets import kitti_eigen_test_improved

    _, ds = kitti_eigen_test_improved(str(raw_tree), split=0, lists_dir=str(raw_tree / "lists"))
    ds.raw_uint8 = True
    want = Evaluator(model.with_dtype("bfloat16"), EvalConfig(batch_size=2, save_path=str(tmp_path / "ev"))).run(ds)
    for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"):
        assert got[k] == want[k], k
    assert got["abs_rel"] != fp32["abs_rel"]


def test_bf16_artifact_equals_the_live_model(tmp_path, rng):
    """cli.export --dtype bfloat16: meta dtype bfloat16, the op in the
    graph, outputs equal to the live bf16 model's exactly on the CPU."""
    model = create_model("tiny", N, device="cpu", generator=torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, model)
    out = str(tmp_path / "bf16.pt2z")
    cli_export.main(["--pretrained", ckpt, "--dtype", "bfloat16", "--height", str(H), "--width", str(W),
                     "--batch", "2", "--pan", "--subocc", "--device", "cpu", "--out", out])
    fwd = serve.load_exported(out, device="cpu")
    assert fwd.meta["dtype"] == "bfloat16"
    with zipfile.ZipFile(out) as z:
        program = torch.export.load(io.BytesIO(z.read("program_0.pt2")))
        assert json.loads(z.read("meta.json"))["programs"][0]["dtype"] == "bfloat16"
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("fal_net_torch.med_fwd.default") == 1
    x = torch.from_numpy((rng.standard_normal((2, H, W, 3)) * 0.3).astype(np.float32))
    live = load_checkpoint(ckpt, device="cpu", dtype="bfloat16")
    with torch.no_grad():
        want = live(x.permute(0, 3, 1, 2).contiguous(), 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
        fp32 = model(x.permute(0, 3, 1, 2).contiguous(), 2.0, 300.0, ret_disp=True)
    got = fwd(x)
    for g, w in zip(got, (want.disp, want.pan, want.maskL, want.maskR)):
        torch.testing.assert_close(g, w.permute(0, 2, 3, 1), rtol=0, atol=0)
    assert not torch.equal(got[0], fp32.disp.permute(0, 2, 3, 1))
    # the same through serve.export_forward on the fp32 model computing in bf16
    blob = serve.export_forward(model.with_dtype("bfloat16"), batch=2, height=H, width=W, device="cpu")
    path = str(tmp_path / "b.pt2z")
    serve.save_exported(path, blob)
    torch.testing.assert_close(serve.load_exported(path, device="cpu")(x)[0], want.disp.permute(0, 2, 3, 1),
                               rtol=0, atol=0)
    assert os.path.getsize(path) > 0 and read_state_dict(ckpt).keys() == model.state_dict().keys()

"""The fp32 backbone's storage: channels-last on the card, NCHW elsewhere.

Shapes are NCHW everywhere.  On the card with no row shard, the fp32
backbone holds its activations and conv weights channels-last
(models/layers.py, models/falnet.py), so cuDNN runs its NHWC kernels with no
transposes; bf16, row shards and the CPU keep NCHW.

On the CPU (a model moved to channels-last storage by hand, as
``create_model`` places it on the card):
- ``load_state_dict`` from an NCHW state dict keeps the storage, and
  ``state_dict()`` gives the same values and keys; ``place`` on the CPU
  brings NCHW back;
- every backbone conv and the composed logits conv see channels-last
  input and weights (conv1's input channels and the logits conv's output
  channels with zeros up to a multiple of 8), the logits come back NCHW,
  and they and every parameter gradient equal the NCHW model's (fp32 at
  rtol 1e-4, atol 1e-4 of the largest magnitude: the same sums, in
  oneDNN's other order for the other storage);
- ``with_dtype(torch.bfloat16)`` hands every conv NCHW weights and inputs;
- a ``torch.export`` program traced on NCHW weights with a channels-last
  image takes the channels-last path and equals the channels-last model;
- ``ToNCHW`` and ``nearest_up2`` are exact.

On a card (``cuda`` marker), FAL_netB N=49 and FAL_netA N=33 at (2, 3, 64,
128): every conv of the fp32 forward sees channels-last input and weights;
the bf16 model's convs see NCHW; with TF32 off, the logits and disp equal
the same weights' on the CPU (logits rtol/atol 1e-3, disp rtol 1e-3 / atol
5e-3: tests/test_torch_models.py's fp32 tolerances), and one stage-1
``Trainer.train_step`` gives the CPU's loss (rtol 1e-5) and every parameter
gradient within 1e-4 of that tensor's largest magnitude
(tests/test_torch_train.py's tolerances), on a batch whose loss has no
kink in reach (see the test).
"""

from torch_lane import cuda_device  # noqa: F401  (cuda_device: a fixture)
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fal_net_torch.models import create_model
from fal_net_torch.models.falnet import composed_logits
from fal_net_torch.models.layers import Conv2d, ToNCHW, channels_last_storage, nearest_up2, padded_channels
from fal_net_torch.utils.device import place

H, W, B = 64, 128, 2
CL = torch.channels_last


def _model(variant, levels, device="cpu", seed=0, **kw):
    return create_model(variant, levels, device=device, generator=torch.Generator().manual_seed(seed), **kw)


def _images(seed, *shape):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32))


def channels_last(t):
    """Held in channels-last storage, and not also in NCHW's."""
    return not t.is_contiguous() and t.is_contiguous(memory_format=CL)


def _conv_weights(model):
    return {n: p for n, p in model.named_parameters() if p.dim() == 4 and p.shape[-2:] != (1, 1)}


@contextlib.contextmanager
def _recorded(monkeypatch, name):
    """Every call of ``F.<name>`` as (input, weight), the call itself run."""
    calls, real = [], getattr(F, name)

    def record(x, w, *args, **kw):
        calls.append((x, w))
        return real(x, w, *args, **kw)

    with monkeypatch.context() as m:
        m.setattr(F, name, record)
        yield calls


# ---- on the CPU ----


@pytest.mark.parametrize("variant,levels", [("tiny", 5), ("A", 9)])
def test_load_state_dict_keeps_channels_last(variant, levels):
    """A model in channels-last storage loads an NCHW state dict into its
    parameters in place: the storage stays, and state_dict() gives the
    loaded values under the same keys; place() on the CPU brings NCHW back
    with the same values."""
    src = _model(variant, levels, seed=1).state_dict()
    model = _model(variant, levels).to(memory_format=CL)
    params = {n: p for n, p in model.named_parameters()}
    model.load_state_dict(src)
    for n, p in _conv_weights(model).items():
        assert channels_last(p) and p is params[n], n
    got = model.state_dict()
    assert list(got) == list(src)
    for k, v in src.items():
        assert torch.equal(got[k], v), k
    place(model, "cpu")
    assert all(p.is_contiguous() for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, src[k]), k


@pytest.mark.parametrize("variant,levels", [("tiny", 5), ("A", 9), ("B", 9)])
def test_channels_last_backbone_matches_nchw_on_cpu(monkeypatch, variant, levels):
    """The backbone fed a channels-last image with its weights channels-last,
    as ``FalNet.logits`` feeds it on the card: every conv, the composed
    logits conv included, sees channels-last input and weights, conv1's
    input and weight with zero channels up to 8 * k, the logits conv's
    output channels likewise; the logits come back NCHW and equal the NCHW
    model's, and so do the parameters' gradients, held channels-last."""
    nchw = _model(variant, levels)
    cl = _model(variant, levels).to(memory_format=CL)
    x = _images(0, B, 3, H, W)
    flow = torch.tensor(0.3).reshape(1, 1, 1, 1).expand(B, 1, H, W)
    r = _images(1, B, levels, H, W)

    def logits(model, x, flow):
        backbone = model.get_submodule(model.spec.torch_backbone_key)
        return composed_logits(backbone.features(x, flow).x, backbone.iconv1.weight, model.conv0)

    want = logits(nchw, x, flow)
    (want * r).sum().backward()
    with _recorded(monkeypatch, "conv2d") as calls, channels_last_storage():
        got = logits(cl, x.contiguous(memory_format=CL), flow)
    # every Conv2d but iconv1, the 1x1 and the amask head's two (never run), and the composed conv
    assert len(calls) == sum(isinstance(m, Conv2d) for m in cl.modules()) - 1 - 2 * cl.spec.has_amask
    for i, (xi, wi) in enumerate(calls):
        assert xi.is_contiguous(memory_format=CL) and channels_last(wi) and xi.shape[1] == wi.shape[1], i
    assert calls[3][0].shape[1] == padded_channels(32 + 1)  # conv1: x0 and the flow plane, after conv0 and conv0_1
    assert calls[-1][1].shape[0] == padded_channels(levels)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.detach().abs().max()))
    (got * r).sum().backward()
    grads = {n: p.grad for n, p in nchw.named_parameters()}
    for n, p in cl.named_parameters():
        assert (p.grad is None) == (grads[n] is None), n
        if p.grad is not None:
            assert p.dim() < 4 or p.grad.is_contiguous(memory_format=CL), n
            torch.testing.assert_close(p.grad, grads[n], rtol=1e-4, atol=1e-4 * float(grads[n].abs().max()), msg=n)


def test_exported_program_takes_the_channels_last_path(monkeypatch):
    """The layers decide by ``channels_last_storage``, not by strides: a
    program exported under it from a model whose weights are NCHW (on the
    card, ``torch.export``'s fake convolutions come out NCHW too) takes the
    channels-last path, conv1's padding and the relayout of the logits
    included, and computes what the channels-last model computes, exactly;
    outside it the same model keeps NCHW."""
    nchw = _model("tiny", 5)
    cl = _model("tiny", 5).to(memory_format=CL)
    x = _images(0, B, 3, H, W)

    class Logits(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            b, _, h, w = x.shape
            backbone = self.model.backbone
            flow = torch.full((1, 1, 1, 1), 0.3).expand(b, 1, h, w)
            with channels_last_storage():
                feats = backbone.features(x.contiguous(memory_format=CL), flow).x
                return composed_logits(feats, backbone.iconv1.weight, self.model.conv0)

    with torch.no_grad():
        want = Logits(cl)(x)
        program = torch.export.export(Logits(nchw), (x,), strict=False)
        got = program.module()(x)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "aten.upsample_nearest2d.vec" not in ops and ops.count("aten.pad.default") == 3
    assert got.is_contiguous() and torch.equal(got, want)
    with torch.no_grad(), _recorded(monkeypatch, "conv2d") as calls:
        cl.logits(x.contiguous(memory_format=CL), 30.0)  # on the CPU: no mode, whatever the strides
    assert calls[3][0].shape[1] == 33 and calls[-1][1].shape[0] == 5


@pytest.mark.parametrize("phase_deconv", [False, True])
def test_bf16_convs_take_nchw_weights(monkeypatch, phase_deconv):
    """``with_dtype(torch.bfloat16)`` of a model whose weights are
    channels-last hands every conv contiguous-format bf16 weights and NCHW
    inputs, as the bf16 path had before (L1's pitched rows need NCHW).  On
    the CPU the last conv is L1's plain version, in fp32 on the bf16
    operands."""
    model = _model("tiny", 5, phase_deconv=phase_deconv).to(memory_format=CL).with_dtype(torch.bfloat16)
    x = _images(0, B, 3, H, W)
    with torch.no_grad(), _recorded(monkeypatch, "conv2d") as convs, \
            _recorded(monkeypatch, "conv_transpose2d") as deconvs:
        model.logits(x, 30.0)
    (_, k), convs = convs[-1], convs[:-1]
    assert k.shape == (5, 8 + 32, 3, 3) and k.is_contiguous()
    assert convs and bool(deconvs) == phase_deconv
    for i, (xi, wi) in enumerate(convs + deconvs):
        assert wi.dtype == torch.bfloat16 and xi.dtype == torch.bfloat16, i
        assert xi.is_contiguous() and not channels_last(xi), i
        assert not channels_last(wi), i
    for i, (_, wi) in enumerate(convs):
        assert wi.is_contiguous(), i


@pytest.mark.parametrize("shape,c", [((2, 56, 8, 12), 49), ((2, 40, 5, 7), 33), ((1, 8, 3, 5), 5)])
def test_to_nchw_relays_the_first_channels(shape, c):
    """ToNCHW: the first ``c`` channels of a channels-last tensor, NCHW and
    exact, through 32-pixel tiles (8 x 12) or image rows (H * W not a
    multiple of 32); its backward: the cotangent in channels-last storage,
    zeros past ``c``."""
    x = _images(0, *shape).contiguous(memory_format=CL).requires_grad_()
    y = ToNCHW.apply(x, c)
    assert y.is_contiguous() and torch.equal(y, x.detach()[:, :c])
    g = _images(1, shape[0], c, *shape[2:])
    y.backward(g)
    assert x.grad.is_contiguous(memory_format=CL)
    assert torch.equal(x.grad[:, :c], g) and not x.grad[:, c:].any()


def test_nearest_up2_matches_interpolate():
    """nearest_up2 of a channels-last tensor: F.interpolate's nearest 2x,
    exactly, in channels-last storage; the backward (a sum over each 2x2
    block) within fp32 rounding of F.interpolate's."""
    x = _images(0, 2, 16, 6, 10).contiguous(memory_format=CL)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = nearest_up2(a), F.interpolate(b, scale_factor=2, mode="nearest")
    assert channels_last(got) and torch.equal(got, want)
    g = _images(1, 2, 16, 12, 20)
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(a.grad, b.grad)
    assert [padded_channels(c) for c in (1, 8, 33, 49)] == [8, 8, 40, 56]


# ---- on the card (marked cuda; the GPU lane runs without tests/conftest.py) ----

GPU_MODELS = [("B", 49), ("A", 33)]
STAGE1 = dict(min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=0.2 * 2 / 512 * 50)  # as tests/test_torch_train.py


@pytest.mark.cuda
@pytest.mark.parametrize("variant,levels", GPU_MODELS)
def test_fp32_convs_run_channels_last_on_gpu(monkeypatch, cuda_device, variant, levels):
    """create_model on the card holds the conv weights channels-last; every
    backbone Conv2d and the composed logits conv see channels-last input and
    weights; the logits reach K1 in NCHW."""
    model = _model(variant, levels, device=cuda_device).eval()
    for n, p in _conv_weights(model).items():
        assert channels_last(p), n
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, Conv2d):
            m.register_forward_hook(lambda m, i, o, name=name: seen.append(
                (name, i[0].is_contiguous(memory_format=CL) and channels_last(m.weight))))
    x = _images(0, B, 3, H, W).to(cuda_device)
    with torch.no_grad(), _recorded(monkeypatch, "conv2d") as calls:
        out = model(x, 2.0, 300.0, ret_disp=True)
    assert seen and all(ok for _, ok in seen), [n for n, ok in seen if not ok]
    x_logits, k = calls[-1]  # the composed logits conv, the forward's last
    assert k.shape[:2] == (padded_channels(levels), model.spec.deconv[5] + 32)
    assert x_logits.is_contiguous(memory_format=CL) and channels_last(k)
    assert all(xi.is_contiguous(memory_format=CL) and channels_last(wi) for xi, wi in calls)
    assert out.disp.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("variant,levels", GPU_MODELS)
def test_bf16_convs_keep_nchw_on_gpu(monkeypatch, cuda_device, variant, levels):
    """The same model in bf16: every conv sees NCHW input and weights, and
    the logits conv is L1 on the pitched concat."""
    from fal_net_torch.ops import _build
    from fal_net_torch.ops.logits_conv import LAUNCHES

    model = _model(variant, levels, device=cuda_device).eval().with_dtype(torch.bfloat16)
    x = _images(0, B, 3, H, W).to(cuda_device)
    _build.load_library()
    before = LAUNCHES["logits_conv"]
    with torch.no_grad(), _recorded(monkeypatch, "conv2d") as calls:
        model.logits(x, 300.0)
    torch.cuda.synchronize()
    assert LAUNCHES["logits_conv"] == before + 1
    assert calls
    for i, (xi, wi) in enumerate(calls):
        assert xi.dtype == wi.dtype == torch.bfloat16, i
        assert xi.is_contiguous() and wi.is_contiguous(), i


@pytest.mark.cuda
@pytest.mark.parametrize("variant,levels", GPU_MODELS)
def test_fp32_forward_matches_cpu_on_gpu(cuda_device, variant, levels):
    """TF32 off: the card's channels-last logits and disp against the same
    weights' NCHW forward on the CPU."""
    from fal_net_torch.utils.timing import tf32

    cpu = _model(variant, levels).eval()
    gpu = _model(variant, levels, device=cuda_device).eval()
    gpu.load_state_dict(cpu.state_dict())
    x = _images(0, B, 3, H, W)
    with torch.no_grad():
        want_logits, want = cpu.logits(x, 300.0), cpu(x, 2.0, 300.0, ret_disp=True).disp
        with tf32(False):
            got_logits = gpu.logits(x.to(cuda_device), 300.0).cpu()
            got = gpu(x.to(cuda_device), 2.0, 300.0, ret_disp=True).disp.cpu()
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=5e-3)


class _Pairs:
    """A training set that is never read: the trainer's loader and schedule
    take its length; the test feeds its batch to ``train_step``."""

    def __len__(self):
        return 64

    def get(self, i, rng=None):
        raise RuntimeError("the test feeds device batches; the loader is not read")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,levels", GPU_MODELS)
def test_stage1_train_step_matches_cpu_on_gpu(cuda_device, variant, levels):
    """TF32 off: one stage-1 ``Trainer.train_step`` on the card (channels-last
    forward and backward, K1 and K2) against the same step on the CPU (NCHW,
    the plain head): the loss and every parameter gradient; the card's
    gradients keep their parameters' storage.  The loss has no kink in
    reach: the right image is 2 above any pan value, so the L1 residual
    keeps its sign, and the smoothness term (an L1 of disparity gradients)
    is off.  Where a residual near 0 takes one sign on the CPU and the other
    on the card, its gradient flips, and every parameter's gradient moves
    with it, in NCHW storage too (FAL_netA at other images: 3.8e-3 of
    conv0's largest magnitude, on the H100 either way)."""
    from fal_net_torch.train import Stage1Config, Trainer
    from fal_net_torch.utils.timing import tf32

    cfg = dict(model=variant, num_levels=levels, batch_size=B, crop_size=(H, W), workers=1, seed=0,
               **dict(STAGE1, a_sm=0.0))
    batch = {"left": _images(2, B, 3, H, W), "right": _images(3, B, 3, H, W) + 2.0}
    init = _model(variant, levels, seed=1).state_dict()
    steps = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda_device)):
        trainer = Trainer(Stage1Config(**cfg), "stage1", device=dev, train_dataset=_Pairs())
        trainer.setup()
        trainer.model.load_state_dict(init)
        with tf32(False):
            aux = trainer.train_step({k: v.to(dev) for k, v in batch.items()})
        steps[name] = (aux["loss"], {n: (p.grad, channels_last(p)) for n, p in trainer.model.named_parameters()})
    np.testing.assert_allclose(steps["gpu"][0], steps["cpu"][0], rtol=1e-5)
    for n, (g, held_cl) in steps["gpu"][1].items():
        w = steps["cpu"][1][n][0]
        assert held_cl == (n in _conv_weights(trainer.model)), n
        assert (g is None) == (w is None), n
        if w is not None:
            assert channels_last(g) == held_cl, n
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=lambda m, n=n: f"{n}: {m}")

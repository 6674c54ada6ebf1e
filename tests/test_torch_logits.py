"""The logits conv: JAX's ``fuse_logits`` + ``_conv_accum`` in the port.

Both dtypes take one path (models/falnet.py::composed_logits): iconv1 and
the 1x1 composed in fp32, rounded once to the compute dtype, one conv with
fp32 sums and output, plus the fp32 bias; in bf16 that conv is L1
(``fal_net_torch::logits_conv``, ops/logits_conv.py), whose plain version
runs here on the CPU.  Inputs are seeded numpy arrays shared with JAX.
The JAX package is imported inside the CPU tests: the card's lane
(``-m cuda --noconftest``) has no flax.

Tolerances:
  * the whole model's logits against JAX's ``create_model(...,
    fuse_logits=True)`` (the other rewrites off, as
    tests/test_torch_models.py builds JAX's models): fp32 at rtol 1e-3,
    atol 1e-3 as that file holds them; bf16 within twice JAX's own
    bf16-to-fp32 gap of JAX's fp32 logits, as tests/test_torch_bf16.py
    holds bf16 outputs (the two backbones round bf16 at other points, a
    difference of whole bf16 ulps);
  * the composed conv on one bf16 concat against JAX's ``_conv_accum``:
    forward rtol 1e-5, atol 1e-5 max|want| (tests/test_torch_bf16.py's
    bound: only the order of the fp32 sums differs); gradients rtol 1.6e-2
    (two bf16 ulps, since both sides round dx and dk to bf16) plus atol
    1e-3 max|want|;
  * halo rows (pad_h 0) against the padded conv's rows: rtol 1e-6, atol
    1e-6 max|want| (the same sums).
"""

from torch_lane import cuda_device, nchw  # noqa: F401  (cuda_device: a fixture)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fal_net_torch.models import create_model
from fal_net_torch.models.falnet import composed_logits
from fal_net_torch.models.jax_import import state_dict_from_jax
from fal_net_torch.ops import _build
from fal_net_torch.ops.logits_conv import LAUNCHES, logits_conv, logits_conv_plain, pitched_cat, pitched_empty
from fal_net_torch.parallel import spatial

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1.6e-2, 1e-3
# the whole model's logits as tests/test_torch_models.py holds them
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)


def _on_pitch(x):
    """Whether ``x``'s rows are dense on L1's 16-byte pitch, as the CUDA
    impl requires: unit column stride, row, channel and batch strides and
    the data pointer multiples of 8 bf16 elements."""
    return x.dim() == 4 and x.stride(3) == 1 and all(s % 8 == 0 for s in x.stride()[:3]) and \
        x.data_ptr() % 16 == 0


def _pitched(x):
    """A copy of ``x`` on L1's pitch, as the model builds its concat."""
    return pitched_empty(x.shape, x).copy_(x)


def _jax_fused(variant, num_levels, dtype):
    from fal_net_tpu.models import create_model as jax_create_model  # flax: the CPU lane only

    return jax_create_model(variant, num_levels, dtype=dtype, med_impl="fused", med_interpret=True, s2d_stem=False,
                            stem_input_fuse=False, stem_flow_analytic=False, fuse_logits=True, phase_deconv=False)


def _jax_logits(variant, num_levels, dtype, x, params=None):
    """JAX's fused logits (the backbone's output under fuse_logits) and its
    variables; ``params`` from an earlier call, else initialized."""
    jax_model = _jax_fused(variant, num_levels, dtype)
    variables = params or jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), 2.0, 300.0, ret_disp=True)
    _, inter = jax_model.apply(variables, jnp.asarray(x), 2.0, 300.0, ret_disp=True, capture_intermediates=True,
                               mutable=["intermediates"])
    return nchw(inter["intermediates"]["backbone"]["__call__"][0]).astype(np.float32), variables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant,h,w", [("B", 64, 128), ("tiny", 32, 64), ("tiny", 32, 68)])
def test_model_logits_match_jax_fused(rng, variant, h, w, dtype):
    """FalNet.logits in fp32 and bf16 against JAX's fused logits on the same
    weights and image: fp32 at MODEL_TOL; bf16, whose backbone rounds at
    other points than XLA's fused bf16 graph, within twice JAX's own
    bf16-to-fp32 gap of JAX's fp32 logits (tests/test_torch_bf16.py's
    bound), since MODEL_TOL is below one bf16 ulp of the activations."""
    num_levels = 9
    x = (rng.standard_normal((2, h, w, 3)) * 0.3).astype(np.float32)
    want32, variables = _jax_logits(variant, num_levels, jnp.float32, x)
    port = create_model(variant, num_levels, device="cpu", dtype=dtype)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"], variant).items()})
    with torch.no_grad():
        got = port.logits(torch.from_numpy(nchw(x)), 300.0)
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want32, **MODEL_TOL)
        return
    want16, _ = _jax_logits(variant, num_levels, jnp.bfloat16, x, variables)
    gap = np.abs(want16 - want32).max()
    assert 0 < np.abs(got.numpy() - want32).max() <= 2 * gap


def _conv_case(rng, cin, n):
    x = jnp.asarray(rng.standard_normal((2, 10, 14, cin)), jnp.bfloat16)  # NHWC, as JAX's concat
    ki = (rng.standard_normal((3, 3, cin, n)) / np.sqrt(9 * cin)).astype(np.float32)  # HWIO
    k1 = (rng.standard_normal((1, 1, n, n)) / np.sqrt(n)).astype(np.float32)
    b1 = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal((2, 10, 14, n)).astype(np.float32)
    return x, ki, k1, b1, g


def _jax_fused_conv(x, ki, k1, b1):
    """JAX's fused logits (fal_net_tpu/models/backbone.py:325-333)."""
    from fal_net_tpu.models.layers import _conv_accum  # flax: the CPU lane only

    kc = jnp.einsum("abim,mo->abio", ki, k1[0, 0])
    return _conv_accum(x, kc.astype(x.dtype), (1, 1), ((1, 1), (1, 1)), jnp.float32) + b1.astype(jnp.float32)


def _port_conv(x, ki, k1, b1):
    xt = torch.from_numpy(nchw(x.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    wi = torch.from_numpy(ki.transpose(3, 2, 0, 1).copy()).requires_grad_()
    conv1x1 = torch.nn.Conv2d(k1.shape[-1], k1.shape[-1], 1)
    with torch.no_grad():
        conv1x1.weight.copy_(torch.from_numpy(k1.transpose(3, 2, 0, 1).copy()))
        conv1x1.bias.copy_(torch.from_numpy(b1))
    return xt, wi, conv1x1


def _close(got, want, rtol, atol_of_max, label):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_max * float(np.abs(want).max()), err_msg=label)


@pytest.mark.parametrize("cin,n", [(12, 7), (96, 49)])
def test_composed_conv_and_grads_match_jax(rng, cin, n):
    """composed_logits on a bf16 concat against JAX's composed kernel through
    _conv_accum: the fp32 output, and the VJP for the concat, iconv1, the
    1x1 and its bias (jax.vjp through the fused path)."""
    x, ki, k1, b1, g = _conv_case(rng, cin, n)
    want, vjp = jax.vjp(_jax_fused_conv, x, jnp.asarray(ki), jnp.asarray(k1), jnp.asarray(b1))
    dx, dki, dk1, db1 = vjp(jnp.asarray(g))
    assert dx.dtype == jnp.bfloat16

    xt, wi, conv1x1 = _port_conv(x, ki, k1, b1)
    got = composed_logits(xt, wi, conv1x1)
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), nchw(want), FWD_TOL, FWD_TOL, "forward")
    got.backward(torch.from_numpy(nchw(g)))
    assert xt.grad.dtype == torch.bfloat16 and wi.grad.dtype == conv1x1.weight.grad.dtype == torch.float32
    _close(xt.grad.float().numpy(), nchw(dx).astype(np.float32), GRAD_RTOL, GRAD_ATOL, "d concat")
    _close(wi.grad.numpy(), np.asarray(dki).transpose(3, 2, 0, 1), GRAD_RTOL, GRAD_ATOL, "d iconv1")
    _close(conv1x1.weight.grad.numpy(), np.asarray(dk1).transpose(3, 2, 0, 1), GRAD_RTOL, GRAD_ATOL, "d 1x1")
    _close(conv1x1.bias.grad.numpy(), np.asarray(db1), GRAD_RTOL, GRAD_ATOL, "d bias")


@pytest.mark.parametrize("lo,hi", [(3, 7), (0, 4), (6, 10)])
def test_halo_rows_equal_padded_rows(rng, lo, hi):
    """pad_h 0 on rows [lo - 1, hi + 1) (a zero row past either edge, as a
    row shard's halo) gives rows [lo, hi) of the pad_h 1 conv."""
    x = torch.from_numpy(rng.standard_normal((2, 12, 10, 24)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((7, 12, 3, 3)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    want = logits_conv(x, k, b, 1)[:, :, lo:hi]
    zero = x.new_zeros((2, 12, 1, 24))
    rows = torch.cat([zero, x, zero], dim=2)[:, :, lo : hi + 2]  # padded row i + 1 is x's row i
    got = logits_conv(rows.contiguous(), k, b, 0)
    assert got.shape == want.shape
    _close(got.numpy(), want.numpy(), 1e-6, 1e-6, "halo rows")


@pytest.mark.parametrize("pad_h", [0, 1])
def test_logits_conv_opcheck(rng, pad_h):
    """torch.library.opcheck on the op on the CPU (schema, autograd
    registration, fake impl, AOT dispatch), at an odd channel count."""
    x = torch.from_numpy(rng.standard_normal((2, 13, 6, 9)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((5, 13, 3, 3)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    torch.library.opcheck(torch.ops.fal_net_torch.logits_conv.default,
                          (x.requires_grad_(), k.requires_grad_(), b.requires_grad_(), pad_h))
    assert torch.equal(logits_conv(x, k, b, pad_h), logits_conv_plain(x, k, b, pad_h))


@pytest.mark.parametrize("pad_h", [0, 1])
def test_logits_conv_opcheck_pitched(rng, pad_h):
    """opcheck on the op with x as the model hands it at W % 8 != 0: a view
    of a buffer whose rows are padded to 8 columns (on L1's pitch, not
    contiguous)."""
    x = _pitched(torch.from_numpy(rng.standard_normal((2, 16, 6, 9)).astype(np.float32)).to(torch.bfloat16))
    assert _on_pitch(x) and not x.is_contiguous() and x.stride(2) == 16
    k = torch.from_numpy(rng.standard_normal((5, 16, 3, 3)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    torch.library.opcheck(torch.ops.fal_net_torch.logits_conv.default,
                          (x.requires_grad_(), k.requires_grad_(), b.requires_grad_(), pad_h))
    assert torch.equal(logits_conv(x, k, b, pad_h), logits_conv_plain(x.contiguous(), k, b, pad_h))


def test_pitch_helpers(rng):
    """pitched_empty rounds the rows up to 8 columns (the buffer itself
    where W % 8 == 0, a view of it elsewhere); pitched_cat equals torch.cat
    on that pitch and passes gradients to each part."""
    for w, pitch in ((16, 16), (13, 16), (8, 8), (1, 8)):
        e = pitched_empty((2, 3, 4, w), torch.zeros((), dtype=torch.bfloat16))
        assert e.shape == (2, 3, 4, w) and e.dtype == torch.bfloat16 and e.stride() == (12 * pitch, 4 * pitch, pitch, 1)
        assert e.is_contiguous() == (w % 8 == 0) and _on_pitch(e)
    for w in (16, 13):
        a = torch.from_numpy(rng.standard_normal((2, 5, 3, w)).astype(np.float32)).requires_grad_()
        c = torch.from_numpy(rng.standard_normal((2, 3, 3, w)).astype(np.float32)).requires_grad_()
        got = pitched_cat([a, c])
        assert torch.equal(got, torch.cat([a, c], 1)) and got.stride(2) == 16 and _on_pitch(got)
        g = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
        got.backward(g)
        assert torch.equal(a.grad, g[:, :5]) and torch.equal(c.grad, g[:, 5:])
    off = torch.from_numpy(rng.standard_normal((1, 3, 2, 13)).astype(np.float32))
    on = _pitched(off)
    assert torch.equal(on, off) and _on_pitch(on) and not _on_pitch(off)


def _fake_gather(whole, shard, k):
    """spatial._all_gather for ``shard``'s halo on the whole tensor's rows:
    each rank's first and last k rows, as the ranks would send them."""
    def gather(t, group):
        return [torch.cat([p[..., :k, :], p[..., -k:, :]], dim=-2)
                for p in (whole[..., lo:hi, :] for lo, hi in (shard.bounds(whole.shape[-2], r)
                                                              for r in range(shard.size)))]
    return gather


@pytest.mark.parametrize("index", [0, 1, 2])
def test_halo_keeps_row_pitch(rng, monkeypatch, index):
    """Under an active row shard (3 ranks; the gather stands in for the
    collective), the halo of a bf16 concat on L1's pitch stays on it, equal
    to the padded rows, and composed_logits hands it to L1 as it is: no copy
    of the halo'd rows; an fp32 contiguous tensor's halo stays contiguous."""
    shard = spatial.RowShard(3, index)
    whole = pitched_cat([torch.from_numpy(rng.standard_normal((2, 8, 9, 13)).astype(np.float32)).to(torch.bfloat16),
                         torch.from_numpy(rng.standard_normal((2, 8, 9, 13)).astype(np.float32)).to(torch.bfloat16)])
    monkeypatch.setattr(spatial, "_all_gather", _fake_gather(whole, shard, 1))
    lo, hi = shard.bounds(9)
    mine = pitched_cat([whole[:, :8, lo:hi], whole[:, 8:, lo:hi]])
    got = shard.halo(mine, 1)
    padded = torch.nn.functional.pad(whole, (0, 0, 1, 1))
    assert _on_pitch(got) and got.stride(2) == 16 and torch.equal(got, padded[:, :, lo:hi + 2])
    wi = torch.from_numpy(rng.standard_normal((5, 16, 3, 3)).astype(np.float32))
    conv1x1 = torch.nn.Conv2d(5, 5, 1)
    seen = []

    class Inputs(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.fal_net_torch.logits_conv.default:
                seen.append(args[0])
            elif func in (torch.ops.aten.copy_.default, torch.ops.aten.clone.default):
                seen.append(func)
            return out

    with torch.no_grad(), shard.active(), Inputs():
        logits = composed_logits(mine, wi, conv1x1)
    assert len(seen) == 1 and _on_pitch(seen[0]) and seen[0].stride(2) == 16, seen
    with torch.no_grad():
        want = composed_logits(whole, wi, conv1x1)[:, :, lo:hi]
    _close(logits.numpy(), want.numpy(), 1e-6, 1e-6, "halo'd logits")
    plain = whole.float().contiguous()
    monkeypatch.setattr(spatial, "_all_gather", _fake_gather(plain, shard, 1))
    assert shard.halo(plain[:, :, lo:hi], 1).is_contiguous()


@pytest.mark.parametrize("w", [32, 36])
@pytest.mark.parametrize("variant", ["B", "tiny"])
def test_bf16_concat_reaches_l1_uncopied(variant, w):
    """FalNet.forward in bf16: the concat that L1 reads is built once, on
    L1's 16-byte pitch (a view of an 8-column padded buffer at W = 36), and
    reaches the op as it is: no op copies a (B, Cin, H, W) tensor, and the
    op's x is the concat's storage."""
    model = create_model(variant, 9, device="cpu", dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    cin = model.get_submodule(model.spec.torch_backbone_key).iconv1.weight.shape[1]
    left = torch.randn(1, 3, 16, w, generator=torch.Generator().manual_seed(1))
    concat = (1, cin, 16, w)
    made, copies, inputs = [], [], []

    class Trace(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.fal_net_torch.logits_conv.default:
                inputs.append(args[0])
            elif isinstance(out, torch.Tensor) and tuple(out.shape) == concat:
                if func in (torch.ops.aten.cat.default, torch.ops.aten.slice.Tensor):
                    made.append(out)
                elif not func._schema.is_mutable and func not in (torch.ops.aten.alias.default,):
                    copies.append(func)
            if func in (torch.ops.aten.copy_.default,) and tuple(args[0].shape) == concat:
                copies.append(func)
            return out

    with torch.no_grad(), Trace():
        model(left, 2.0, 300.0, ret_disp=True)
    assert len(inputs) == 1 and _on_pitch(inputs[0]) and tuple(inputs[0].shape) == concat
    assert len(made) == 1 and made[0].untyped_storage().data_ptr() == inputs[0].untyped_storage().data_ptr()
    assert inputs[0].is_contiguous() == (w % 8 == 0)
    assert not copies, copies


def test_bf16_artifact_keeps_row_pitch(tmp_path):
    """A bf16 artifact exported at W % 8 != 0 keeps the concat's padded
    rows: the program hands L1 an x on the pitch (the CUDA impl refuses any
    other), equal to the live model's output."""
    from fal_net_torch import serve

    model = create_model("tiny", 9, device="cpu", dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "bf16.pt2z")
    serve.save_exported(path, serve.export_forward(model, batch=1, height=32, width=36, device="cpu"))
    fwd = serve.load_exported(path, device="cpu")
    left = torch.rand(1, 32, 36, 3, generator=torch.Generator().manual_seed(1))
    inputs = []

    class Inputs(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.fal_net_torch.logits_conv.default:
                inputs.append(args[0])
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Inputs():
        (got,) = fwd(left)
    assert len(inputs) == 1 and tuple(inputs[0].shape) == (1, 40, 32, 36) and _on_pitch(inputs[0])
    assert not inputs[0].is_contiguous()
    with torch.no_grad():
        want = model(left.permute(0, 3, 1, 2), 2.0, 300.0, ret_disp=True).disp.permute(0, 2, 3, 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["B", "tiny"])
def test_bf16_head_saves_no_fp32_copy(variant):
    """Every tensor the bf16 head saves for its backward is bf16, or is a
    parameter's own fp32 storage (the composition's einsum saves the two
    weights): no fp32 copy of the concat is kept."""
    model = create_model(variant, 9, device="cpu", dtype="bfloat16", generator=torch.Generator().manual_seed(0))
    backbone = model.get_submodule(model.spec.torch_backbone_key)
    feats = torch.randn(1, backbone.iconv1.weight.shape[1], 16, 32).to(torch.bfloat16).requires_grad_()
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = model._head(backbone, feats)
    assert out.dtype == torch.float32
    fp32 = [t for t in saved if t.dtype != torch.bfloat16 and t.untyped_storage().data_ptr() not in params]
    assert not fp32, [(t.dtype, tuple(t.shape)) for t in fp32]
    assert any(t.shape == feats.shape and t.dtype == torch.bfloat16 for t in saved)
    assert all(t.numel() < feats.numel() for t in saved if t.dtype != torch.bfloat16)


@pytest.mark.parametrize("variant", ["B", "tiny"])
def test_fp32_head_is_one_conv(variant):
    """The fp32 head is one convolution (no iconv1-then-1x1 pair), equal to
    the two convs in turn up to fp32 rounding."""
    model = create_model(variant, 9, device="cpu", generator=torch.Generator().manual_seed(0))
    backbone = model.get_submodule(model.spec.torch_backbone_key)
    feats = torch.randn(2, backbone.iconv1.weight.shape[1], 12, 20)
    convs = []

    class Convs(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                convs.append(tuple(args[1].shape))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Convs():
        got = model._head(backbone, feats)
    assert convs == [(9, backbone.iconv1.weight.shape[1], 3, 3)]
    with torch.no_grad():
        want = model.conv0(backbone.iconv1(feats))
    _close(got.numpy(), want.numpy(), 1e-4, 1e-5, "fp32 head")


# ---- on the card (marked cuda; the GPU lane runs without tests/conftest.py) ----


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad_h,view,cout", [
    ((2, 96, 12, 256), 1, "whole", 49), ((1, 96, 9, 1242), 1, "whole", 49), ((1, 96, 9, 1242), 0, "whole", 49),
    ((2, 16, 7, 37), 0, "whole", 49), ((1, 16, 5, 64), 1, "whole", 49), ((2, 96, 6, 70), 1, "channels", 49),
    ((2, 40, 7, 100), 1, "whole", 49), ((2, 13, 6, 70), 1, "whole", 49), ((2, 96, 7, 300), 1, "whole", 65),
    ((2, 96, 9, 1242), 1, "whole", 98), ((1, 96, 6, 256), 1, "whole", 128), ((2, 40, 5, 37), 1, "whole", 72)])
def test_logits_conv_kernel_matches_plain_on_gpu(cuda_device, shape, pad_h, view, cout):
    """L1 against its plain version (TF32 off) at rtol 1e-5, atol 1e-5
    max|plain|, one launch a call, on its one staging path (a TMA box over
    rows on a 16-byte pitch): W = 256, 1242 (pad_h 1 and 0) and 37 on
    8-column padded rows, B = 1, the tiny model's 40 channels, x a
    channel slice of a wider pitched tensor (its strides not packed),
    Cin % 8 != 0 (13: the weights repacked to 16 channels, TMA's zeros past
    Cin inside a 16-channel chunk), and past 64 output channels
    (--no_levels up to K1's 128 planes: tiles of at most 64 in blockIdx.y,
    each block keeping only its tile's weights, the last masked at Cout)."""
    rng = np.random.default_rng(0)
    b, c, h, w = shape
    wide = (b, 2 * c if view == "channels" else c, h, w)
    full = _pitched(torch.from_numpy(rng.standard_normal(wide).astype(np.float32)).to(cuda_device, torch.bfloat16))
    x = full[:, c // 2: c // 2 + c] if view == "channels" else full
    assert _on_pitch(x) and x.is_contiguous() == (view == "whole" and w % 8 == 0)
    k = torch.from_numpy(rng.standard_normal((cout, c, 3, 3)).astype(np.float32) * 0.1).to(cuda_device,
                                                                                           torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(cuda_device)
    _build.load_library()
    before = LAUNCHES["logits_conv"]
    got = logits_conv(x, k, bias, pad_h)
    torch.cuda.synchronize()
    assert LAUNCHES["logits_conv"] == before + 1
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = logits_conv_plain(x, k, bias, pad_h)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    torch.testing.assert_close(got, want, rtol=FWD_TOL, atol=FWD_TOL * float(want.abs().max()))


@pytest.mark.cuda
def test_logits_conv_kernel_refuses_on_gpu(cuda_device):
    """What the kernel does not take raises; nothing falls back: a wrong
    dtype or pad_h, rows that are not contiguous or not on a 16-byte pitch
    (W = 37 contiguous), data not 16-byte aligned (a view 1 element in), and
    weights that do not fit in shared memory (a block's tile of 64 output
    channels of 160 inputs, or 49 of 256)."""
    x = torch.zeros(1, 8, 4, 16, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(5, 8, 3, 3, device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(5, device=cuda_device)
    _build.load_library()
    before = LAUNCHES["logits_conv"]
    with pytest.raises(TypeError, match="bfloat16"):
        logits_conv(x.float(), k.float(), bias, 1)
    with pytest.raises(ValueError, match="pad_h"):
        logits_conv(x, k, bias, 2)
    with pytest.raises(ValueError, match="contiguous"):
        logits_conv(x.transpose(2, 3), k, bias, 1)
    with pytest.raises(ValueError, match="pitch"):
        logits_conv(torch.zeros(1, 8, 4, 37, device=cuda_device, dtype=torch.bfloat16), k, bias, 1)
    with pytest.raises(ValueError, match="aligned"):
        logits_conv(torch.zeros(8 * 4 * 16 + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 8, 4, 16), k,
                    bias, 1)
    for cin, cout in ((160, 64), (256, 49)):
        xi = torch.zeros(1, cin, 4, 16, device=cuda_device, dtype=torch.bfloat16)
        ki = torch.zeros(cout, cin, 3, 3, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="shared memory"):
            logits_conv(xi, ki, torch.zeros(cout, device=cuda_device), 1)
    assert LAUNCHES["logits_conv"] == before

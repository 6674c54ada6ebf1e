"""The port's kernels as PyTorch ops: the ``fal_net_torch`` namespace.

Five ops, each defined here with its schema, a fake (meta) impl that gives
the output shapes (so that ``torch.export`` traces it), and a CPU kernel
that is its plain version; their CUDA impls are the hand-written kernels,
registered by ``csrc/torch_ops.cpp`` once :func:`fal_net_torch.ops._build.load_library`
has loaded the built library:

  * ``med_fwd(logits, image, tables, want_disp, want_pan, want_subocc)
    -> (disp, pan, maskL, maskR)``: K1; plain version
    :func:`fal_net_torch.ops.med.med_outputs`.  Its autograd formula's
    backward is ``med_bwd``; the masks are stop-gradient, and an output that
    gets no cotangent adds no term.
  * ``med_bwd(logits, image, g_disp?, g_pan?, tables, image_grad)
    -> (g_logits, g_image)``: K2; plain version
    :func:`fal_net_torch.ops.med_vjp.med_vjp`.
  * ``conv3x3(x, w2) -> out``: K3 and K4; plain version
    :func:`fal_net_torch.ops.conv3x3.conv3x3_tf32_plain`, what the kernel
    computes.
  * ``roll_window(x, f, wp, left) -> out``: K5; plain version
    :func:`fal_net_torch.ops.roll_probe.roll_window_plain`.
  * ``logits_conv(x, k, bias, pad_h) -> out``: L1, the composed logits
    conv (bf16 operands, fp32 sums and output); plain version
    :func:`fal_net_torch.ops.logits_conv.logits_conv_plain`.  Its CUDA impl
    takes ``x``'s rows on a 16-byte pitch (``ops/logits_conv.py``; a
    contiguous tensor is on it where W % 8 == 0) and raises otherwise; the
    fake impl and the CPU kernel take any layout.  Its autograd
    formula is JAX's ``_conv_accum_bwd`` (fal_net_tpu/models/layers.py:92):
    the cotangent cast to the operands' dtype and the same-dtype conv VJP
    for ``x`` and ``k`` (``aten.convolution_backward``, as JAX leaves it to
    XLA), the fp32 sum for ``bias``; it saves ``x`` and ``k`` as they came,
    bf16 on the model's path.

``tables`` are the MED kernels' plane tables (S, 5, N)
(:func:`fal_net_torch.ops.med_kernel.plane_tables`), S = 1 for one bound
pair or B for per-sample bounds; the CPU kernels read the bounds back from
their level rows (the first and last level are min_disp and max_disp).
A schema cannot return None, so an output that was not requested comes
back as an empty tensor; the wrappers in ``med_kernel.py`` map it back.

The CPU kernels exist so that a program exported on the CPU, and
``torch.library.opcheck``, can run: the public wrappers
(``med_outputs_fused``, ``med_vjp_fused``, ``conv3x3_packed``,
``roll_window``) raise on CPU tensors, so a model never reaches a plain
version through them.  ``logits_conv`` is the exception: the model calls it
in bf16 on either device (:func:`fal_net_torch.models.falnet.composed_logits`),
and on CPU tensors its plain CPU kernel is the model's arithmetic.
"""

from __future__ import annotations

import torch

from fal_net_torch.ops.conv3x3 import conv3x3_tf32_plain
from fal_net_torch.ops.logits_conv import logits_conv_plain
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_vjp import med_vjp
from fal_net_torch.ops.roll_probe import roll_window_plain

NAMESPACE = "fal_net_torch"
SCHEMAS = {
    "med_fwd": "(Tensor logits, Tensor image, Tensor tables, bool want_disp, bool want_pan, bool want_subocc) "
               "-> (Tensor, Tensor, Tensor, Tensor)",
    "med_bwd": "(Tensor logits, Tensor image, Tensor? g_disp, Tensor? g_pan, Tensor tables, bool image_grad) "
               "-> (Tensor, Tensor)",
    "conv3x3": "(Tensor x, Tensor w2) -> Tensor",
    "roll_window": "(Tensor x, Tensor f, int wp, int left) -> Tensor",
    "logits_conv": "(Tensor x, Tensor k, Tensor bias, int pad_h) -> Tensor",
}

_lib = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    _lib.define(_name + _schema)


def _empty(like: torch.Tensor) -> torch.Tensor:
    return like.new_empty((0,))


def _bounds(tables: torch.Tensor):
    """(min_disp, max_disp) from the tables' level rows: numbers for one
    table, (B,) tensors for per-sample ones."""
    lev = tables[:, 0].double()
    if tables.shape[0] == 1:
        return float(lev[0, 0]), float(lev[0, -1])
    return lev[:, 0], lev[:, -1]


@torch.library.impl(_lib, "med_fwd", "CPU")
def _med_fwd_cpu(logits, image, tables, want_disp, want_pan, want_subocc):
    out = med_outputs(logits, image, *_bounds(tables), ret_disp=want_disp, ret_pan=want_pan, ret_subocc=want_subocc)
    return tuple(_empty(logits) if t is None else t.contiguous() for t in (out.disp, out.pan, out.maskL, out.maskR))


@torch.library.register_fake(f"{NAMESPACE}::med_fwd", lib=_lib)
def _med_fwd_fake(logits, image, tables, want_disp, want_pan, want_subocc):
    b, _, h, w = logits.shape
    out = lambda ch, want: logits.new_empty((b, ch, h, w)) if want else _empty(logits)
    return out(1, want_disp), out(image.shape[1], want_pan), out(1, want_subocc), out(1, want_subocc)


@torch.library.impl(_lib, "med_bwd", "CPU")
def _med_bwd_cpu(logits, image, g_disp, g_pan, tables, image_grad):
    g_logits, g_image = med_vjp(logits, image, *_bounds(tables), g_disp, g_pan, image_grad=image_grad)
    return g_logits, _empty(image) if g_image is None else g_image


@torch.library.register_fake(f"{NAMESPACE}::med_bwd", lib=_lib)
def _med_bwd_fake(logits, image, g_disp, g_pan, tables, image_grad):
    return torch.empty_like(logits), torch.empty_like(image) if image_grad and g_pan is not None else _empty(image)


def _med_fwd_setup(ctx, inputs, output):
    logits, image, tables, *_ = inputs
    ctx.mark_non_differentiable(output[2], output[3])  # the masks are stop-gradient
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(logits, image, tables)


def _med_fwd_backward(ctx, g_disp, g_pan, _g_mask_l, _g_mask_r):
    logits, image, tables = ctx.saved_tensors
    # an output that was not requested (empty) or got no cotangent adds no term
    g_disp = None if g_disp is None or not g_disp.numel() else g_disp.contiguous()
    g_pan = None if g_pan is None or not g_pan.numel() else g_pan.contiguous()
    if g_disp is None and g_pan is None:
        return None, None, None, None, None, None
    g_logits, g_image = torch.ops.fal_net_torch.med_bwd(logits, image, g_disp, g_pan, tables,
                                                        ctx.needs_input_grad[1])
    return g_logits, g_image if g_image.numel() else None, None, None, None, None


torch.library.register_autograd(f"{NAMESPACE}::med_fwd", _med_fwd_backward, setup_context=_med_fwd_setup, lib=_lib)


@torch.library.impl(_lib, "conv3x3", "CPU")
def _conv3x3_cpu(x, w2):
    return conv3x3_tf32_plain(x, w2).contiguous()


@torch.library.register_fake(f"{NAMESPACE}::conv3x3", lib=_lib)
def _conv3x3_fake(x, w2):
    return x.new_empty((x.shape[0], w2.shape[0], x.shape[2], x.shape[3]))


@torch.library.impl(_lib, "roll_window", "CPU")
def _roll_window_cpu(x, f, wp, left):
    return roll_window_plain(x, f, wp, left).contiguous()


@torch.library.register_fake(f"{NAMESPACE}::roll_window", lib=_lib)
def _roll_window_fake(x, f, wp, left):
    return torch.empty_like(x)


@torch.library.impl(_lib, "logits_conv", "CPU")
def _logits_conv_cpu(x, k, bias, pad_h):
    return logits_conv_plain(x, k, bias, pad_h).contiguous()


@torch.library.register_fake(f"{NAMESPACE}::logits_conv", lib=_lib)
def _logits_conv_fake(x, k, bias, pad_h):
    b, _, h, w = x.shape
    return x.new_empty((b, k.shape[0], h - 2 + 2 * pad_h, w), dtype=torch.float32)


def _logits_conv_setup(ctx, inputs, output):
    x, k, _bias, pad_h = inputs
    ctx.pad_h = pad_h
    ctx.save_for_backward(x, k)


def _logits_conv_backward(ctx, g):
    x, k = ctx.saved_tensors
    need_x, need_k, need_bias = ctx.needs_input_grad[:3]
    dx = dk = None
    if need_x or need_k:
        dx, dk, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, k, None, [1, 1], [ctx.pad_h, 1], [1, 1], False, [0, 0], 1, [need_x, need_k, False])
    return dx, dk, g.sum((0, 2, 3)) if need_bias else None, None


torch.library.register_autograd(f"{NAMESPACE}::logits_conv", _logits_conv_backward, setup_context=_logits_conv_setup,
                                lib=_lib)

"""The work a call needs, from its shapes alone: the same call reads the same
bound whatever implements it.  Not a metric (its name starts with ``_``).

MED head operations are those of the plain head's math (reference/med.py),
per logit, an exp or a division counting one:
  * disparity: softmax (max, subtract, exp, sum, divide: 5) and the
    expectation (multiply, add: 2): 7;
  * pan: the shifted logit's lerp (3), the shifted softmax (5), per image
    channel the shifted pixel's lerp (3) and the weighted sum (2): 8 + 5C;
  * the backward (K2) of disparity and pan, its softmaxes recomputed: the
    disparity term sm0 (d - disp) g (5 + 3), the pan cotangent per channel
    (lerp 3, multiply-add 2), D recomputed (8), q = D gD (1), q - D sum(q)
    (3), the transposed lerp (3): 23 + 5C.
Bytes: every input read once and every output written once, fp32.

Convolution FLOPs are counted on the plain reference model, forward, and
for training the backward too, as autograd asks for it (no weight
gradient of the frozen VGG19, no input gradient of the image): the count
``torch.utils.flop_counter`` gives, without its cost at set-up.
"""

from __future__ import annotations

import torch

from portbench.harness import peaks

F32 = 4


def med_fwd(b: int, n: int, h: int, w: int, c: int = 3, pan: bool = False) -> tuple[int, int]:
    """(bytes, operations) of one K1 call: disparity, and pan if asked."""
    logits, pix = b * n * h * w, b * h * w
    nbytes = (logits + pix) * F32 + (2 * c * pix * F32 if pan else 0)
    ops = logits * (7 + (8 + 5 * c if pan else 0))
    return nbytes, ops


def med_bwd(b: int, n: int, h: int, w: int, c: int = 3) -> tuple[int, int]:
    """(bytes, operations) of one K2 call with disparity and pan cotangents,
    no image gradient: reads logits, image, g_disp, g_pan; writes g_logits."""
    logits, pix = b * n * h * w, b * h * w
    nbytes = (2 * logits + pix + 2 * c * pix) * F32
    return nbytes, logits * (23 + 5 * c)


def bound_s(nbytes: int, ops: int) -> float:
    """The least time: bytes at HBM's rate or fp32 operations on the CUDA
    cores, whichever is longer."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)


def conv_flops(variant: str, num_levels: int, batch: int, h: int, w: int, *, train: bool = False,
               a_p: float = 0.0, device="meta") -> float:
    """Convolution FLOPs of one serving forward, or of one stage-1 training
    step: every convolution the step runs on the plain reference (forward,
    VGG19 to pool3 on the label and on the synthesized view where
    ``a_p > 0``), each 2 Cin/groups kh kw per output element, and in
    training once more for its weight gradient where the weight learns and
    once more for its input gradient where the input carries one.  Counted
    on one image (every convolution is per image) and multiplied by
    ``batch``; on ``device``: the meta device computes nothing but loads
    seconds of PyTorch's meta kernels, so a run on the card counts there."""
    from portbench.reference import falnet, train as ref_train

    total = [0]

    def count(conv, inputs, out):
        kh, kw = conv.kernel_size
        flops = 2 * conv.in_channels // conv.groups * kh * kw * out.numel()
        grads = int(conv.weight.requires_grad) + int(inputs[0].requires_grad) if train and out.requires_grad else 0
        total[0] += flops * (1 + grads)

    with torch.device(device):
        model = falnet.FalNet(variant, num_levels)
        vgg = ref_train.Vgg19Pool3() if train and a_p > 0 else None
        convs = [m for net in (model, vgg) if net is not None for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
        hooks = [c.register_forward_hook(count) for c in convs]
        try:
            with torch.set_grad_enabled(train):
                model.logits(torch.zeros(1, 3, h, w), 300.0)
            if vgg is not None:  # the label's features without autograd, the synthesized view's with it
                with torch.no_grad():
                    vgg(torch.zeros(1, 3, h, w))
                vgg(torch.zeros(1, 3, h, w, requires_grad=True))
        finally:
            for hk in hooks:
                hk.remove()
    return float(total[0] * batch)

"""The shape-based counts behind the rooflines and the MFU."""

import pytest
import torch
from torch import nn

from portbench.harness import peaks
from portbench.metrics import _work
from portbench.reference import falnet


def test_med_fwd_counts_by_hand():
    # B=1, N=2, H=1, W=4: 8 logits, 4 pixels
    assert _work.med_fwd(1, 2, 1, 4) == ((8 + 4) * 4, 8 * 7)
    assert _work.med_fwd(1, 2, 1, 4, c=3, pan=True) == ((8 + 4 + 2 * 3 * 4) * 4, 8 * (7 + 8 + 15))


def test_med_bwd_counts_by_hand():
    # reads logits, image (3 ch), g_disp, g_pan (3 ch); writes g_logits
    assert _work.med_bwd(1, 2, 1, 4) == ((8 + 12 + 4 + 12 + 8) * 4, 8 * (23 + 15))


def test_bound_takes_the_longer_time():
    assert _work.bound_s(int(3.35e12), 0) == pytest.approx(1.0)
    assert _work.bound_s(0, int(67e12)) == pytest.approx(1.0)
    assert _work.bound_s(int(3.35e12), int(2 * 67e12)) == pytest.approx(2.0)
    # K1 disp at the serving shape: 786.4 MB, bytes-bound at 0.2348 ms
    nbytes, ops = _work.med_fwd(8, 49, 384, 1280)
    assert nbytes == 786_432_000 and _work.bound_s(nbytes, ops) == pytest.approx(786_432_000 / peaks.HBM_BYTES_PER_S)


def _hooked_forward_flops(model, x):
    """2 Cin/groups kh kw Cout Ho Wo B over every conv the forward runs."""
    total = [0]

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        total[0] += 2 * mod.in_channels // mod.groups * kh * kw * out.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, nn.Conv2d)]
    with torch.no_grad():
        model.logits(x, 300.0)
    for h in handles:
        h.remove()
    return total[0]


@pytest.mark.parametrize("variant,levels", [("tiny", 5), ("A", 9)])
def test_conv_flops_forward_is_every_conv_once(variant, levels):
    model = falnet.FalNet(variant, levels)
    want = _hooked_forward_flops(model, torch.zeros(2, 3, 32, 64))
    assert _work.conv_flops(variant, levels, 2, 32, 64) == want


def test_conv_flops_training_is_forward_and_both_gradients():
    """Without VGG19: forward + weight gradient of every conv + input
    gradient of every conv but the first (the image needs none)."""
    model = falnet.FalNet("tiny", 5)
    fwd = _hooked_forward_flops(model, torch.zeros(2, 3, 32, 64))
    first = 2 * 3 * 9 * 32 * 2 * 32 * 64  # conv0: 3 -> 32 channels, 3x3, B=2, 32x64
    assert _work.conv_flops("tiny", 5, 2, 32, 64, train=True) == 3 * fwd - first


def test_fal_net_b_serving_count():
    # FAL_netB N=49 at 384x1280, one image: 274.58 GFLOP of convolutions
    assert _work.conv_flops("B", 49, 1, 384, 1280) == pytest.approx(274.5758e9, rel=1e-6)

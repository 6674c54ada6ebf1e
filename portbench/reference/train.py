"""The stage-1 training step in plain PyTorch: the authors' loss
(Train_Stage1_K.py:210-262, loss_functions.py) and torch's Adam update
written out, for the benchmark's training check.

  loss = mean|pan - right|
       + a_p * sum_{i<3} mean((vgg_i(pan) - vgg_i(right))^2)
       + a_sm * smoothness(left[..., x0:], disp[..., x0:]),  x0 = int(0.2 W)

VGG19's features are taken after pool1, pool2 and pool3 (ReLU after every
conv), frozen.  The smoothness is edge-aware: the disparity's one-sided
differences on both sides along each axis, weighted by exp(-2 |image
second difference|) of the de-normalized Rec.601 luminance, zero padded.
Adam: m = b1 m + (1-b1) g, v = b2 v + (1-b2) g^2,
p -= lr (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

RGB_MEAN = (0.411, 0.432, 0.45)
REC601 = (0.299, 0.587, 0.114)
VGG_STAGES = ((0, 2), (5, 7), (10, 12, 14, 16))  # torchvision vgg19.features indices, to pool3
VGG_WIDTHS = (64, 128, 256)


class Vgg19Pool3(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        cin = 3
        for stage, idxs in enumerate(VGG_STAGES):
            for i in idxs:
                self.features[str(i)] = nn.Conv2d(cin, VGG_WIDTHS[stage], 3, padding=1)
                cin = VGG_WIDTHS[stage]
        self.requires_grad_(False)

    def forward(self, x):
        outs = []
        for idxs in VGG_STAGES:
            for i in idxs:
                x = F.relu(self.features[str(i)](x))
            x = F.max_pool2d(x, 2)
            outs.append(x)
        return outs


def smoothness(img, disp, gamma=2.0):
    mean = torch.tensor(RGB_MEAN, dtype=img.dtype, device=img.device).view(1, 3, 1, 1)
    wts = torch.tensor(REC601, dtype=img.dtype, device=img.device).view(1, 3, 1, 1)
    g = F.pad(((img + mean) * wts).sum(1, keepdim=True), (1, 1, 1, 1))
    d = F.pad(disp, (1, 1, 1, 1))
    h, w = img.shape[-2:]

    def at(a, dy, dx):
        return a[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    ix = 2 * at(g, 0, 0) - at(g, 0, -1) - at(g, 0, 1)
    iy = 2 * at(g, 0, 0) - at(g, -1, 0) - at(g, 1, 0)
    dx = (at(d, 0, 0) - at(d, 0, 1)).abs() + (at(d, 0, 0) - at(d, 0, -1)).abs()
    dy = (at(d, 0, 0) - at(d, 1, 0)).abs() + (at(d, 0, 0) - at(d, -1, 0)).abs()
    return (dx * torch.exp(-gamma * ix.abs()) + dy * torch.exp(-gamma * iy.abs())).mean()


def stage1_loss(model, vgg, left, right, min_disp, max_disp, a_p, a_sm):
    disp, pan = model(left, min_disp, max_disp, pan=True)
    loss = (pan - right).abs().mean()
    if a_p > 0:
        with torch.no_grad():
            label = vgg(right)
        loss = loss + a_p * sum(((o - lab) ** 2).mean() for o, lab in zip(vgg(pan), label))
    x0 = int(0.2 * left.shape[-1])
    return loss + a_sm * smoothness(left[..., x0:], disp[..., x0:])


class Adam:
    """torch.optim.Adam's update (no weight decay), written out."""

    def __init__(self, params, lr, betas, eps=1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps, self.t = lr, betas, eps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
            p.grad = None

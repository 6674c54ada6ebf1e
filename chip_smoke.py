#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fal_net_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each reported on its own line; any failure exits nonzero:
  1. device: name, power limit, TF32 settings (no GPU -> exit 1);
  2. build: compile the CUDA kernels from fal_net_torch/csrc, one nvcc per
     source, all started together;
  3. K1 vs plain: the MED forward kernel against the plain PyTorch head
     on shared seeded inputs, every mode, at the TPU kernel tests' shapes, with
     per-sample bound tensors, at the training shape (8, 49, 192, 640) and at
     the serving shape (8, 49, 384, 1280), with those tests' tolerances.
     Both MED kernels stage plane rows in shared memory
     (csrc/med_stage.cuh) by one of three paths, printed beside each shape:
     the whole row (N = 49, W = 640), a ring that streams the planes once a
     sweep (N = 49, W = 1280; two column chunks at W = 1500),
     and cp.async copies where W * 4 is not a multiple of 16 (W = 187);
  3b. K2 vs plain: the MED backward kernel against the plain VJP at the TPU
     gradient tests' shapes (N = 7, 33, 49 at 8x128), with per-sample bound
     tensors, at W = 187 (cp.async), (2, 49, 16, 1280) and W = 1500 (ring),
     W = 5000 (pan cotangents on the direct path: the image and g_pan rows
     read from device memory), disp-only and pan-only cotangents, with and
     without the image gradient, through autograd after a subocc forward (the
     masks carry no gradient), and at the training shape (8, 49, 192, 640;
     whole row); rtol 1e-4, atol 1e-5 as the TPU gradient tests; then the
     widest W each kernel takes at N = 49 in each mode;
  4. the serving slice: FAL_netB N=49 with seeded random weights is saved to
     a .pt, 19 synthetic 384x1280 PNGs go through ``fal_net_torch.cli.infer``
     at batch 8, then the disp+pan forward runs at batch 1 and 8, and at batch
     8 with per-sample bound tensors; each run must launch the kernel, and the
     kernel and the plain head must agree on the model's own logits;
  5. times (CUDA events, median after warm-up): K1 vs plain head at
     (8, 49, 384, 1280), the whole forward at batch 8 and batch 1, K1
     disp+pan and disp+pan+subocc (stage 2's student), K2, the plain VJP and
     autograd of the plain head at the training shape (8, 49, 192, 640); the
     stage-1 training step at batch 8, 192x640, the stage-1-slow step and
     the stage-2 step (teacher forward, student forward and backward, Adam)
     at batch 4, a double batch of 8; peak device memory of each step; each
     MED kernel's bytes moved (from its staging plan) beside its bound;
  6. only with ``--profile DIR``: ``torch.profiler`` over the disp-only
     forward at batch 8 and 1 and over the stage-1 training step (device
     window, busy share, kernel time by kind; the per-kernel tables go to
     DIR), and the forward with TF32 convolutions off;
  7. the training slice: a synthetic KITTI-raw tree (32 smooth 375x1242 stereo
     pairs, right = left shifted by 20 px) trains FAL_netB N=49 through
     ``fal_net_torch.cli.train --stage 1`` at batch 8, 192x640, for 4 steps;
     K1 and K2 launch once per step (and once each in the setup gate), every
     loss is finite, the checkpoint serves two frames through cli.infer; then
     one step with per-sample bound tensors (fix_order=False), and K2 against
     the plain VJP on the model's own logits;
  7d. ``cli.train --stage 2`` on the same tree, FAL_netB N=49, 192x640, batch
     4 (double batch 8), a_p 0, 4 steps, with phase 7a's checkpoint as the
     frozen teacher (``--fix_model``): the reference's stage-1 -> stage-2
     chain.  Every loss finite; the setup gate launches K1 twice (the
     student's subocc mode, the teacher's disp-only mode) and K2 once, each
     step K1 twice (teacher, student) and K2 once; the teacher's parameters
     bit-identical afterwards; K2 against the plain VJP on the student's own
     logits after a subocc forward, with the stage-2 loss's cotangents;
  7e. ``cli.train --stage 1 --slow``, the same, 4 steps: one K1 and one K2
     launch a step on the double batch (and one each in the gate);
  8. convergence (scripts/verify_train_tpu.py on the card): the tiny model,
     N=9 over 2..18 px, 64x128, batch 4, Adam 5e-4 (beta1 0.5), 400 stage-1
     steps through K1 and K2 on smooth stereo shifted by 6 px; the median
     disparity must land within half a level spacing of 6.00 px;
  8b. stage-2 convergence (scripts/verify_train_stage2_tpu.py on the card):
     phase 8's model is the frozen teacher, a fresh student (seed 7) trains
     400 stage-2 steps at lr 5e-4, a_sm 2 x 0.2 x 2/512, a_mr 1; the loss
     must fall, the mirror aux must fall below half its first value and the
     student's median disparity must land within half a spacing of 6.00 px;
  9. the ported kernel scripts (``fal_net_torch.scripts``): K3
     (``proto_conv_kernel``) and K4 (``proto_conv_kernel_v2``), both through
     the TF32 wgmma conv, against their plain versions on TF32-truncated
     operands at rtol 1e-5, atol 1e-4 and against the fp32 plain versions
     within 2^-9 (|x| conv |w|) + 1e-4, in each of the JAX scripts' cases,
     timed beside cuDNN with TF32 off and on; K5 (``probe_roll_bug``) exact
     over the probe's sweep and wrapping shifts; each launch count must
     equal the calls the scripts made.
The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fal_net_torch.cli import infer
from fal_net_torch.data.transforms import normalize
from fal_net_torch.models import create_model
from fal_net_torch.models.checkpoint import save_checkpoint
from fal_net_torch.ops import _build
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_kernel import MedForward, med_outputs_fused, med_vjp_fused, stage_plan
from fal_net_torch.ops.med_vjp import med_vjp
from fal_net_torch.utils.timing import median_ms, tf32

# (rtol, atol) of the TPU kernel's own tests (tests/test_med_pallas.py:34-37)
TOL = {"disp": (1e-5, 1e-4), "pan": (1e-4, 1e-4), "maskL": (1e-4, 1e-4), "maskR": (1e-4, 1e-4)}
MODES = {
    "disp": dict(ret_disp=True),
    "pan": dict(ret_disp=False, ret_pan=True),
    "disp+pan": dict(ret_disp=True, ret_pan=True),
    "disp+pan+subocc": dict(ret_disp=True, ret_pan=True, ret_subocc=True),
}
# (B, N, H, W, C, min_disp, max_disp)
SHAPES = [
    (3, 2, 16, 96, 3, 2.0, 300.0),  # tests/test_med_pallas.py:155-162
    (1, 5, 3, 64, 1, 2.0, 300.0),
    (2, 7, 16, 48, 4, 2.0, 300.0),  # W below the largest shift
    (1, 49, 8, 140, 3, 2.0, 300.0),
    (1, 9, 13, 256, 3, 2.0, 300.0),  # odd H
    (1, 9, 16, 187, 3, 2.0, 300.0),  # unaligned W
    (1, 9, 16, 256, 3, 2.0, 300.0),  # both bound pairs of :23
    (1, 9, 16, 256, 3, 1.0, 30.0),
    (1, 9, 8, 96, 3, -1.0, -30.0),  # swapped-order negative bounds
    (3, 9, 8, 96, 3, (2.0, -1.0, 1.0), (300.0, -30.0, 30.0)),  # per-sample bounds
    (2, 49, 16, 1280, 3, (2.0, 1.0), 300.0),  # per-sample min, shared 0-d max; ring path
    (1, 49, 4, 1500, 3, 2.0, 300.0),  # two column chunks
    (8, 49, 192, 640, 3, 2.0, 300.0),  # training shape (stage 2's double batch: subocc)
    (8, 49, 384, 1280, 3, 2.0, 300.0),  # serving shape
]
SERVE_H, SERVE_W, N_IMAGES, BATCH = 384, 1280, 19, 8
GRAD_TOL = (1e-4, 1e-5)  # (rtol, atol) of tests/test_med_pallas.py's gradient tests
# (B, N, H, W, C, min_disp, max_disp) for K2
GRAD_SHAPES = [
    (2, 7, 8, 128, 3, 2.0, 60.0),  # tests/test_med_pallas.py:102-110
    (2, 33, 8, 128, 3, 2.0, 18.0),
    (2, 49, 8, 128, 3, 2.0, 300.0),
    (2, 7, 16, 48, 4, 2.0, 300.0),  # W below the largest shift
    (3, 9, 8, 96, 3, (2.0, -1.0, 1.0), (300.0, -30.0, 30.0)),  # per-sample bounds
    (1, 9, 16, 187, 3, 2.0, 300.0),  # unaligned W: the cp.async path
    (2, 49, 16, 1280, 3, (2.0, 1.0), 300.0),  # per-sample min, shared 0-d max; ring path
    (2, 49, 16, 1280, 3, 2.0, 300.0),  # ring path, number bounds
    (1, 49, 4, 1500, 3, 2.0, 300.0),  # ring path, two column chunks
    (1, 49, 4, 5000, 3, 2.0, 300.0),  # pan rows too wide to stage: the direct path
    (8, 49, 192, 640, 3, 2.0, 300.0),  # training shape: whole-row path
]
# cotangents given to K2: (g_disp, g_pan, image_grad)
GRAD_MODES = {
    "disp+pan": (True, True, False),  # the training step's mode
    "disp+pan+g_img": (True, True, True),
    "disp": (True, False, False),
    "pan+g_img": (False, True, True),
}
TRAIN_H, TRAIN_W, TRAIN_STEPS, KITTI_H, KITTI_W, KITTI_PAIRS, KITTI_DISP = 192, 640, 4, 375, 1242, 32, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, NVIDIA data sheet
TF32_FLOPS = 494.7e12  # H100 SXM TF32 tensor cores, dense, NVIDIA data sheet
CONV_TIMED = (8, 64, 192, 640, 64)  # the conv case whose times go into the kernels line
# fp32 operations per logit, counted from the kernel sources (an exp2 counts
# one): K1 disp-only (multiply by log2 e, max, subtract, exp2, add,
# multiply-add; the rescale once a stage of 7 planes is below one); K2 in the
# training mode, C=3 (statistics sweep 23 with two exp2, gradient sweep 39
# with three)
OPS_PER_LOGIT = {"med_fwd": 6, "med_bwd": 62}


def line(msg: str) -> None:
    print(msg, flush=True)


def compare(got, want, label: str) -> float:
    """Kernel outputs vs plain outputs at TOL; returns the worst abs error."""
    worst = 0.0
    errs = {}
    for field, (rtol, atol) in TOL.items():
        g, w = getattr(got, field), getattr(want, field)
        if (g is None) != (w is None):
            raise AssertionError(f"{label}: {field} present in only one head")
        if g is None:
            continue
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {field} shape {tuple(g.shape)} or non-finite")
        err = float((g - w).abs().max())
        errs[field] = err
        worst = max(worst, err)
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{label}: {field} differs, max abs err {err:.3e} (rtol {rtol}, atol {atol})"
            )
    line(f"  {label}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    return worst


def bound(nbytes: int, ops: float, rate: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``rate`` (fp32 on the CUDA cores unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def plan_label(kernel: str, n: int, c: int, w: int, **flags) -> str:
    """The staging path the MED kernel takes at this size (csrc/med_stage.cuh)."""
    p = stage_plan(kernel, n, c, w, **flags)
    path = "whole row" if p["whole"] else f"ring of {p['slots']}"
    copy = "bulk copies" if w % 4 == 0 else "cp.async"
    direct = ", image and g_pan rows from device memory" if p["direct"] else ""
    return (f"{path} in stages of {p['group']}, {p['chunks']} chunk(s), {p['loads']} stage loads a row, "
            f"{copy}, {p['smem']} B{direct}")


def widest(kernel: str, n: int = 49, c: int = 3, staged: bool = False, **flags) -> int:
    """The largest W the MED kernel takes at N = ``n`` with these outputs or
    cotangents (with ``staged``: on a path that stages the image rows)."""
    def takes(w):
        try:
            plan = stage_plan(kernel, n, c, w, **flags)
        except ValueError:
            return False
        return not (staged and plan["direct"])

    lo, hi = 1, 1 << 17  # takes(lo), not takes(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes(mid) else (lo, mid)
    return lo


def moved_bytes(kernel: str, logits, c: int, others, **flags) -> int:
    """Bytes a staged MED kernel moves to and from device memory at C = ``c``:
    the logits once on the whole-row path and once a sweep on the ring path,
    every other input and output once (``bound`` counts the logits once)."""
    _, n, _, w = logits.shape
    p = stage_plan(kernel, n, c, w, **flags)
    return nbytes(logits) * (1 if p["whole"] else p["sweeps"]) + nbytes(*others)


def compare_grads(got, want, label: str) -> float:
    """K2's (g_logits, g_image) vs the plain VJP's at GRAD_TOL."""
    worst = 0.0
    errs = {}
    for name, g, w in zip(("g_logits", "g_image"), got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"{label}: {name} present in only one VJP")
        if g is None:
            continue
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {name} shape {tuple(g.shape)} or non-finite")
        err = float((g - w).abs().max())
        errs[name] = err
        worst = max(worst, err)
        if not torch.allclose(g, w, rtol=GRAD_TOL[0], atol=GRAD_TOL[1]):
            raise AssertionError(f"{label}: {name} differs, max abs err {err:.3e} {GRAD_TOL}")
    line(f"  {label}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    return worst


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU")
    torch.backends.cudnn.allow_tf32 = True  # torch's default for convolutions
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default for matmuls
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    line(f"phase 1 device: {name}; nvidia-smi: {smi}; count {torch.cuda.device_count()}; "
         f"torch {torch.__version__} cuda {torch.version.cuda}; "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
         f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    line(f"phase 2 build: {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s; "
         f"ptxas: {'; '.join(regs) or 'cached'}")


def phase_kernel_vs_plain(rng, dev) -> float:
    worst = 0.0
    for b, n, h, w, c, mn, mx in SHAPES:
        logits = torch.from_numpy(rng.standard_normal((b, n, h, w), np.float32)).to(dev)
        image = torch.from_numpy(rng.standard_normal((b, c, h, w), np.float32)).to(dev)
        label = f"{(b, n, h, w, c)} [{mn},{mx}]"
        # a tuple is one bound per sample; with a tuple, the other bound is 0-d
        per_sample = isinstance(mn, tuple) or isinstance(mx, tuple)
        if per_sample:
            mn, mx = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (mn, mx))
        for mode, kw in MODES.items():
            got = med_outputs_fused(logits, image, mn, mx, **kw)
            torch.cuda.synchronize()
            if per_sample:  # the plain head takes (B,) bounds for both
                want = med_outputs(logits, image, mn.expand(b), mx.expand(b), **kw)
            else:
                want = med_outputs(logits, image, mn, mx, **kw)
            path = plan_label("med_fwd", n, c, w, disp=kw["ret_disp"], pan=kw.get("ret_pan", False),
                              subocc=kw.get("ret_subocc", False))
            worst = max(worst, compare(got, want, f"{label} {mode} [{path}]"))
    line(f"phase 3 kernel vs plain: {len(SHAPES)} shapes x {len(MODES)} modes agree, "
         f"worst abs err {worst:.3e}")
    return worst


def phase_bwd_vs_plain(rng, dev) -> float:
    worst = 0.0
    for b, n, h, w, c, mn, mx in GRAD_SHAPES:
        draw = lambda ch: torch.from_numpy(rng.standard_normal((b, ch, h, w), np.float32)).to(dev)
        logits, image, g_disp, g_pan = draw(n), draw(c), draw(1), draw(c)
        label = f"{(b, n, h, w, c)} [{mn},{mx}]"
        if isinstance(mn, tuple) or isinstance(mx, tuple):
            mn, mx = (torch.tensor(v, dtype=torch.float32, device=dev).expand(b) for v in (mn, mx))
        for mode, (want_d, want_p, img) in GRAD_MODES.items():
            gd, gp = (g_disp if want_d else None), (g_pan if want_p else None)
            got = med_vjp_fused(logits, image, mn, mx, gd, gp, image_grad=img)
            torch.cuda.synchronize()
            want = med_vjp(logits, image, mn, mx, gd, gp, image_grad=img)
            path = plan_label("med_bwd", n, c, w, disp=want_d, pan=want_p, image_grad=img)
            worst = max(worst, compare_grads(got, want, f"{label} {mode} [{path}]"))
        # through autograd after a subocc forward: the masks carry no gradient
        lg = logits.clone().requires_grad_()
        im = image.clone().requires_grad_()
        out = med_outputs_fused(lg, im, mn, mx, ret_disp=True, ret_pan=True, ret_subocc=True)
        if out.maskL.requires_grad or out.maskR.requires_grad:
            raise AssertionError(f"{label}: a mask requires grad")
        loss = (out.disp * g_disp).sum() + (out.pan * g_pan).sum() + out.maskL.sum() + out.maskR.sum()
        got = torch.autograd.grad(loss, (lg, im))
        torch.cuda.synchronize()
        want = med_vjp(logits, image, mn, mx, g_disp, g_pan)
        worst = max(worst, compare_grads(got, want, f"{label} autograd after subocc forward"))
    line(f"phase 3b K2 vs plain: {len(GRAD_SHAPES)} shapes x {len(GRAD_MODES) + 1} modes agree, "
         f"worst abs err {worst:.3e}")
    k2 = {mode: (widest("med_bwd", disp=d, pan=p, image_grad=i), widest("med_bwd", staged=True, disp=d, pan=p,
                                                                         image_grad=i))
          for mode, (d, p, i) in GRAD_MODES.items()}
    k1 = {mode: widest("med_fwd", disp=True, pan="pan" in mode, subocc="subocc" in mode) for mode in MODES}
    line("phase 3b widths at N = 49, C = 3: K2 " + ", ".join(f"{m} {a} (staged rows to {b})" for m, (a, b) in k2.items())
         + "; K1 " + ", ".join(f"{m} {a}" for m, a in k1.items()))
    return worst


def synthetic_image(rng) -> np.ndarray:
    """A smooth seeded 384x1280 RGB frame with noise, uint8."""
    yy, xx = np.mgrid[0:SERVE_H, 0:SERVE_W].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = np.stack(
        [np.sin(xx / (40 + 15 * k) + yy / 60 + phase[k]) for k in range(3)], axis=-1
    )
    img = 127.5 + 90 * base + rng.normal(0, 12, base.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_slice(rng, dev, seed: int, workdir: str):
    from PIL import Image

    model = create_model("B", 49, generator=torch.Generator().manual_seed(seed), device=dev)
    ckpt = os.path.join(workdir, "falnetB_n49.pt")
    save_checkpoint(ckpt, model)
    img_dir, out_dir = os.path.join(workdir, "images"), os.path.join(workdir, "out")
    os.makedirs(img_dir)
    for i in range(N_IMAGES):
        Image.fromarray(synthetic_image(rng)).save(os.path.join(img_dir, f"frame{i:02d}.png"))
    lefts = {
        b: torch.from_numpy(
            np.stack([normalize(synthetic_image(rng)) for _ in range(b)]).transpose(0, 3, 1, 2).copy()
        ).to(dev)
        for b in (1, BATCH)
    }

    MedForward.launches = MedForward.bwd_launches = 0
    t0 = time.perf_counter()
    written = infer.main([
        "--pretrained", ckpt, "--images", img_dir, "--out_dir", out_dir,
        "--batch_size", str(BATCH),
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = MedForward.launches
    outs = {}
    # per-sample bounds, as a training batch carries them: the same pair here
    bounds_t = [torch.full((BATCH,), v, device=dev) for v in (2.0, 300.0)]
    with torch.inference_mode():
        for b, left in lefts.items():  # the __graft_entry__ forward, disp + pan
            outs[b] = model(left, 2.0, 300.0, ret_disp=True, ret_pan=True)
        out_t = model(lefts[BATCH], *bounds_t, ret_disp=True, ret_pan=True)
    torch.cuda.synchronize()
    launches = MedForward.launches
    batches = -(-N_IMAGES // BATCH)
    expect = batches + len(lefts) + 1  # cli.infer, B=1 and B=8, per-sample bounds

    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith("_disp.png"))
    if written != N_IMAGES or len(pngs) != N_IMAGES:
        raise AssertionError(f"cli.infer wrote {written} / {len(pngs)} PNGs, want {N_IMAGES}")
    disp_png = np.stack([np.asarray(Image.open(os.path.join(out_dir, f))) for f in pngs])
    disp_png = disp_png.astype(np.float64) / 256.0  # uint16 value*256, floor-quantized
    if disp_png.shape != (N_IMAGES, SERVE_H, SERVE_W):
        raise AssertionError(f"disparity PNGs have shape {disp_png.shape}")
    if not (disp_png.min() >= 2.0 - 1 / 256 and disp_png.max() <= 300.0):
        raise AssertionError(f"PNG disparities span [{disp_png.min()}, {disp_png.max()}]")
    if cli_launches != batches or launches != expect or MedForward.bwd_launches:
        raise AssertionError(
            f"kernel launches: {cli_launches} in cli.infer (want {batches}), "
            f"{launches} in all (want {expect})"
        )
    line(f"phase 4a cli.infer: {written} disparity PNGs at {SERVE_H}x{SERVE_W} in {cli_s:.2f} s "
         f"through {cli_launches} kernel launches; PNG disparity in "
         f"[{disp_png.min():.4f}, {disp_png.max():.4f}] px")

    # same logits and tables, so the same numbers as the number-bound run
    worst = compare(out_t, outs[BATCH], f"B={BATCH} per-sample bound tensors vs numbers")
    for b, left in lefts.items():
        out = outs[b]
        d, p = out.disp, out.pan
        if d.shape != (b, 1, SERVE_H, SERVE_W) or p.shape != (b, 3, SERVE_H, SERVE_W):
            raise AssertionError(f"forward shapes {tuple(d.shape)}, {tuple(p.shape)}")
        if not (torch.isfinite(d).all() and torch.isfinite(p).all()):
            raise AssertionError("non-finite forward outputs")
        lo, hi = float(d.min()), float(d.max())
        if not (2.0 - 1e-3 <= lo and hi <= 300.0 + 1e-2):
            raise AssertionError(f"disp spans [{lo}, {hi}], outside [2, 300]")
        with torch.inference_mode():
            logits = model.logits(left, 300.0)
            got = med_outputs_fused(logits, left, 2.0, 300.0, ret_disp=True, ret_pan=True)
            want = med_outputs(logits, left, 2.0, 300.0, ret_disp=True, ret_pan=True)
        worst = max(worst, compare(got, want, f"model logits B={b} disp+pan"))
        line(f"phase 4b forward B={b} disp+pan: finite, disp in [{lo:.4f}, {hi:.4f}] px")
    line(f"phase 4 slice: {launches} kernel launches on the main path; kernel vs plain head "
         f"on the model's logits agree, worst abs err {worst:.3e}")
    return model, lefts, launches, worst


def smooth_frame(rng, h: int, w: int) -> np.ndarray:
    """A smooth seeded RGB frame with a little noise, uint8: a shifted lerp
    of it stays close to the shifted frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3)
    base = np.stack([np.sin(xx / (40 + 15 * k) + yy / 60 + phase[k]) for k in range(3)], axis=-1)
    img = 127.5 + 90 * base + rng.normal(0, 4, base.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_kitti_tree(rng, root: str) -> None:
    """KITTI_PAIRS stereo pairs laid out like KITTI raw, right = left shifted
    by KITTI_DISP px (right[x] = left[x + d]), and the Eigen-style list."""
    from PIL import Image

    stem = "2011_09_26/2011_09_26_drive_0001_sync"
    lines = []
    for i in range(KITTI_PAIRS):
        wide = smooth_frame(rng, KITTI_H, KITTI_W + KITTI_DISP)
        for cam, img in (("image_02", wide[:, :KITTI_W]), ("image_03", wide[:, KITTI_DISP:])):
            d = os.path.join(root, stem, cam, "data")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(np.ascontiguousarray(img)).save(os.path.join(d, f"{i:010d}.png"))
        lines.append(f"{stem}/image_02/data/{i:010d}.png {stem}/image_03/data/{i:010d}.png")
    with open(os.path.join(root, "kitti_eigen_train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_train(rng, dev, workdir: str):
    """cli.train on a synthetic tree, then one per-sample-bound step."""
    from PIL import Image

    from fal_net_torch.data.loader import to_device
    from fal_net_torch.losses.photometric import rec_loss
    from fal_net_torch.losses.smoothness import smoothness
    from fal_net_torch.train.config import Stage1Config
    from fal_net_torch.train.trainer import Trainer

    root = os.path.join(workdir, "kitti")
    t0 = time.perf_counter()
    write_kitti_tree(rng, root)
    tree_s = time.perf_counter() - t0
    result, trainer, _, k1, k2, train_s = run_cli_train(["--stage", "1"], root, workdir)
    (epoch,) = result["history"]
    # the setup gate launches each kernel once; each step once more
    if (trainer.cfg.batch_size, k1, k2) != (BATCH, TRAIN_STEPS + 1, TRAIN_STEPS + 1):
        raise AssertionError(f"cli.train launched K1 {k1} and K2 {k2} times, want {TRAIN_STEPS} + 1 each")
    ckpt = os.path.join(result["save_path"], "checkpoint.pt")
    if not os.path.isfile(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    del trainer
    line(f"phase 7a cli.train FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B=8: {TRAIN_STEPS} steps in {train_s:.2f} s "
         f"(setup, gate and data included; tree written in {tree_s:.2f} s), epoch loss "
         f"{epoch['loss']:.6f} rec {epoch['rec_loss']:.6f}; K1 {k1}, K2 {k2} launches")

    frames, out_dir = os.path.join(workdir, "frames"), os.path.join(workdir, "frames_out")
    os.makedirs(frames)
    for i in range(2):
        Image.fromarray(smooth_frame(rng, KITTI_H, KITTI_W)).save(os.path.join(frames, f"f{i}.png"))
    MedForward.launches = 0
    written = infer.main(["--pretrained", ckpt, "--images", frames, "--out_dir", out_dir, "--batch_size", "2"])
    torch.cuda.synchronize()
    infer_k1 = MedForward.launches
    disp = np.stack([np.asarray(Image.open(os.path.join(out_dir, f"f{i}_disp.png"))) for i in range(2)])
    if written != 2 or infer_k1 != 1 or disp.shape != (2, KITTI_H, KITTI_W):
        raise AssertionError(f"cli.infer on the checkpoint: {written} PNGs {disp.shape}, {infer_k1} K1 launches")
    line(f"phase 7b cli.infer on the trained checkpoint: 2 frames at {KITTI_H}x{KITTI_W}, 1 K1 launch, "
         f"PNG disparity in [{disp.min() / 256:.4f}, {disp.max() / 256:.4f}] px")

    cfg = Stage1Config(
        model="B", num_levels=49, data_root=root, lists_dir=root, batch_size=8, a_p=0.0,
        epochs=1, epoch_size=1, fix_order=False, print_freq=1,
    )
    trainer = Trainer(cfg, device=dev)
    trainer.setup()  # the gate with (B,) bound tensors of both signs
    MedForward.launches = MedForward.bwd_launches = 0
    metrics = trainer.train_epoch(0)
    torch.cuda.synchronize()
    k1_t, k2_t = MedForward.launches, MedForward.bwd_launches
    if (k1_t, k2_t) != (1, 1) or not np.isfinite(metrics["loss"]):
        raise AssertionError(f"per-sample-bound step: K1 {k1_t}, K2 {k2_t} launches, {metrics}")
    ds = trainer.train_loader.dataset
    items = [ds.get(i, np.random.default_rng((9, i))) for i in range(8)]
    batch = to_device({k: np.stack([it[k] for it in items]) for k in ("left", "right", "max_disp")}, dev)
    mx = batch["max_disp"]
    mn = mx * (cfg.min_disp / cfg.max_disp)
    signs = int((mx < 0).sum())
    with torch.no_grad():
        logits = trainer.model.logits(batch["left"], mx)
    # the stage-1 loss in sum form (times the pan's element count), so that
    # the cotangents are O(1) and atol 1e-5 means something
    lg = logits.clone().requires_grad_()
    out = med_outputs_fused(lg, batch["left"], mn, mx, ret_disp=True, ret_pan=True)
    x0 = int(0.2 * TRAIN_W)
    loss = out.pan.numel() * (
        rec_loss(1.0, out.pan, batch["right"], None, 0.0)
        + cfg.a_sm * smoothness(batch["left"][..., x0:], out.disp[..., x0:], gamma=2.0)
    )
    g_disp, g_pan = torch.autograd.grad(loss, (out.disp, out.pan), retain_graph=True)
    (g_k2,) = torch.autograd.grad(loss, lg)
    torch.cuda.synchronize()
    g_plain, _ = med_vjp(logits, batch["left"], mn, mx, g_disp, g_pan, image_grad=False)
    worst = compare_grads((g_k2, None), (g_plain, None), f"model logits B=8 per-sample bounds ({signs} swapped)")
    line(f"phase 7c per-sample-bound step (fix_order=False): loss {metrics['loss']:.6f}, K1 {k1_t}, "
         f"K2 {k2_t} launches; K2 vs plain VJP on the model's logits, worst abs err {worst:.3e}")
    return {"k1": k1 + infer_k1 + k1_t, "k2": k2 + k2_t, "worst": worst, "root": root, "ckpt": ckpt}


def run_cli_train(flags, root: str, workdir: str):
    """cli.train for TRAIN_STEPS steps of FAL_netB N=49 at 192x640 with the
    stage's default batch; returns (result, trainer, teacher state after
    setup, K1 launches, K2 launches, seconds).  The trainer is recorded from
    its setup, so that the run's own teacher can be checked afterwards."""
    from fal_net_torch.cli import train
    from fal_net_torch.train.trainer import Trainer

    made = []
    setup = Trainer.setup

    def recording_setup(self):
        setup(self)
        teacher = None if self.teacher is None else {k: v.clone() for k, v in self.teacher.state_dict().items()}
        made.append((self, teacher))

    Trainer.setup = recording_setup
    MedForward.launches = MedForward.bwd_launches = 0
    t0 = time.perf_counter()
    try:
        result = train.main([
            *flags, "--model", "B", "--no_levels", "49", "--a_p", "0", "--epochs", "1",
            "--epoch_size", str(TRAIN_STEPS), "--print_freq", "1", "--data_root", root, "--lists_dir", root,
            "--save_path", os.path.join(workdir, "runs"),
        ])
        torch.cuda.synchronize()
    finally:
        Trainer.setup = setup
    secs = time.perf_counter() - t0
    ((trainer, teacher),) = made
    (epoch,) = result["history"]
    if not all(np.isfinite(v) for v in epoch.values()):
        raise AssertionError(f"non-finite training loss: {epoch}")
    return result, trainer, teacher, MedForward.launches, MedForward.bwd_launches, secs


def phase_later_stages(dev, root: str, ckpt: str, workdir: str):
    """7d: cli.train --stage 2 with phase 7a's checkpoint as the frozen
    teacher; 7e: cli.train --stage 1 --slow.  Both on the double batch of 8."""
    from fal_net_torch.data.loader import to_device
    from fal_net_torch.ops.shift import hflip
    from fal_net_torch.train.stages import _stacked, stage2_loss

    result, trainer, teacher0, k1, k2, secs = run_cli_train(["--stage", "2", "--fix_model", ckpt], root, workdir)
    cfg = trainer.cfg
    # the gate: K1 in the student's subocc mode and the teacher's disp-only
    # mode (one plane count), K2 once; each step: teacher and student K1, one K2
    if (cfg.batch_size, k1, k2) != (4, 2 + 2 * TRAIN_STEPS, 1 + TRAIN_STEPS):
        raise AssertionError(f"cli.train --stage 2 at batch {cfg.batch_size}: K1 {k1}, K2 {k2} launches, "
                             f"want 2 + 2 x {TRAIN_STEPS} and 1 + {TRAIN_STEPS}")
    changed = [k for k, v in trainer.teacher.state_dict().items() if not torch.equal(v, teacher0[k])]
    if changed or any(p.requires_grad for p in trainer.teacher.parameters()):
        raise AssertionError(f"the frozen teacher changed: {changed[:3]}")
    (epoch,) = result["history"]
    line(f"phase 7d cli.train --stage 2 --fix_model <7a's checkpoint> FAL_netB N=49 {TRAIN_H}x{TRAIN_W} "
         f"B={cfg.batch_size} (double batch {2 * cfg.batch_size}): {TRAIN_STEPS} steps in {secs:.2f} s, epoch loss "
         f"{epoch['loss']:.6f} rec {epoch['rec_loss']:.6f}; K1 {k1}, K2 {k2} launches; teacher bit-identical")

    # K2 against the plain VJP on the student's own logits after a subocc
    # forward, with the stage-2 loss's cotangents (a_mr = 1, teacher included)
    ds = trainer.train_loader.dataset
    items = [ds.get(i, np.random.default_rng((11, i))) for i in range(cfg.batch_size)]
    batch = to_device({k: np.stack([it[k] for it in items]) for k in ("left", "right")}, dev)
    s_in = torch.cat([batch["left"], hflip(batch["right"])])
    mn, mx = _stacked((cfg.min_disp, cfg.max_disp))
    with torch.no_grad():
        logits = trainer.model.logits(s_in, mx)
    lg = logits.clone().requires_grad_()
    heads = []

    def head(x, a, z, **kw):  # the student's MED head on the shared logits
        heads.append(med_outputs_fused(lg, x.contiguous(), a, z, **kw))
        return heads[-1]

    loss, _ = stage2_loss(head, batch, trainer.teacher, min_disp=cfg.min_disp, max_disp=cfg.max_disp,
                          a_p=0.0, a_sm=cfg.a_sm, a_mr=cfg.a_mr)
    (out,) = heads
    loss = loss * out.pan.numel()  # sum form: O(1) cotangents, so that atol 1e-5 means something
    g_disp, g_pan = torch.autograd.grad(loss, (out.disp, out.pan), retain_graph=True)
    (g_k2,) = torch.autograd.grad(loss, lg)
    torch.cuda.synchronize()
    g_plain, _ = med_vjp(logits, s_in, mn, mx, g_disp, g_pan, image_grad=False)
    worst = compare_grads((g_k2, None), (g_plain, None), "stage-2 student logits, double batch, after subocc")
    line(f"phase 7d K2 vs plain VJP on the student's logits after a subocc forward: worst abs err {worst:.3e}")

    result, trainer, _, k1_s, k2_s, secs = run_cli_train(["--stage", "1", "--slow"], root, workdir)
    if (trainer.cfg.batch_size, k1_s, k2_s) != (4, 1 + TRAIN_STEPS, 1 + TRAIN_STEPS):
        raise AssertionError(f"cli.train --stage 1 --slow at batch {trainer.cfg.batch_size}: K1 {k1_s}, "
                             f"K2 {k2_s} launches, want 1 + {TRAIN_STEPS} each")
    (epoch,) = result["history"]
    line(f"phase 7e cli.train --stage 1 --slow FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={trainer.cfg.batch_size} "
         f"(double batch {2 * trainer.cfg.batch_size}): {TRAIN_STEPS} steps in {secs:.2f} s, epoch loss "
         f"{epoch['loss']:.6f} rec {epoch['rec_loss']:.6f}; K1 {k1_s}, K2 {k2_s} launches")
    return {"k1": k1 + k1_s, "k2": k2 + k2_s, "worst": worst}


CONVERGE = dict(disp_px=6, h=64, w=128, b=4, n=9, mn=2.0, mx=18.0, steps=400)


def phase_converge(dev):
    """scripts/verify_train_tpu.py on the card: stage-1 training on smooth
    synthetic stereo whose true disparity, 6 px, is plane 4 of 2..18, N=9.
    Returns the trained model (phase 8b's teacher) and the batch."""
    import scipy.ndimage as ndi

    from fal_net_torch.ops.med import disparity_levels
    from fal_net_torch.train.stages import stage1_loss

    disp_px, h, w, b, n, mn, mx, steps = CONVERGE.values()
    rng = np.random.default_rng(0)
    coarse = rng.random((b, h // 8 + 2, (w + disp_px) // 8 + 2, 3)).astype(np.float32)
    wide = np.stack([ndi.zoom(c, (8, 8, 1), order=3)[:h, : w + disp_px] for c in coarse]) - 0.5
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dev)
    batch = {"left": nchw(wide[:, :, :w]), "right": nchw(wide[:, :, disp_px:])}
    model = create_model("tiny", n, generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.5, 0.999))
    MedForward.launches = MedForward.bwd_launches = 0
    t0 = time.perf_counter()
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss, _ = stage1_loss(model, batch, min_disp=mn, max_disp=mx, a_p=0.0, a_sm=0.2 * 2 / 512)
        loss.backward()
        opt.step()
    with torch.no_grad():
        med = float(model(batch["left"], mn, mx).disp.median())
    secs = time.perf_counter() - t0
    levels = disparity_levels(mn, mx, n).numpy()
    spacing = levels[5] - levels[4]
    launches = (MedForward.launches, MedForward.bwd_launches)
    if launches != (steps + 1, steps) or not abs(med - disp_px) < spacing / 2:
        raise AssertionError(f"convergence: median disp {med:.4f} (want {disp_px} +- {spacing / 2:.4f}), "
                             f"launches {launches}, last loss {loss.item():.6f}")
    line(f"phase 8 convergence: {steps} steps in {secs:.2f} s, loss {loss.item():.6f}, median disparity "
         f"{med:.4f} px (target {disp_px}.00, half spacing {spacing / 2:.4f}); K1 {launches[0]}, "
         f"K2 {launches[1]} launches")
    return model, batch


def phase_converge_stage2(dev, teacher, batch):
    """scripts/verify_train_stage2_tpu.py:47-153 on the card: phase 8's
    converged model is the frozen teacher; a fresh student (seed 7) trains
    400 stage-2 steps (a_sm 2 x 0.2 x 2/512, a_mr 1) through K1's subocc mode
    and K2.  The loss must fall (step 50 against step 400, as the script's
    first and last chunk), the mirror aux must halve (step 1 against step
    400), and the student's median disparity must land on 6.00 px."""
    from fal_net_torch.ops.med import disparity_levels
    from fal_net_torch.train.stages import stage2_loss

    disp_px, _, _, _, n, mn, mx, steps = CONVERGE.values()
    teacher.requires_grad_(False).eval()
    t0_state = {k: v.clone() for k, v in teacher.state_dict().items()}
    student = create_model("tiny", n, generator=torch.Generator().manual_seed(7), device=dev)
    opt = torch.optim.Adam(student.parameters(), lr=5e-4, betas=(0.5, 0.999))
    MedForward.launches = MedForward.bwd_launches = 0
    losses, mirrors = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss, aux = stage2_loss(student, batch, teacher, min_disp=mn, max_disp=mx, a_p=0.0,
                                a_sm=2 * 0.2 * 2 / 512, a_mr=1.0)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        mirrors.append(aux["mirror_loss"].detach())
    with torch.no_grad():
        med = float(student(batch["left"], mn, mx).disp.median())
    secs = time.perf_counter() - t0
    l0, l1, m0, m1 = (float(v) for v in (losses[49], losses[-1], mirrors[0], mirrors[-1]))
    levels = disparity_levels(mn, mx, n).numpy()
    spacing = levels[5] - levels[4]
    launches = (MedForward.launches, MedForward.bwd_launches)
    frozen = all(torch.equal(v, t0_state[k]) for k, v in teacher.state_dict().items())
    if not (np.isfinite(l1) and l1 < l0 and np.isfinite(m1) and m1 < m0 / 2 and abs(med - disp_px) < spacing / 2
            and launches == (2 * steps + 1, steps) and frozen):
        raise AssertionError(f"stage-2 convergence: loss {l0:.6f} -> {l1:.6f}, mirror {m0:.6f} -> {m1:.6f}, "
                             f"median disp {med:.4f} (want {disp_px} +- {spacing / 2:.4f}), launches {launches}, "
                             f"teacher unchanged {frozen}")
    line(f"phase 8b stage-2 convergence: {steps} steps in {secs:.2f} s, loss {l0:.6f} (step 50) -> {l1:.6f}, "
         f"mirror {m0:.6f} -> {m1:.6f}, student median disparity {med:.4f} px (target {disp_px}.00, half spacing "
         f"{spacing / 2:.4f}); K1 {launches[0]}, K2 {launches[1]} launches; teacher unchanged")


def train_setup(dev, seed: int, batch_size: int = BATCH):
    """FAL_netB N=49, its Adam and a seeded 192x640 batch: the training
    step that phase 5 times (stage 1 at batch 8; stage 1 slow and stage 2 at
    their batch 4, a double batch of 8) and phase 6 profiles."""
    from fal_net_torch.train.state import create_optimizer

    model = create_model("B", 49, generator=torch.Generator().manual_seed(seed), device=dev)
    opt, sched = create_optimizer(
        model, lr=1e-4, beta1=0.5, beta2=0.999, milestones=(30, 40), lr_gamma=0.5, steps_per_epoch=1000,
    )
    rng = np.random.default_rng(seed)
    batch = {
        k: torch.from_numpy(
            np.stack([normalize(smooth_frame(rng, TRAIN_H, TRAIN_W)) for _ in range(batch_size)]).transpose(0, 3, 1, 2).copy()
        ).to(dev)
        for k in ("left", "right")
    }
    return model, opt, sched, batch


def train_step_fn(model, opt, sched, batch, loss_fn=None, **extra):
    """One training step: ``loss_fn`` (stage1_loss unless given) with the
    reference's bounds and weights, a_p = 0, backward, Adam."""
    from fal_net_torch.train.stages import stage1_loss

    loss_fn = loss_fn or stage1_loss

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batch, min_disp=2.0, max_disp=300.0, a_p=0.0, a_sm=0.2 * 2 / 512, **extra)
        loss.backward()
        opt.step()
        sched.step()

    return step


def phase_times(model, lefts, card: str, dev, seed: int):
    image = lefts[BATCH]
    times = {}
    with torch.inference_mode():
        logits = model.logits(image, 300.0)
        for mode in ("disp", "disp+pan", "disp+pan+subocc"):
            kw = MODES[mode]
            k = median_ms(lambda: med_outputs_fused(logits, image, 2.0, 300.0, **kw))
            p = median_ms(lambda: med_outputs(logits, image, 2.0, 300.0, **kw))
            out = med_outputs_fused(logits, image, 2.0, 300.0, **kw)
            need = nbytes(logits, image if "pan" in mode else None, *out)
            moved = moved_bytes("med_fwd", logits, 3, [image if "pan" in mode else None, *out],
                                disp=True, pan="pan" in mode, subocc="subocc" in mode)
            times[mode] = (k, p, need)
            line(f"phase 5 MED head ({BATCH}, 49, {SERVE_H}, {SERVE_W}) {mode}: kernel {k:.4f} ms, "
                 f"plain {p:.4f} ms, bound {need / HBM_BYTES_PER_S * 1e3:.4f} ms from "
                 f"{need / 1e6:.1f} MB; the kernel moves {moved / 1e6:.1f} MB [{card}]")
        for mode in ("disp", "disp+pan"):
            for b in (BATCH, 1):
                ms = median_ms(lambda: model(lefts[b], 2.0, 300.0, **MODES[mode]))
                line(f"phase 5 forward FAL_netB N=49 {SERVE_H}x{SERVE_W} {mode} B={b}: {ms:.3f} ms, "
                     f"{1000 * b / ms:.2f} imgs/s [{card}]")
        times["disp_logits"] = logits.numel()
        del logits

    # the training shape: K1 disp+pan, K2 in the step's mode, plain versions
    rng = np.random.default_rng(seed)
    draw = lambda c: torch.from_numpy(rng.standard_normal((BATCH, c, TRAIN_H, TRAIN_W), np.float32)).to(dev)
    tl, ti, gd, gp = draw(49), draw(3), draw(1), draw(3)
    k1 = median_ms(lambda: med_outputs_fused(tl, ti, 2.0, 300.0, ret_disp=True, ret_pan=True))
    # stage 2's student mode at its double batch of 8
    sub = MODES["disp+pan+subocc"]
    k1_sub = median_ms(lambda: med_outputs_fused(tl, ti, 2.0, 300.0, **sub), reps=20, warmup=5)
    k1_sub_plain = median_ms(lambda: med_outputs(tl, ti, 2.0, 300.0, **sub), reps=5)
    sub_out = [ti, *med_outputs_fused(tl, ti, 2.0, 300.0, **sub)]
    sub_bytes = nbytes(tl, *sub_out)
    sub_moved = moved_bytes("med_fwd", tl, 3, sub_out, disp=True, pan=True, subocc=True)
    times["sub"] = (k1_sub, k1_sub_plain, sub_bytes)
    line(f"phase 5 MED at the training shape ({BATCH}, 49, {TRAIN_H}, {TRAIN_W}): K1 disp+pan+subocc {k1_sub:.4f} ms, "
         f"plain {k1_sub_plain:.4f} ms, bound {sub_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms from {sub_bytes / 1e6:.1f} MB; "
         f"the kernel moves {sub_moved / 1e6:.1f} MB [{plan_label('med_fwd', 49, 3, TRAIN_W, pan=True, subocc=True)}] "
         f"[{card}]")
    del sub_out
    k2 = median_ms(lambda: med_vjp_fused(tl, ti, 2.0, 300.0, gd, gp, image_grad=False))
    k2_img = median_ms(lambda: med_vjp_fused(tl, ti, 2.0, 300.0, gd, gp, image_grad=True))
    vjp = median_ms(lambda: med_vjp(tl, ti, 2.0, 300.0, gd, gp, image_grad=False))

    def autograd_plain():
        lg = tl.detach().requires_grad_()
        out = med_outputs(lg, ti, 2.0, 300.0, ret_disp=True, ret_pan=True)
        torch.autograd.grad((out.disp * gd).sum() + (out.pan * gp).sum(), lg)

    auto = median_ms(autograd_plain, reps=10)
    g_logits, g_image = med_vjp_fused(tl, ti, 2.0, 300.0, gd, gp, image_grad=True)
    k1_out = [ti, *med_outputs_fused(tl, ti, 2.0, 300.0, ret_disp=True, ret_pan=True)]
    k1_bytes = nbytes(tl, *k1_out)
    k1_moved = moved_bytes("med_fwd", tl, 3, k1_out, disp=True, pan=True)
    k2_moved = moved_bytes("med_bwd", tl, 3, [ti, gd, gp, g_logits], disp=True, pan=True)
    times["k2"] = (k2, vjp)
    times["k2_bytes"] = nbytes(tl, ti, gd, gp, g_logits)
    times["k2_logits"] = tl.numel()
    ms_of = lambda b: b / HBM_BYTES_PER_S * 1e3
    line(f"phase 5 MED at the training shape ({BATCH}, 49, {TRAIN_H}, {TRAIN_W}): K1 disp+pan {k1:.4f} ms "
         f"(bound {ms_of(k1_bytes):.4f} ms from {k1_bytes / 1e6:.1f} MB; the kernel moves {k1_moved / 1e6:.1f} MB); "
         f"K2 disp+pan {k2:.4f} ms (bound {ms_of(times['k2_bytes']):.4f} ms from {times['k2_bytes'] / 1e6:.1f} MB; "
         f"the kernel moves {k2_moved / 1e6:.1f} MB), with g_img {k2_img:.4f} ms (bound "
         f"{ms_of(times['k2_bytes'] + nbytes(g_image)):.4f} ms); plain VJP {vjp:.4f} ms, autograd of the "
         f"plain head {auto:.4f} ms [{card}]")
    del tl, ti, gd, gp, g_logits, g_image

    tmodel, opt, sched, batch = train_setup(dev, seed)
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(train_step_fn(tmodel, opt, sched, batch), reps=20, warmup=5)
    times["step"] = ms
    line(f"phase 5 stage-1 step FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH} (forward, backward, Adam): "
         f"{ms:.3f} ms, {1000 * BATCH / ms:.2f} imgs/s; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    del tmodel, opt, sched, batch
    times.update(later_stage_times(dev, seed, card))
    return times


def later_stage_times(dev, seed: int, card: str) -> dict:
    """Stage 1 slow's and stage 2's steps at their batch of 4 (double
    batch 8), 192x640: CUDA events, median of 20 after 5 warm-up steps, and
    each step's peak device memory.  The stage-2 step is the teacher's
    disp-only forward under no_grad, the student's subocc forward, its
    backward and Adam."""
    from fal_net_torch.train.stages import stage1_slow_loss, stage2_loss

    times = {}
    for stage in ("stage1_slow", "stage2"):
        model, opt, sched, batch = train_setup(dev, seed, batch_size=4)
        if stage == "stage2":
            teacher = create_model("B", 49, generator=torch.Generator().manual_seed(seed + 1), device=dev)
            step = train_step_fn(model, opt, sched, batch, stage2_loss, teacher=teacher.requires_grad_(False).eval(),
                                 a_mr=1.0)
            what = "teacher disp forward, student subocc forward, backward, Adam"
        else:
            step = train_step_fn(model, opt, sched, batch, stage1_slow_loss)
            what = "forward, backward, Adam"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(step, reps=20, warmup=5)
        times[stage] = ms
        line(f"phase 5 {stage} step FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B=4, double batch 8 ({what}): {ms:.3f} ms, "
             f"{1000 * 4 / ms:.2f} pairs/s; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
             f"[{card}]")
        del model, opt, sched, batch, step
    return times


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


# kernel kinds, matched in order against device kernel names
KINDS = [
    ("K1 med_fwd", "med_fwd_kernel"),
    ("K2 med_bwd", "med_bwd_kernel"),
    ("layout transposes", "nchwtonhwc|nhwctonchw|transpose"),
    ("nearest upsample", "upsample"),
    ("ELU", "elu"),
    ("concat", "catarray|cat_"),
    ("convolutions", "conv|xmma|cudnn|implicit|gemm|cutlass|sm90|winograd|fft|dgrad|wgrad"),
    ("Adam", "adam|multi_tensor|foreach"),
    ("reductions", "reduce"),
    ("adds", "add"),
]


def profile_kinds(fn, reps: int, title: str, path: str, card: str, unit: str, no_grad: bool) -> None:
    """torch.profiler over ``reps`` calls of ``fn``: device window, busy
    share and device time by kind per call; the per-kernel table to ``path``."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ctx = torch.inference_mode if no_grad else torch.enable_grad
    with ctx():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    # device work only: the GPU-side ranges of user annotations such as
    # "Optimizer.step#Adam.step" would count their kernels twice
    kernels = [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    kind_of = lambda name: next((k for k, rx in KINDS if re.search(rx, name.lower())), "other")
    by_kind = {k: 0.0 for k, _ in KINDS} | {"other": 0.0}
    for name, us in by_name.items():
        by_kind[kind_of(name)] += us
    with open(path, "w") as f:
        f.write(f"{title}, {reps} calls [{card}]\n")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
            f.write(f"{us / reps / 1000:10.4f} ms/{unit}  {kind_of(name):18s} {name}\n")
    line(f"phase 6 profile {title}: device window {window / reps / 1000:.4f} ms/{unit}, "
         f"busy share {_union_us(spans) / window:.4f}; ms/{unit} by kind: "
         + ", ".join(f"{k} {us / reps / 1000:.4f}" for k, us in by_kind.items())
         + f"; table {path} [{card}]")


def phase_profile(model, lefts, card: str, out_dir: str, dev, seed: int, reps: int = 5) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for b in (BATCH, 1):
        profile_kinds(
            lambda: model(lefts[b], 2.0, 300.0, ret_disp=True), reps,
            f"FAL_netB N=49 {SERVE_H}x{SERVE_W} disp-only B={b}",
            os.path.join(out_dir, f"profile_b{b}.txt"), card, "fwd", no_grad=True,
        )
    with tf32(False), torch.inference_mode():
        for b in (BATCH, 1):
            ms = median_ms(lambda: model(lefts[b], 2.0, 300.0, ret_disp=True))
            line(f"phase 6 forward TF32 off FAL_netB N=49 {SERVE_H}x{SERVE_W} disp B={b}: "
                 f"{ms:.3f} ms [{card}]")
    tmodel, opt, sched, batch = train_setup(dev, seed)
    profile_kinds(
        train_step_fn(tmodel, opt, sched, batch), reps,
        f"stage-1 step FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH}",
        os.path.join(out_dir, "profile_train_step.txt"), card, "step", no_grad=False,
    )
    line(f"phase 6 peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")


def phase_scripts(card: str) -> list[dict]:
    """Phase 9: the ported kernel scripts' main() on the card; returns the
    kernels line's entries of K3, K4 and K5."""
    from fal_net_torch.ops import conv3x3, roll_probe
    from fal_net_torch.scripts import probe_roll_bug, proto_conv_kernel, proto_conv_kernel_v2

    for counts in (conv3x3.LAUNCHES, roll_probe.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    t0 = time.perf_counter()
    k3 = proto_conv_kernel.main([])  # each sets TF32 itself: off for the plain versions
    k4 = proto_conv_kernel_v2.main([])
    k5 = probe_roll_bug.main([])
    secs = time.perf_counter() - t0
    if not k5["ok"]:
        raise AssertionError("K5: ROLL PROBE: FAIL")
    launches = {
        "conv3x3_packed": conv3x3.LAUNCHES["conv3x3_packed"],
        "conv3x3_v2": conv3x3.LAUNCHES["conv3x3_v2"],
        "roll_window": roll_probe.LAUNCHES["roll_window"],
    }
    calls = {"conv3x3_packed": k3["calls"], "conv3x3_v2": k4["calls"], "roll_window": k5["calls"]}
    if launches != calls:
        raise AssertionError(f"launch counts {launches} differ from the calls made {calls}")
    entries = []
    for name, run, replaces in (
        ("conv3x3_packed", k3, "scripts/proto_conv_kernel.py:42"),
        ("conv3x3_v2", k4, "scripts/proto_conv_kernel_v2.py:41"),
    ):
        for c in run["cases"]:
            b_ms, b_by = bound(c["bytes"], c["flops"], TF32_FLOPS)
            line(f"phase 9 {name} {c['case']}: kernel {c['ms']:.4f} ms, TF32 plain {c['plain_ms']:.4f} ms, cuDNN "
                 f"fp32 {c['cudnn_fp32_ms']:.4f} ms, TF32 {c['cudnn_tf32_ms']:.4f} ms; bound {b_ms:.4f} ms by "
                 f"{b_by} ({c['flops'] / 1e9:.2f} GFLOP at {TF32_FLOPS / 1e12:.1f} TFLOP/s TF32, "
                 f"{c['bytes'] / 1e6:.1f} MB); max abs err vs TF32 plain {c['err_tf32_plain']:.3e}, vs fp32 plain "
                 f"{c['err_fp32_plain']:.3e} (cuDNN TF32 {c['err_cudnn_tf32']:.3e}) [{card}]")
        (c,) = [c for c in run["cases"] if c["case"] == CONV_TIMED]
        b_ms, b_by = bound(c["bytes"], c["flops"], TF32_FLOPS)
        entries.append({
            "name": name, "route": "cuda", "source": "fal_net_torch/csrc/conv3x3_wgmma.cu", "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(x["err_tf32_plain"] for x in run["cases"]),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": c["cudnn_tf32_ms"],  # F.conv2d with TF32 on, the kernel's precision
        })
    b_ms, b_by = bound(k5["bytes"], 0)
    line(f"phase 9 roll_window (8, 128) wp={probe_roll_bug.TIMED_WP}: kernel {k5['ms']:.4f} ms, plain "
         f"{k5['plain_ms']:.4f} ms, bound {b_ms:.6f} ms by {b_by}; {launches['roll_window']} launches [{card}]")
    entries.append({
        "name": "roll_window", "route": "cuda", "source": "fal_net_torch/csrc/roll_probe.cu",
        "replaces": "scripts/probe_roll_bug.py:25", "launches": launches["roll_window"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    line(f"phase 9 scripts: K3, K4 agree with their TF32 and fp32 plain versions in every case, K5 exact, "
         f"launches {launches} in {secs:.2f} s")
    return entries


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="DIR", help="also run phase 6, writing its tables to DIR")
    args = parser.parse_args()
    name, card = phase_device()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    phase_build()
    worst3 = phase_kernel_vs_plain(rng, dev)
    worst3b = phase_bwd_vs_plain(rng, dev)
    with tempfile.TemporaryDirectory() as workdir:
        model, lefts, serve_launches, worst4 = phase_slice(rng, dev, args.seed, workdir)
    times = phase_times(model, lefts, card, dev, args.seed)
    if args.profile:
        phase_profile(model, lefts, card, args.profile, dev, args.seed)
    del model, lefts
    with tempfile.TemporaryDirectory() as workdir:
        train = phase_train(rng, dev, workdir)
        later = phase_later_stages(dev, train["root"], train["ckpt"], workdir)
    phase_converge_stage2(dev, *phase_converge(dev))
    script_kernels = phase_scripts(card)
    k1_bound, k1_by = bound(times["disp"][2], OPS_PER_LOGIT["med_fwd"] * times["disp_logits"])
    k2_bound, k2_by = bound(times["k2_bytes"], OPS_PER_LOGIT["med_bwd"] * times["k2_logits"])
    print(json.dumps({"kernels": [
        {
            "name": "med_fwd",
            "route": "cuda",
            "source": "fal_net_torch/csrc/med_fwd.cu",
            "replaces": "fal_net_tpu/ops/med_pallas.py:116",
            # serving (phase 4) and training (phase 7a-c, 7d stage 2, 7e stage 1 slow) paths
            "launches": serve_launches + train["k1"] + later["k1"],
            "max_abs_err": max(worst3, worst4),
            "ms": times["disp"][0],  # disp-only at (8, 49, 384, 1280)
            "plain_ms": times["disp"][1],
            "bound_ms": k1_bound,
            "bound_by": k1_by,
            "library_ms": None,
        },
        {
            "name": "med_bwd",
            "route": "cuda",
            "source": "fal_net_torch/csrc/med_bwd.cu",
            "replaces": "fal_net_tpu/ops/med_pallas.py:253",
            "launches": train["k2"] + later["k2"],  # training paths (phase 7a-c, 7d, 7e)
            "max_abs_err": max(worst3b, train["worst"], later["worst"]),
            "ms": times["k2"][0],  # disp+pan cotangents, no g_img, at (8, 49, 192, 640)
            "plain_ms": times["k2"][1],
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
        *script_kernels,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

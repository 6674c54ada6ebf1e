#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fal_net_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each reported on its own line; any failure exits nonzero:
  1. device: name, power limit, TF32 settings (no GPU -> exit 1);
  2. build: compile the CUDA kernels from fal_net_torch/csrc, one nvcc per
     source, and the ops' binding (csrc/torch_ops.cpp) with the host
     compiler, all started together, each source's time printed; every
     kernel then launches through a PyTorch op (torch.ops.fal_net_torch.*);
  3. K1 vs plain: the MED forward kernel against the plain PyTorch head
     on shared seeded inputs, every mode, at the TPU kernel tests' shapes, with
     per-sample bound tensors, at the training shape (8, 49, 192, 640) and at
     the serving shape (8, 49, 384, 1280), and at W = 11,572, 32,768 and
     65,536 (the direct path: slot rows hold a 1,280-column chunk's window
     and the shift margin, the image row is read from device memory), with
     those tests' tolerances.
     Both MED kernels stage plane rows in shared memory
     (csrc/med_stage.cuh) by one of three paths, printed beside each shape:
     the whole row (N = 49, W = 640), a ring that streams the planes once a
     sweep (N = 49, W = 1280; two column chunks at W = 1500),
     and cp.async copies where W * 4 is not a multiple of 16 (W = 187);
  3b. K2 vs plain: the MED backward kernel against the plain VJP at the TPU
     gradient tests' shapes (N = 7, 33, 49 at 8x128), with per-sample bound
     tensors, at W = 187 (cp.async), (2, 49, 16, 1280) and W = 1500 (ring),
     W = 5000, 32,768 and 65,536 (the direct path: chunk windows, the image
     and g_pan rows read from device memory), disp-only and pan-only
     cotangents, with and without the image gradient, through autograd after
     a subocc forward (the masks carry no gradient), and at the training
     shape (8, 49, 192, 640; whole row); rtol 1e-4, atol 1e-5 as the TPU
     gradient tests; then the widest W each kernel takes at N = 49 in each
     mode ("not bounded by W" since the direct path; it fails otherwise) and
     on a staged path, and the largest disparity whose shift margin the
     direct path takes;
  4. the serving slice: FAL_netB N=49 with seeded random weights is saved to
     a .pt, 19 synthetic 384x1280 PNGs go through ``fal_net_torch.cli.infer``
     at batch 8, and again with ``--ms_post_process`` (two K1 launches a
     batch), then the disp+pan forward runs at batch 1 and 8, and at batch
     8 with per-sample bound tensors; each run must launch the kernel, and the
     kernel and the plain head must agree on the model's own logits;
  5. times (CUDA events, median after warm-up): K1 vs plain head at
     (8, 49, 384, 1280), the whole forward at batch 8 and batch 1, K1
     disp+pan and disp+pan+subocc (stage 2's student), K2, the plain VJP and
     autograd of the plain head at the training shape (8, 49, 192, 640); the
     stage-1 training step at batch 8, 192x640, the stage-1-slow step and
     the stage-2 step (teacher forward, student forward and backward, Adam)
     at batch 4, a double batch of 8, each with a_p 0 and with the
     perceptual term (a_p 0.01, seeded random VGG19); peak device memory of
     each step; validation's forward at batch 4, 375x1242, and K1
     disp+pan+subocc alone there; each MED kernel's bytes moved (from its
     staging plan) beside its bound;
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
     the plain VJP on the model's own logits; one batch's 16 PNGs decoded by
     the native decoder (where it built) and by PIL, beside the run's Data
     meter;
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
  7f. the reference's default run: a synthetic KITTI 2015 tree (8 frames at
     375x1242, 2 at 370x1224, sparse uint16 disparity and 16-bit RGB flow
     PNGs) read back by ``kitti2015(of=True)`` exactly; ``cli.train --stage
     1 --a_p 0.01 --vgg_weights`` (seeded random VGG19 saved with
     torchvision's keys) ``--val_root --tbatch_size 4 --profile_steps 2``
     for 2 epochs of 2 steps, ``--resume`` for a third epoch (step, Adam's
     moments and the learning rate as saved, start_epoch 2, the metrics log
     growing), and ``--stage 2 --fix_model <model_best> --a_p 0.01``; K1's
     launches counted by (mode, shape): the validation gate once per frame
     shape and trainer, then one launch per validation batch; model_best is
     the epoch of lowest RMSE; validation on K1 equals validation on the
     plain head (phase 10's tolerances); K2 against the plain VJP with the
     perceptual term's cotangents; the decoder that served is printed;
  8. convergence (scripts/verify_train_tpu.py on the card): the tiny model,
     N=9 over 2..18 px, 64x128, batch 4, Adam 5e-4 (beta1 0.5), 400 stage-1
     steps through K1 and K2 on smooth stereo shifted by 6 px; the median
     disparity must land within half a level spacing of 6.00 px;
  8b. stage-2 convergence (scripts/verify_train_stage2_tpu.py on the card):
     phase 8's model is the frozen teacher, a fresh student (seed 7) trains
     400 stage-2 steps at lr 5e-4, a_sm 2 x 0.2 x 2/512, a_mr 1; the loss
     must fall, the mirror aux must fall below half its first value and the
     student's median disparity must land within half a spacing of 6.00 px;
  10. evaluation: a synthetic KITTI-raw tree for Kitti_eigen_test_improved
     at KITTI's native sizes (8 frames at 375x1242 and 8 at 370x1224, sparse
     uint16 groundtruth and velodyne depth PNGs) and a seeded FAL_netB N=49
     checkpoint go through ``fal_net_torch.cli.test`` at batch 8 with the
     multi-scale post-process (K1 disp at the bucket shape and at its 2/3
     shape), with ``--f_post_process`` (K1 disp twice a batch), and with
     ``--save --save_pan --save_pc`` on 8 frames (K1 disp+pan+subocc and
     the 2/3 disp pass); K1's launches are counted by mode, the gate's
     included (one per mode and shape); errors.txt and metrics.json hold
     finite numbers; the kernel path's disparities and metrics equal an
     in-process Evaluator's on the plain head (``med_impl="reference"``,
     the same convolutions) within 5e-3 px + 1e-4 relative and 1e-3 on
     each metric; the multi-scale run once more with TF32 convolutions off
     (printed, not a gate); images/s of ``cli.test`` over 48 images (the
     16 frames listed three times), host decode and metrics included, over
     the whole call and over the window after each shape's first batch;
  9. the ported kernel scripts (``fal_net_torch.scripts``): K3
     (``proto_conv_kernel``) and K4 (``proto_conv_kernel_v2``), both through
     the TF32 wgmma conv, against their plain versions on TF32-truncated
     operands at rtol 1e-5, atol 1e-4 and against the fp32 plain versions
     within 2^-9 (|x| conv |w|) + 1e-4, in each of the JAX scripts' cases,
     timed beside cuDNN with TF32 off and on; K5 (``probe_roll_bug``) exact
     over the probe's sweep and wrapping shifts, timed beside ``torch.roll``
     of the zero-padded row in the same call; each launch count (the ops
     fal_net_torch::conv3x3 and roll_window count them) must equal the calls
     the scripts made;
  11. serving artifacts: ``fal_net_torch.cli.export`` of phase 4's FAL_netB
     N=49 checkpoint at 384x1280, disp at batch 8 and 1 and disp+pan+subocc
     at batch 8, and of phase 10's checkpoint at its two KITTI shapes with
     ``--with_ms_pp``; the 384x1280 artifacts loaded in a fresh interpreter
     (no fal_net_torch.models, no jax imported; K1 launched inside the
     artifacts, counted by mode) and their outputs on phase 4a's first 8
     frames held against the live model's (same weights, TF32 convolutions
     on in both) within phase 10's tolerances; ``cli.infer --artifact`` on
     phase 4a's frames against its ``--pretrained`` PNGs; ``cli.test
     --artifact`` on phase 10's tree against ``cli.test --pretrained``
     (disparities within 5e-3 px + 1e-4 relative, each metric within 1e-3;
     K1 counted by mode, the gate's included); the artifact's forward timed
     against the live model's at batch 8 and 1, in turns; and
     ``python -m fal_net_torch.cli.selfcheck --full``, which must exit 0.
  12. bf16 compute (FAL_netB N=49, the backbone in bf16, its parameters, the
     MED head and the logits fp32): ``cli.train --dtype bfloat16`` on phase
     7a's tree for 4 steps (K1, K2 per step; the checkpoint's parameters
     and Adam's state fp32); K1 inside the bf16 model against the plain head
     on its fp32 logits in every mode at phase 3's tolerances; the bf16
     drift against fp32 with TF32 off (printed, not bounded); the disp
     forward at 384x1280, B=8 and B=1, and the stage-1 step at 192x640, B=8,
     fp32 and bf16 in turns (CUDA events, median of 20) with peak memory;
     one stage-2 step with a bf16 student and teacher (K1 twice, K2 once),
     timed in turns with the fp32 student; ``cli.test --dtype bfloat16`` on
     phase 10's tree (finite metrics, K1 by mode); ``cli.export --dtype
     bfloat16`` of phase 4's checkpoint (meta dtype bfloat16, K1 inside it,
     its output equal to the live bf16 model's at phase 10's tolerances);
  13. multi-GPU: ``dryrun_multigpu(2)``, two ranks on cuda:0 over gloo (NCCL
     refuses two ranks on one card), one DDP stage-1 step of FAL_netB at
     global batch 8 with TF32 off: the ranks' all-reduced gradients held
     against the average of each rank's own gradients on its slice [r::2]
     of the global batch within 10 units of rtol 1e-4, atol 1e-6 max|g|
     (``dryrun.SAME_SPLIT``), and gradients and
     Adam moments against the one-process step within the cap that fp32
     summation order at another batch size needs (parallel/dryrun.py), K1
     and K2 launches per rank; over NCCL on two cards where two are
     visible; the same at world size 1 over NCCL; ``cli.test --num_devices 1`` against phase 10's ms-pp
     run, and an Evaluator on the mesh ["cuda:0", "cuda:0"] (each batch as
     two parts of 4) against one device at batch 4 and, with TF32 off,
     against phase 10's TF32-off run, at phase 10's tolerances (with TF32
     on against phase 10's batch 8: printed).
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
from fal_net_torch.ops.med_kernel import MedForward, describe_plan, med_outputs_fused, med_vjp_fused, stage_plan
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
    (1, 49, 4, 11572, 3, 2.0, 300.0),  # past K1's staged plans with pan: the direct path
    (1, 49, 2, 32768, 3, 2.0, 300.0),  # past every staged plan: the direct path's chunk windows
    (1, 49, 2, 65536, 3, 2.0, 300.0),
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
    (1, 49, 2, 32768, 3, 2.0, 300.0),  # past every staged plan: the direct path's chunk windows
    (1, 49, 2, 65536, 3, 2.0, 300.0),
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
A_P = 0.01  # the reference's perceptual weight (Train_Stage1_K.py:43)
# phase 7f's KITTI 2015 validation tree: frames per shape
VAL_SHAPES = {(375, 1242): 8, (370, 1224): 2}
VAL_BATCH = 4
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


WIDEST_TRIED = 1 << 20  # a plan at this width means "not bounded by W"


def widest(kernel: str, n: int = 49, c: int = 3, staged: bool = False, **flags):
    """The largest W the MED kernel takes at N = ``n`` with these outputs or
    cotangents (with ``staged``: on a staged path, not the direct one), or
    None if it takes WIDEST_TRIED."""
    def takes(w):
        try:
            plan = stage_plan(kernel, n, c, w, **flags)
        except ValueError:
            return False
        return not (staged and plan["direct"])

    if takes(WIDEST_TRIED):
        return None
    lo, hi = 1, WIDEST_TRIED  # takes(lo), not takes(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if takes(mid) else (lo, mid)
    return lo


def widest_disp(kernel: str, w: int = 65536, **flags) -> int:
    """The largest whole disparity magnitude whose shift margin the
    kernel's direct path takes at width ``w``."""
    lo, hi = 0, 100_000  # takes lo, not hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            stage_plan(kernel, 49, 3, w, max_disp=float(mid), **flags)
            lo = mid
        except ValueError:
            hi = mid
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
    path, log, secs = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    each = ", ".join(f"{src} {s:.2f} s" for src, s in secs.items() if src.endswith(".cu"))
    binding = ", ".join(f"{src} {s:.2f} s" for src, s in secs.items() if src.endswith(".cpp"))
    line(f"phase 2 build: {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s, all started together "
         f"(nvcc: {each or 'cached'}; the ops' binding, host compiler: {binding or 'cached'}; link "
         f"{secs.get('link', 0.0):.2f} s); ptxas: {'; '.join(regs) or 'cached'}")


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
            path = describe_plan("med_fwd", n, c, w, disp=kw["ret_disp"], pan=kw.get("ret_pan", False),
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
            path = describe_plan("med_bwd", n, c, w, disp=want_d, pan=want_p, image_grad=img)
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
    k1 = {mode: tuple(widest("med_fwd", staged=st, disp=True, pan="pan" in mode, subocc="subocc" in mode)
                      for st in (False, True)) for mode in MODES}
    say = lambda a: "not bounded by W" if a is None else f"to {a}"
    line("phase 3b widths at N = 49, C = 3, |disparity| <= 300: K2 "
         + ", ".join(f"{m} {say(a)} (staged to {b})" for m, (a, b) in k2.items())
         + "; K1 " + ", ".join(f"{m} {say(a)} (staged to {b})" for m, (a, b) in k1.items()))
    bounded = {m: a for m, (a, _) in {**k1, **k2}.items() if a is not None}
    if bounded:
        raise AssertionError(f"a MED kernel refuses widths (only a margin may be refused): {bounded}")
    line(f"phase 3b direct path's margin limit at W = 65536: K1 disp+pan+subocc takes |disparity| to "
         f"{widest_disp('med_fwd', pan=True, subocc=True)} px, K2 disp+pan+g_img to "
         f"{widest_disp('med_bwd', pan=True, image_grad=True)} px")
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

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    written = infer.main([
        "--pretrained", ckpt, "--images", img_dir, "--out_dir", out_dir,
        "--batch_size", str(BATCH),
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = MedForward.launches
    ms_dir = os.path.join(workdir, "out_ms")
    written_ms = infer.main([
        "--pretrained", ckpt, "--images", img_dir, "--out_dir", ms_dir, "--batch_size", str(BATCH),
        "--ms_post_process",
    ])
    torch.cuda.synchronize()
    ms_launches = MedForward.launches - cli_launches
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
    expect = 3 * batches + len(lefts) + 1  # cli.infer, with ms-pp (2 a batch), B=1 and B=8, per-sample bounds

    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith("_disp.png"))
    if written != N_IMAGES or len(pngs) != N_IMAGES:
        raise AssertionError(f"cli.infer wrote {written} / {len(pngs)} PNGs, want {N_IMAGES}")
    disp_png = np.stack([np.asarray(Image.open(os.path.join(out_dir, f))) for f in pngs])
    disp_png = disp_png.astype(np.float64) / 256.0  # uint16 value*256, floor-quantized
    if disp_png.shape != (N_IMAGES, SERVE_H, SERVE_W):
        raise AssertionError(f"disparity PNGs have shape {disp_png.shape}")
    if not (disp_png.min() >= 2.0 - 1 / 256 and disp_png.max() <= 300.0):
        raise AssertionError(f"PNG disparities span [{disp_png.min()}, {disp_png.max()}]")
    if cli_launches != batches or ms_launches != 2 * batches or launches != expect or MedForward.bwd_launches:
        raise AssertionError(
            f"kernel launches: {cli_launches} in cli.infer (want {batches}), {ms_launches} with ms-pp (want "
            f"{2 * batches}), {launches} in all (want {expect})"
        )
    ms_png = np.stack([np.asarray(Image.open(os.path.join(ms_dir, f))) for f in pngs]).astype(np.float64) / 256.0
    # the blend reaches 1.5x the 2/3 pass's disparity; the PNG caps at 65535/256
    if written_ms != N_IMAGES or ms_png.shape != disp_png.shape or not (ms_png.min() >= 2.0 - 1 / 256):
        raise AssertionError(f"cli.infer --ms_post_process: {written_ms} PNGs {ms_png.shape}, min {ms_png.min()}")
    line(f"phase 4a cli.infer: {written} disparity PNGs at {SERVE_H}x{SERVE_W} in {cli_s:.2f} s "
         f"through {cli_launches} kernel launches; PNG disparity in "
         f"[{disp_png.min():.4f}, {disp_png.max():.4f}] px; with --ms_post_process {written_ms} PNGs through "
         f"{ms_launches} launches, in [{ms_png.min():.4f}, {ms_png.max():.4f}] px")

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
    data_s = trainer.data_time.avg
    del trainer
    line(f"phase 7a cli.train FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B=8: {TRAIN_STEPS} steps in {train_s:.2f} s "
         f"(setup, gate and data included; tree written in {tree_s:.2f} s), epoch loss "
         f"{epoch['loss']:.6f} rec {epoch['rec_loss']:.6f}; K1 {k1}, K2 {k2} launches")
    decode_times(root, data_s)

    frames, out_dir = os.path.join(workdir, "frames"), os.path.join(workdir, "frames_out")
    os.makedirs(frames)
    for i in range(2):
        Image.fromarray(smooth_frame(rng, KITTI_H, KITTI_W)).save(os.path.join(frames, f"f{i}.png"))
    _build.reset_launch_counts()
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
    _build.reset_launch_counts()
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


def decode_times(root: str, data_s: float) -> None:
    """Phase 7a's decode record: the 16 375x1242 PNGs of one training batch
    decoded by native.io.decode_batch (its thread pool, all cores), by
    native.io.imread and by PIL in the loader's 4 threads (median of 5,
    file bytes already read for the batch call); beside the trainer's Data
    meter, the wait for a batch per step in the cli.train run.  No gain is
    claimed: a record."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from fal_net_torch.native import io as native_io

    stem = os.path.join(root, "2011_09_26/2011_09_26_drive_0001_sync")
    paths = [os.path.join(stem, cam, "data", f"{i:010d}.png") for i in range(BATCH) for cam in ("image_02", "image_03")]
    pil = lambda p: np.asarray(Image.open(p))
    with ThreadPoolExecutor(4) as pool:
        def timed(fn, *args):
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(*args)
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        pil_s = timed(lambda: list(pool.map(pil, paths)))
        if native_io.available():
            bufs = [open(p, "rb").read() for p in paths]
            batch_s = timed(native_io.decode_batch, bufs)
            threads_s = timed(lambda: list(pool.map(native_io.imread, paths)))
            native = f"native decode_batch {batch_s:.4f} s, native imread in 4 threads {threads_s:.4f} s, "
        else:
            native = "native decoder unavailable (not built: no libpng/libjpeg headers), "
    line(f"phase 7a decode of one batch's 16 {KITTI_H}x{KITTI_W} PNGs: {native}PIL in 4 threads {pil_s:.4f} s; "
         f"decoder serving the loader: {native_io.decoder()}; cli.train Data meter {data_s:.4f} s a step "
         f"(the wait for a batch, host clock)")


def recorded_train(argv):
    """fal_net_torch.cli.train.main(argv) with its Trainer recorded right
    after setup, with what setup restored or loaded: the teacher's state
    and the training state (step, Adam's state, learning rates, start
    epoch).  Returns (result, trainer, that record, seconds); every loss
    and validation metric of the run must be finite."""
    from fal_net_torch.cli import train
    from fal_net_torch.train.trainer import Trainer

    made = []
    setup = Trainer.setup

    def recording_setup(self):
        setup(self)
        made.append((self, {
            "teacher": None if self.teacher is None else {k: v.clone() for k, v in self.teacher.state_dict().items()},
            "step": self.step, "start_epoch": self.cfg.start_epoch, "lr": self.scheduler.get_last_lr(),
            "adam": {i: {k: v.detach().cpu().clone() if torch.is_tensor(v) else v for k, v in st.items()}
                     for i, st in self.optimizer.state_dict()["state"].items()},
        }))

    Trainer.setup = recording_setup
    t0 = time.perf_counter()
    try:
        result = train.main(argv)
        torch.cuda.synchronize()
    finally:
        Trainer.setup = setup
    secs = time.perf_counter() - t0
    ((trainer, record),) = made
    for h in result["history"]:
        if not all(np.isfinite(v) for v in h.values()):
            raise AssertionError(f"non-finite loss or validation metric: {h}")
    return result, trainer, record, secs


def run_cli_train(flags, root: str, workdir: str):
    """cli.train for TRAIN_STEPS steps of FAL_netB N=49 at 192x640 with the
    stage's default batch, a_p 0; returns (result, trainer, teacher state
    after setup, K1 launches, K2 launches, seconds)."""
    _build.reset_launch_counts()
    result, trainer, record, secs = recorded_train([
        *flags, "--model", "B", "--no_levels", "49", "--a_p", "0", "--epochs", "1",
        "--epoch_size", str(TRAIN_STEPS), "--print_freq", "1", "--data_root", root, "--lists_dir", root,
        "--save_path", os.path.join(workdir, "runs"),
    ])
    (_,) = result["history"]
    return result, trainer, record["teacher"], MedForward.launches, MedForward.bwd_launches, secs


def write_kitti2015_tree(rng, root: str) -> dict:
    """KITTI 2015's training layout at its native sizes (VAL_SHAPES): _10 and
    _11 stereo pairs (right = left shifted by KITTI_DISP px), sparse uint16
    disp_occ_0 ground truth (KITTI_DISP px at about 30% of the pixels) and
    16-bit RGB flow_occ PNGs written by native.io.imwrite_png16; returns
    the flow arrays written, by frame."""
    from PIL import Image

    from fal_net_torch.native import io as native_io

    for sub in ("image_2", "image_3", "disp_occ_0", "flow_occ"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    flows, i = {}, 0
    for (h, w), n in VAL_SHAPES.items():
        for _ in range(n):
            for fr in ("10", "11"):
                wide = smooth_frame(rng, h, w + KITTI_DISP)
                for cam, img in (("image_2", wide[:, :w]), ("image_3", wide[:, KITTI_DISP:])):
                    Image.fromarray(np.ascontiguousarray(img)).save(
                        os.path.join(root, "training", cam, f"{i:06d}_{fr}.png"))
            gt = np.where(rng.random((h, w)) < 0.3, KITTI_DISP * 256, 0).astype(np.uint16)
            Image.fromarray(gt).save(os.path.join(root, "training", "disp_occ_0", f"{i:06d}_10.png"))
            flow = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
            flow[..., 2] = rng.random((h, w)) < 0.5
            native_io.imwrite_png16(os.path.join(root, "training", "flow_occ", f"{i:06d}_10.png"), flow)
            flows[i] = flow
            i += 1
    return flows


def k1_by_shape():
    """Record each K1 launch's (mode, logits shape) while the returned list
    is open: a context manager over ops.med_kernel.med_outputs_op, the one
    Python step before the op fal_net_torch::med_fwd on the live model's
    path (the gate's included)."""
    import contextlib

    from fal_net_torch.ops import med_kernel

    @contextlib.contextmanager
    def recording():
        shapes, op = [], med_kernel.med_outputs_op

        def rec(logits, image, min_disp, max_disp, *, ret_disp=True, ret_pan=False, ret_subocc=False, cuda=True):
            mode = "+".join(n for n, w in (("disp", ret_disp), ("pan", ret_pan), ("subocc", ret_subocc)) if w)
            shapes.append((mode, tuple(logits.shape)))
            return op(logits, image, min_disp, max_disp, ret_disp=ret_disp, ret_pan=ret_pan, ret_subocc=ret_subocc,
                      cuda=cuda)

        med_kernel.med_outputs_op = rec
        try:
            yield shapes
        finally:
            med_kernel.med_outputs_op = op

    return recording()


def phase_default_run(rng, dev, kitti_root: str, workdir: str, card: str, seed: int) -> dict:
    """Phase 7f: the reference's default training run through cli.train
    (see the module docstring)."""
    from collections import Counter

    from fal_net_torch.data.datasets import kitti2015
    from fal_net_torch.data.loader import to_device
    from fal_net_torch.losses.vgg import init_vgg19
    from fal_net_torch.native import io as native_io
    from fal_net_torch.train.checkpoint import BEST_NAME
    from fal_net_torch.train.stages import stage1_loss

    val_root = os.path.join(workdir, "kitti2015")
    t0 = time.perf_counter()
    flows = write_kitti2015_tree(rng, val_root)
    tree_s = time.perf_counter() - t0
    _, flow_ds = kitti2015(val_root, split=0, disp=False, of=True)
    for i, raw in flows.items():
        valid = raw[..., 2] > 0
        want = np.stack([np.where(valid, (raw[..., 0] - 2.0**15) / 64, 0), np.where(valid, (raw[..., 1] - 2.0**15) / 64, 0),
                         valid], axis=-1).astype(np.float32)
        if not np.array_equal(flow_ds.get(i)["targets"][0], want):
            raise AssertionError(f"kitti2015(of=True): frame {i}'s flow differs from the PNG written")
    n_val = sum(VAL_SHAPES.values())
    line(f"phase 7f KITTI 2015 tree: {', '.join(f'{n} frames at {h}x{w}' for (h, w), n in VAL_SHAPES.items())} "
         f"written in {tree_s:.2f} s; kitti2015(of=True) reads the {n_val} 16-bit RGB flow PNGs back exactly; "
         f"decoder: {native_io.decoder()}")

    weights = os.path.join(workdir, "vgg19.pth")
    torch.save(init_vgg19(full=True, seed=seed).state_dict(), weights)  # torchvision's features.{i} keys
    common = ["--model", "B", "--no_levels", "49", "--a_p", str(A_P), "--vgg_weights", weights, "--val_root", val_root,
              "--tbatch_size", str(VAL_BATCH), "--epoch_size", "2", "--print_freq", "1", "--data_root", kitti_root,
              "--lists_dir", kitti_root, "--save_path", os.path.join(workdir, "runs_7f")]
    # K1 per validation pass: the batches of each shape, and the gate once per shape and trainer
    val_batches = Counter({("disp+pan+subocc", (VAL_BATCH, 49, h, w)): -(-n // VAL_BATCH)
                           for (h, w), n in VAL_SHAPES.items()})
    val_gate = Counter({("disp+pan+subocc", (1, 49, h, w)): 1 for h, w in VAL_SHAPES})
    train_shape = (49, TRAIN_H, TRAIN_W)

    def run(argv, want_k1, want_k2, label):
        _build.reset_launch_counts()
        with k1_by_shape() as shapes:
            result, trainer, record, secs = recorded_train(argv)
        got = Counter(shapes)
        if got != want_k1 or MedForward.bwd_launches != want_k2 or MedForward.launches != len(shapes):
            raise AssertionError(f"{label}: K1 launches {dict(got)} (want {dict(want_k1)}), K2 "
                                 f"{MedForward.bwd_launches} (want {want_k2})")
        return result, trainer, record, secs, got

    def epochs_line(result):
        return "; ".join(f"epoch {h['epoch']} loss {h['loss']:.6f} val rmse {h['rmse']:.4f} epe {h['epe']:.4f} "
                         f"abs_rel {h['abs_rel']:.4f}" for h in result["history"])

    def gate_err(trainer):
        return max(trainer.val_checked.values())

    # 1: stage 1, 2 epochs of 2 steps, validation each epoch, the profiler on steps 1-2
    steps = 2 * 2
    want = Counter({("disp+pan", (1, *train_shape)): 1, ("disp+pan", (BATCH, *train_shape)): steps})
    want += val_gate + Counter({k: 2 * v for k, v in val_batches.items()})
    first, trainer, _, secs, got = run(["--stage", "1", "--epochs", "2", "--profile_steps", "2", *common], want,
                                       1 + steps, "7f stage 1")
    run_dir = first["save_path"]
    best = torch.load(os.path.join(run_dir, BEST_NAME), weights_only=True)
    rmses = [h["rmse"] for h in first["history"]]
    if (best["best_metric"], best["best_value"], best["epoch"]) != ("rmse", min(rmses), int(np.argmin(rmses))):
        raise AssertionError(f"model_best: {best['best_metric']} {best['best_value']} epoch {best['epoch']}, "
                             f"epoch RMSEs {rmses}")
    traces = os.listdir(os.path.join(run_dir, "profile"))
    log_path = os.path.join(run_dir, "metrics.jsonl")
    log_lines = sum(1 for _ in open(log_path))
    worst = gate_err(trainer)
    line(f"phase 7f cli.train --stage 1 --a_p {A_P} --vgg_weights <random VGG19, torchvision keys> --val_root "
         f"--tbatch_size {VAL_BATCH} --profile_steps 2, FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH}, 2 epochs x 2 "
         f"steps in {secs:.2f} s: {epochs_line(first)}; model_best epoch {best['epoch']} (rmse "
         f"{best['best_value']:.4f}); trace {traces}; metrics.jsonl {log_lines} lines; validation gate "
         f"{ {k[1:]: f'{v:.3e}' for k, v in trainer.val_checked.items()} }")
    line(f"phase 7f K1 launches by (mode, shape): {dict(got)}; K2 {1 + steps}")
    k1_total, k2_total = sum(got.values()), 1 + steps
    kernel_trainer = trainer

    # 2: --resume for a third epoch
    ckpt = first["checkpoint"]
    saved = torch.load(ckpt, weights_only=True)
    want = Counter({("disp+pan", (1, *train_shape)): 1, ("disp+pan", (BATCH, *train_shape)): 2}) + val_gate + val_batches
    second, trainer, record, secs, got = run(["--stage", "1", "--epochs", "3", "--resume", ckpt, *common], want, 3,
                                             "7f --resume")
    adam_equal = all(torch.equal(record["adam"][i][k], v[k]) for i, v in saved["optimizer"]["state"].items()
                     for k in ("exp_avg", "exp_avg_sq", "step"))
    if not (record["step"] == saved["step"] and record["start_epoch"] == 2 and adam_equal
            and record["lr"] == saved["scheduler"]["_last_lr"] and second["save_path"] == run_dir):
        raise AssertionError(f"--resume restored step {record['step']} (saved {saved['step']}), start_epoch "
                             f"{record['start_epoch']}, Adam equal {adam_equal}, lr {record['lr']} (saved "
                             f"{saved['scheduler']['_last_lr']}), run dir {second['save_path']}")
    grown = sum(1 for _ in open(log_path))
    if grown <= log_lines:
        raise AssertionError(f"metrics.jsonl did not grow across the resume: {log_lines} -> {grown} lines")
    line(f"phase 7f cli.train --resume <epoch 1's checkpoint> --epochs 3 in {secs:.2f} s: step {record['step']}, "
         f"start_epoch {record['start_epoch']}, Adam exp_avg/exp_avg_sq/step and lr {record['lr']} equal the saved "
         f"ones; {epochs_line(second)}; best {second['best_metric']} {second['best_value']:.4f}; metrics.jsonl "
         f"{log_lines} -> {grown} lines")
    k1_total, k2_total = k1_total + sum(got.values()), k2_total + 3
    worst = max(worst, gate_err(trainer))

    # 3: stage 2 from model_best, 2 steps of the double batch with validation
    best_path = os.path.join(run_dir, BEST_NAME)
    want = Counter({("disp+pan+subocc", (1, *train_shape)): 1, ("disp", (1, *train_shape)): 1,
                    ("disp+pan+subocc", (BATCH, *train_shape)): 2, ("disp", (BATCH, *train_shape)): 2})
    want += val_gate + val_batches
    third, trainer, _, secs, got = run(["--stage", "2", "--epochs", "1", "--fix_model", best_path, *common], want, 3,
                                       "7f stage 2")
    line(f"phase 7f cli.train --stage 2 --fix_model <model_best> --a_p {A_P} --val_root, B=4 (double batch 8), "
         f"2 steps in {secs:.2f} s: {epochs_line(third)}; K1 launches {dict(got)}; K2 3")
    k1_total, k2_total = k1_total + sum(got.values()), k2_total + 3
    worst = max(worst, gate_err(trainer))
    del trainer

    # validation on the kernel path against the plain head, same weights and convolutions
    tr = kernel_trainer
    _, val_ds = kitti2015(val_root, split=0, disp=True, load_t1=False)

    def validate_with(impl):
        disps, fwd = [], tr.model.forward

        def capture(*a, **kw):
            out = fwd(*a, **kw)
            disps.append(out.disp.cpu())
            return out

        tr.model.med_impl, tr.model.forward = impl, capture
        try:
            metrics = tr.validate(val_ds, epoch=1, log_images=0)
        finally:
            del tr.model.forward
            tr.model.med_impl = "auto"
        return metrics, np.concatenate([d.numpy().ravel() for d in disps])  # batches of both frame shapes

    kern_m, kern_d = validate_with("auto")
    _build.reset_launch_counts()
    ref_m, ref_d = validate_with("reference")
    if MedForward.launches:
        raise AssertionError(f"the plain-head validation launched K1 {MedForward.launches} times")
    rtol, atol = EVAL_DISP_TOL
    disp_err = float(np.abs(kern_d - ref_d).max())
    metric_err = {k: abs(kern_m[k] - ref_m[k]) for k in kern_m}
    if not np.allclose(kern_d, ref_d, rtol=rtol, atol=atol) or max(metric_err.values()) > EVAL_METRIC_TOL:
        raise AssertionError(f"validation, kernel path vs plain head: max |d disp| {disp_err:.3e}, metrics {metric_err}")
    line(f"phase 7f validation ({n_val} frames, B={VAL_BATCH}) on K1 vs on the plain head: max |d disp| "
         f"{disp_err:.3e} px (tolerance {atol} px + {rtol} relative), max |d metric| {max(metric_err.values()):.3e} "
         f"(tolerance {EVAL_METRIC_TOL}); rmse {kern_m['rmse']:.4f} vs {ref_m['rmse']:.4f} [{card}]")

    # K2 against the plain VJP on the model's logits, the stage-1 perceptual loss's cotangents
    ds = tr.train_loader.dataset
    items = [ds.get(i, np.random.default_rng((13, i))) for i in range(BATCH)]
    batch = to_device({k: np.stack([it[k] for it in items]) for k in ("left", "right")}, dev)
    with torch.no_grad():
        logits = tr.model.logits(batch["left"], 300.0)
    lg = logits.clone().requires_grad_()
    heads = []

    def head(x, a, z, **kw):  # the model's MED head on the shared logits
        heads.append(med_outputs_fused(lg, x.contiguous(), a, z, **kw))
        return heads[-1]

    loss, aux = stage1_loss(head, batch, min_disp=2.0, max_disp=300.0, a_p=A_P, a_sm=tr.cfg.a_sm, vgg_fn=tr.vgg)
    (out,) = heads
    loss = loss * out.pan.numel()  # sum form: O(1) cotangents, so that atol 1e-5 means something
    g_disp, g_pan = torch.autograd.grad(loss, (out.disp, out.pan), retain_graph=True)
    (g_k2,) = torch.autograd.grad(loss, lg)
    torch.cuda.synchronize()
    g_plain, _ = med_vjp(logits, batch["left"], 2.0, 300.0, g_disp, g_pan, image_grad=False)
    k2_err = compare_grads((g_k2, None), (g_plain, None), "stage-1 loss with the perceptual term, model logits B=8")
    line(f"phase 7f K2 vs plain VJP with the perceptual term's cotangents (rec {aux['rec_loss'].item():.6f}): "
         f"worst abs err {k2_err:.3e}")
    return {"k1": k1_total, "k2": k2_total, "worst": worst, "k2_worst": k2_err}


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
    _build.reset_launch_counts()
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
    _build.reset_launch_counts()
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


def train_step_fn(model, opt, sched, batch, loss_fn=None, a_p=0.0, **extra):
    """One training step: ``loss_fn`` (stage1_loss unless given) with the
    reference's bounds and weights (a_p as given: with a_p > 0 ``extra``
    holds the frozen VGG as vgg_fn), backward, Adam."""
    from fal_net_torch.train.stages import stage1_loss

    loss_fn = loss_fn or stage1_loss

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batch, min_disp=2.0, max_disp=300.0, a_p=a_p, a_sm=0.2 * 2 / 512, **extra)
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
         f"the kernel moves {sub_moved / 1e6:.1f} MB [{describe_plan('med_fwd', 49, 3, TRAIN_W, pan=True, subocc=True)}] "
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
    vgg = perceptual_net(dev, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_p = median_ms(train_step_fn(tmodel, opt, sched, batch, a_p=A_P, vgg_fn=vgg), reps=20, warmup=5)
    times["step_a_p"] = ms_p
    line(f"phase 5 stage-1 step with the perceptual term (a_p {A_P}, random VGG19 to pool3) FAL_netB N=49 "
         f"{TRAIN_H}x{TRAIN_W} B={BATCH}: {ms_p:.3f} ms ({ms_p - ms:+.3f} ms against a_p 0), "
         f"{1000 * BATCH / ms_p:.2f} imgs/s; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
         f"[{card}]")
    del tmodel, opt, sched, batch
    times.update(later_stage_times(dev, seed, card, vgg))
    times.update(validation_times(dev, seed, card))
    return times


def perceptual_net(dev, seed: int):
    """The frozen VGG19 features of the perceptual term, seeded random
    weights (no pretrained ones are in the repository)."""
    from fal_net_torch.losses.vgg import init_vgg19

    return init_vgg19(seed=seed, device=dev)


def validation_times(dev, seed: int, card: str) -> dict:
    """Validation's forward at a batch of 4 KITTI 2015 frames (375x1242),
    disp + pan + subocc (FAL_netB N=49, no grad), and K1 in that mode alone
    on (4, 49, 375, 1242) logits beside the plain head: CUDA events,
    medians."""
    model = create_model("B", 49, generator=torch.Generator().manual_seed(seed), device=dev).eval()
    rng = np.random.default_rng(seed)
    left = torch.from_numpy(np.stack([normalize(smooth_frame(rng, KITTI_H, KITTI_W)) for _ in range(4)])
                            .transpose(0, 3, 1, 2).copy()).to(dev)
    sub = MODES["disp+pan+subocc"]
    with torch.inference_mode():
        fwd = median_ms(lambda: model(left, 2.0, 300.0, **sub), reps=10, warmup=2)
        logits = model.logits(left, 300.0)
        k1 = median_ms(lambda: med_outputs_fused(logits, left, 2.0, 300.0, **sub), reps=20, warmup=3)
        plain = median_ms(lambda: med_outputs(logits, left, 2.0, 300.0, **sub), reps=3, warmup=1)
        out = med_outputs_fused(logits, left, 2.0, 300.0, **sub)
    need = nbytes(logits, left, *out)
    line(f"phase 5 validation forward FAL_netB N=49 B=4 {KITTI_H}x{KITTI_W} disp+pan+subocc: {fwd:.3f} ms, "
         f"{4000 / fwd:.2f} frames/s; K1 disp+pan+subocc alone at (4, 49, {KITTI_H}, {KITTI_W}) {k1:.4f} ms, plain "
         f"{plain:.4f} ms, bound {need / HBM_BYTES_PER_S * 1e3:.4f} ms from {need / 1e6:.1f} MB "
         f"[{describe_plan('med_fwd', 49, 3, KITTI_W, pan=True, subocc=True)}] [{card}]")
    return {"val_forward": fwd, "val_k1": k1}


def later_stage_times(dev, seed: int, card: str, vgg) -> dict:
    """Stage 1 slow's and stage 2's steps at their batch of 4 (double
    batch 8), 192x640, with a_p 0 and with the perceptual term (a_p 0.01):
    CUDA events, median of 20 after 5 warm-up steps, and each step's peak
    device memory.  The stage-2 step is the teacher's disp-only forward
    under no_grad, the student's subocc forward, its backward and Adam."""
    from fal_net_torch.train.stages import stage1_slow_loss, stage2_loss

    times = {}
    for stage in ("stage1_slow", "stage2"):
        for a_p in (0.0, A_P):
            model, opt, sched, batch = train_setup(dev, seed, batch_size=4)
            extra = dict(a_p=a_p, vgg_fn=vgg if a_p else None)
            if stage == "stage2":
                teacher = create_model("B", 49, generator=torch.Generator().manual_seed(seed + 1), device=dev)
                step = train_step_fn(model, opt, sched, batch, stage2_loss,
                                     teacher=teacher.requires_grad_(False).eval(), a_mr=1.0, **extra)
                what = "teacher disp forward, student subocc forward, backward, Adam"
            else:
                step = train_step_fn(model, opt, sched, batch, stage1_slow_loss, **extra)
                what = "forward, backward, Adam"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = median_ms(step, reps=20, warmup=5)
            times[stage if not a_p else f"{stage}_a_p"] = ms
            line(f"phase 5 {stage} step a_p {a_p} FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B=4, double batch 8 ({what}): "
                 f"{ms:.3f} ms, {1000 * 4 / ms:.2f} pairs/s; peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
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


# phase 10: KITTI raw's native sizes, 8 frames each, in two drives
EVAL_SHAPES = {"2011_09_26/2011_09_26_drive_0002_sync": (375, 1242),
               "2011_09_28/2011_09_28_drive_0001_sync": (370, 1224)}
EVAL_FRAMES, EVAL_REPEAT = 8, 3
# the kernel path vs the plain head, same convolutions: disparities within
# 5e-3 px + 1e-4 relative (K1 = plain head within 1e-4 in each of the two
# passes, blended by a percentile of the first), metrics within 1e-3
EVAL_DISP_TOL, EVAL_METRIC_TOL = (1e-4, 5e-3), 1e-3


def write_eigen_tree(rng, root: str) -> dict:
    """The Kitti_eigen_test_improved layout: per frame the stereo pair and
    sparse uint16 groundtruth and velodyne depth PNGs (depth * 256, about 5%
    of the pixels set, as projected lidar); list directories "all" (the 16
    frames), "save" (the first 8) and "timed" (the 16 listed EVAL_REPEAT
    times)."""
    from PIL import Image

    lines = []
    for drive, (h, w) in EVAL_SHAPES.items():
        for i in range(EVAL_FRAMES):
            frame = f"{i:010d}.png"
            for cam in ("image_02", "image_03"):
                d = os.path.join(root, drive, cam, "data")
                os.makedirs(d, exist_ok=True)
                Image.fromarray(smooth_frame(rng, h, w)).save(os.path.join(d, frame))
            for kind in ("groundtruth", "velodyne_raw"):
                d = os.path.join(root, drive, "proj_depth", kind, "image_02")
                os.makedirs(d, exist_ok=True)
                depth = (rng.uniform(2, 80, (h, w)) * 256).astype(np.uint16)
                depth[rng.random((h, w)) > 0.05] = 0
                Image.fromarray(depth).save(os.path.join(d, frame))
            lines.append(f"{drive}/image_02/data/{frame} {drive}/image_03/data/{frame}")
    lists = {}
    for name, lst in (("all", lines), ("save", lines[:EVAL_FRAMES]), ("timed", lines * EVAL_REPEAT)):
        lists[name] = os.path.join(root, "lists", name)
        os.makedirs(lists[name])
        with open(os.path.join(lists[name], "kitti_eigen_test_improved.txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    return lists


def recorded_eval(run):
    """Call ``run()`` with every Evaluator it runs recorded and the
    disparities of each image captured; K1's launches counted by mode from
    0.  Each Evaluator's ``collect_ends`` lists (time, images, shape) as
    each batch's outputs are read and processed.  Returns (result,
    evaluators, {image index: disparity}, K1 launches by mode, seconds)."""
    from fal_net_torch.eval.evaluate import Evaluator

    made, disps = [], {}
    collect, process = Evaluator._collect, Evaluator._process_image

    def timed_collect(self, pending, *rest):
        if self not in made:  # Evaluator() and Evaluator.from_artifact alike
            self.collect_ends = []
            made.append(self)
        collect(self, pending, *rest)
        items = pending[0]
        self.collect_ends.append((time.perf_counter(), len(items), items[0][2].shape))

    def capturing(self, i, sample, left_np, disp_np, *rest):
        disps[i] = np.array(disp_np)
        process(self, i, sample, left_np, disp_np, *rest)

    Evaluator._collect, Evaluator._process_image = timed_collect, capturing
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        Evaluator._collect, Evaluator._process_image = collect, process
    return result, made, disps, dict(MedForward.mode_launches), time.perf_counter() - t0


def steady_window(ends) -> tuple[int, float]:
    """(images, seconds) of the window after every shape's first batch
    (which holds the gate and the convolutions' first call at its shapes):
    from the collect of the last shape's first batch to the last collect."""
    seen, start = set(), 0
    for k, (_, _, shape) in enumerate(ends):
        if shape not in seen:
            seen.add(shape)
            start = k
    return sum(n for _, n, _ in ends[start + 1:]), ends[-1][0] - ends[start][0]


def check_eval_outputs(out_dir: str, metrics: dict, label: str) -> None:
    """errors.txt and metrics.json written, every number finite."""
    with open(os.path.join(out_dir, "metrics.json")) as f:
        saved = json.load(f)
    with open(os.path.join(out_dir, "errors.txt")) as f:
        txt = f.read()
    nums = [float(v) for v in saved.values()]
    if not (all(np.isfinite(nums)) and "abs_rel" in txt and saved["abs_rel"] == metrics["abs_rel"]):
        raise AssertionError(f"{label}: metrics.json {saved}, errors.txt {txt!r}")


def phase_eval(rng, dev, seed: int, card: str, workdir: str) -> dict:
    """Phase 10: cli.test on the card, see the module docstring."""
    from fal_net_torch.cli import test as cli_test
    from fal_net_torch.eval.evaluate import EvalConfig, Evaluator
    from fal_net_torch.data.datasets import kitti_eigen_test_improved
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.utils.timing import tf32

    torch.backends.cudnn.allow_tf32 = True  # torch's default, which cli.test runs with
    root = os.path.join(workdir, "kitti_raw")
    t0 = time.perf_counter()
    lists = write_eigen_tree(rng, root)
    tree_s = time.perf_counter() - t0
    model = create_model("B", 49, generator=torch.Generator().manual_seed(seed + 10), device=dev)
    ckpt = os.path.join(workdir, "falnetB_n49_eval.pt")
    save_checkpoint(ckpt, model)
    del model
    n_all = EVAL_FRAMES * len(EVAL_SHAPES)
    shapes = list(EVAL_SHAPES.values())
    small = [(int(h * 2 / 3), int(w * 2 / 3)) for h, w in shapes]

    def cli(flags, lst, out):
        return lambda: cli_test.main(["--data_root", root, "--lists_dir", lists[lst], "--pretrained", ckpt,
                                      "--batch_size", str(BATCH), "--save_path", os.path.join(workdir, out),
                                      *flags])

    runs, k1_total, worst = {}, 0, 0.0
    # (flags, list, K1 launches by mode over the run's batches, the gate's
    # checks: one launch each)
    plan = {
        "ms-pp": ([], "all", {"disp": 2 * len(shapes)}, {("disp", h, w) for h, w in shapes + small}),
        "flip": (["--f_post_process"], "all", {"disp": 2 * len(shapes)}, {("disp", h, w) for h, w in shapes}),
        "save": (["--save", "--save_pan", "--save_pc"], "save", {"disp+pan+subocc": 1, "disp": 1},
                 {("disp+pan+subocc", *shapes[0]), ("disp", *small[0])}),
    }
    for name, (flags, lst, per_batch, gate_keys) in plan.items():
        metrics, (ev,), disps, by_mode, secs = recorded_eval(cli(flags, lst, f"eval_{name}"))
        check_eval_outputs(os.path.join(workdir, f"eval_{name}"), metrics, name)
        n = n_all if lst == "all" else EVAL_FRAMES
        want = dict(per_batch)
        for mode, _, _ in gate_keys:
            want[mode] += 1
        if by_mode != want or len(disps) != n or set(ev.med_checked) != gate_keys:
            raise AssertionError(f"cli.test {name}: K1 launches {by_mode} (want {want}), {len(disps)} images, "
                                 f"gate {sorted(ev.med_checked)} (want {sorted(gate_keys)})")
        worst = max([worst, *ev.med_checked.values()])
        k1_total += sum(by_mode.values())
        runs[name] = (metrics, disps)
        gate = ", ".join(f"{m} {h}x{w} {e:.3e}" for (m, h, w), e in sorted(ev.med_checked.items()))
        line(f"phase 10 cli.test {name} FAL_netB N=49 B={BATCH}, {n} images at {shapes if lst == 'all' else shapes[0]}: "
             f"{secs:.2f} s; K1 launches {by_mode}; gate {gate}; abs_rel {metrics['abs_rel']:.6f} a1 "
             f"{metrics['a1']:.6f} [{card}]")
    if not all(os.path.isfile(os.path.join(workdir, "eval_save", sub, f"{i:010d}.{ext}"))
               for i in range(EVAL_FRAMES) for sub, ext in (("disp", "png"), ("pan", "png"), ("pc", "ply"))):
        raise AssertionError("cli.test --save --save_pan --save_pc: missing exports")

    def in_process(med_impl, out):
        model = load_checkpoint(ckpt, device=dev, med_impl=med_impl)
        _, ds = kitti_eigen_test_improved(root, split=0, lists_dir=lists["all"])
        ds.raw_uint8 = True
        cfg = EvalConfig(batch_size=BATCH, save_path=os.path.join(workdir, out), print_freq=1000)
        return lambda: Evaluator(model, cfg).run(ds)

    # the plain head on the same weights and convolutions
    ms_metrics, ms_disps = runs["ms-pp"]
    ref_metrics, _, ref_disps, ref_k1, _ = recorded_eval(in_process("reference", "eval_ref"))
    if ref_k1:
        raise AssertionError(f"the plain-head Evaluator launched K1: {ref_k1}")
    rtol, atol = EVAL_DISP_TOL
    disp_err = max(float(np.abs(ms_disps[i] - ref_disps[i]).max()) for i in ms_disps)
    bad = [i for i in ms_disps if not np.allclose(ms_disps[i], ref_disps[i], rtol=rtol, atol=atol)]
    metric_err = {k: abs(ms_metrics[k] - ref_metrics[k]) for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1",
                                                                    "a2", "a3")}
    if bad or max(metric_err.values()) > EVAL_METRIC_TOL:
        raise AssertionError(f"kernel path vs plain head: images {bad} differ (max |d disp| {disp_err:.3e}), "
                             f"metrics {metric_err}")
    line(f"phase 10 kernel path vs plain head (ms-pp, {n_all} images): max |d disp| {disp_err:.3e} px "
         f"(tolerance {atol} px + {rtol} relative), max |d metric| {max(metric_err.values()):.3e} "
         f"(tolerance {EVAL_METRIC_TOL}) [{card}]")

    # TF32 drift: the same ms-pp evaluation with TF32 convolutions off (not a gate)
    with tf32(False):
        off_metrics, (ev,), off_disps, off_k1, _ = recorded_eval(in_process("auto", "eval_tf32_off"))
    k1_total += sum(off_k1.values())
    worst = max([worst, *ev.med_checked.values()])
    drift = max(float(np.abs(ms_disps[i] - off_disps[i]).max()) for i in ms_disps)
    mean_drift = float(np.mean([np.abs(ms_disps[i] - off_disps[i]).mean() for i in ms_disps]))
    line(f"phase 10 TF32 drift (ms-pp, {n_all} images, TF32 convolutions on vs off): max |d disp| {drift:.4f} px, "
         f"mean |d disp| {mean_drift:.5f} px; abs_rel {ms_metrics['abs_rel']:.6f} vs {off_metrics['abs_rel']:.6f} "
         f"(d {ms_metrics['abs_rel'] - off_metrics['abs_rel']:+.3e}), a1 {ms_metrics['a1']:.6f} vs "
         f"{off_metrics['a1']:.6f} (d {ms_metrics['a1'] - off_metrics['a1']:+.3e}) [{card}]")

    # throughput of cli.test with ms-pp: 48 images, decode and metrics included
    n_timed = n_all * EVAL_REPEAT
    timed, (ev,), disps, by_mode, secs = recorded_eval(cli([], "timed", "eval_timed"))
    batches = n_timed // BATCH
    if by_mode != {"disp": 2 * batches + len(shapes) + len(small)} or len(disps) != n_timed:
        raise AssertionError(f"timed cli.test: K1 launches {by_mode}, {len(disps)} images")
    check_eval_outputs(os.path.join(workdir, "eval_timed"), timed, "timed")
    k1_total += sum(by_mode.values())
    worst = max([worst, *ev.med_checked.values()])
    n_steady, steady_s = steady_window(ev.collect_ends)
    line(f"phase 10 cli.test ms-pp FAL_netB N=49 B={BATCH}, {n_timed} images at {shapes}: {secs:.3f} s in the call "
         f"(checkpoint load, gate, decode on 4 threads, metrics included), {n_timed / secs:.3f} images/s; "
         f"steady window after each shape's first batch: {n_steady} images in {steady_s:.3f} s, "
         f"{n_steady / steady_s:.3f} images/s; latency, the Evaluator's sec_per_image (a batch's dispatch to "
         f"its metrics, per image) {timed['sec_per_image']:.4f} s [{card}]")
    line(f"phase 10 evaluation: {k1_total} K1 launches; tree of {n_all} frames written in {tree_s:.2f} s; worst "
         f"gate abs err {worst:.3e}")
    return {"k1": k1_total, "worst": worst, "images_per_s": n_timed / secs, "steady_images_per_s": n_steady / steady_s,
            "root": root, "lists": lists["all"], "ckpt": ckpt, "ms_metrics": ms_metrics, "ms_disps": ms_disps,
            "off_metrics": off_metrics, "off_disps": off_disps}


# phase 11: the artifacts' forward in a fresh interpreter, on phase 4a's first 8 frames (raw
# uint8 for a uint8-input artifact): argv[1] is JSON [{name: artifact path}, [frame paths], output .npz]
ARTIFACT_CHILD = """
import json, sys
import numpy as np, torch
from PIL import Image
from fal_net_torch.data.transforms import normalize
from fal_net_torch.ops import _build
from fal_net_torch.ops.med_kernel import MedForward
from fal_net_torch.serve import load_exported
paths, frames, out = json.loads(sys.argv[1])
raw = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in frames])
fwds = {name: load_exported(path) for name, path in paths.items()}
_build.reset_launch_counts()
res = {name: fwd((raw if fwd.meta["input"] == "uint8" else normalize(raw))[: fwd.meta["batch"]])
       for name, fwd in fwds.items()}
torch.cuda.synchronize()
np.savez(out, **{f"{name}_{i}": t.cpu().numpy() for name, outs in res.items() for i, t in enumerate(outs)})
print(json.dumps({"k1": MedForward.mode_launches, "imported": sorted(m for m in sys.modules if m.startswith(
    "fal_net_torch.models") or m.split(".")[0] in ("jax", "fal_net_tpu"))}))
"""


def phase_artifact(dev, card: str, serve_dir: str, evaluation: dict, workdir: str) -> dict:
    """Phase 11: serving artifacts on the card (see the module docstring).
    ``serve_dir`` holds phase 4's checkpoint, frames and cli.infer PNGs;
    ``evaluation`` phase 10's tree, checkpoint, ms-pp metrics and
    disparities.  Returns the K1 launches of the artifact runs."""
    from PIL import Image

    from fal_net_torch.cli import export as cli_export
    from fal_net_torch.cli import test as cli_test
    from fal_net_torch.data.transforms import normalize, normalize_device
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.serve import load_exported

    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(serve_dir, "falnetB_n49.pt")
    art = {name: os.path.join(workdir, f"{name}.pt2z") for name in ("b8", "b1", "full", "eval")}
    exports = {  # b8 takes raw frames, as cli.infer's pipeline uploads them; the others normalized floats
        "b8": ["--pretrained", ckpt, "--batch", str(BATCH), "--uint8_input"],
        "b1": ["--pretrained", ckpt, "--batch", "1"],
        "full": ["--pretrained", ckpt, "--batch", str(BATCH), "--pan", "--subocc"],
        "eval": ["--pretrained", evaluation["ckpt"], "--batch", str(BATCH), "--with_ms_pp",
                 "--sizes", ",".join(f"{h}x{w}" for h, w in EVAL_SHAPES.values())],
    }
    t0 = time.perf_counter()
    sizes = {name: cli_export.main([*flags, "--out", art[name]]) for name, flags in exports.items()}
    export_s = time.perf_counter() - t0
    line(f"phase 11 cli.export FAL_netB N=49: {SERVE_H}x{SERVE_W} disp B={BATCH} (uint8 input) and B=1, "
         f"disp+pan+subocc B={BATCH}, and {list(EVAL_SHAPES.values())} with --with_ms_pp B={BATCH} in {export_s:.2f} s; "
         f"{', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sizes.items())}")

    # a fresh interpreter: the artifacts alone, K1 by mode, no model code
    img_dir = os.path.join(serve_dir, "images")
    frames = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))][:BATCH]
    npz = os.path.join(workdir, "artifact_outputs.npz")
    child = {k: art[k] for k in ("b8", "b1", "full")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, json.dumps([child, frames, npz])], cwd=root,
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the artifacts in a fresh interpreter failed:\n{proc.stdout}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if report["k1"] != {"disp": 2, "disp+pan+subocc": 1} or report["imported"]:
        raise AssertionError(f"fresh interpreter: K1 launches {report['k1']} (want disp 2, disp+pan+subocc 1), "
                             f"imported {report['imported']}")
    got = np.load(npz)
    raw = torch.from_numpy(np.stack([np.asarray(Image.open(f).convert("RGB")) for f in frames])).to(dev)
    x = torch.from_numpy(normalize(raw.cpu().numpy())).to(dev).permute(0, 3, 1, 2).contiguous()
    model = load_checkpoint(ckpt, device=dev).eval()
    rtol, atol = EVAL_DISP_TOL
    errs = {}
    live_u8 = lambda u8: model(normalize_device(u8.permute(0, 3, 1, 2)).contiguous(), 2.0, 300.0, ret_disp=True)
    with torch.inference_mode():
        live = model(x, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
        live1 = model(x[:1], 2.0, 300.0, ret_disp=True)
        live8 = live_u8(raw)
    for key, want in (("b8_0", live8.disp), ("b1_0", live1.disp), ("full_0", live.disp), ("full_1", live.pan),
                      ("full_2", live.maskL), ("full_3", live.maskR)):
        want = want.permute(0, 2, 3, 1).cpu().numpy()
        errs[key] = float(np.abs(got[key] - want).max())
        if got[key].shape != want.shape or not np.allclose(got[key], want, rtol=rtol, atol=atol):
            raise AssertionError(f"artifact {key} vs the live model: shape {got[key].shape}, "
                                 f"max abs err {errs[key]:.3e}")
    line(f"phase 11 fresh interpreter ({child_s:.2f} s): no fal_net_torch.models, no jax; K1 launches {report['k1']}; "
         f"artifact vs live model (same weights, TF32 convolutions on in both): "
         + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tolerance {atol} px + {rtol} relative)")

    # cli.infer --artifact on phase 4a's frames against its --pretrained PNGs
    out_dir = os.path.join(workdir, "infer_artifact")
    _build.reset_launch_counts()
    written = infer.main(["--artifact", art["b8"], "--images", img_dir, "--out_dir", out_dir])
    torch.cuda.synchronize()
    k1_infer = MedForward.mode_launches
    pngs = sorted(f for f in os.listdir(os.path.join(serve_dir, "out")) if f.endswith("_disp.png"))
    png = lambda d: np.stack([np.asarray(Image.open(os.path.join(d, f))) for f in pngs]).astype(np.float64) / 256
    a, b = png(out_dir), png(os.path.join(serve_dir, "out"))
    batches = -(-N_IMAGES // BATCH)
    if written != N_IMAGES or k1_infer != {"disp": batches} or not np.allclose(a, b, rtol=rtol, atol=atol + 1 / 256):
        raise AssertionError(f"cli.infer --artifact: {written} PNGs, K1 {k1_infer}, max |d| {np.abs(a - b).max()}")
    line(f"phase 11 cli.infer --artifact: {written} PNGs through K1 {k1_infer}; vs --pretrained's PNGs max |d disp| "
         f"{np.abs(a - b).max():.3e} px")

    # cli.test --artifact on phase 10's tree against cli.test --pretrained on the same input: the float
    # artifact takes host-normalized images, so --pretrained runs with --fp32_upload (the device's
    # normalization differs by an ulp, which TF32 convolutions can carry to pixels)
    n_all = EVAL_FRAMES * len(EVAL_SHAPES)
    common = ["--data_root", evaluation["root"], "--lists_dir", evaluation["lists"]]
    metrics, (ev,), disps, by_mode, secs = recorded_eval(lambda: cli_test.main([
        *common, "--artifact", art["eval"], "--save_path", os.path.join(workdir, "eval_artifact")]))
    check_eval_outputs(os.path.join(workdir, "eval_artifact"), metrics, "artifact")
    want_metrics, _, want_disps, _, _ = recorded_eval(lambda: cli_test.main([
        *common, "--pretrained", evaluation["ckpt"], "--fp32_upload", "--batch_size", str(BATCH),
        "--save_path", os.path.join(workdir, "eval_pretrained")]))
    shapes = list(EVAL_SHAPES.values())
    want_k1 = {"disp": 2 * (n_all // BATCH) + 2 * len(shapes)}  # the ms-pp passes, the gate at 4 shapes
    disp_err = max(float(np.abs(disps[i] - want_disps[i]).max()) for i in disps)
    bad = [i for i in disps if not np.allclose(disps[i], want_disps[i], rtol=rtol, atol=atol)]
    metric_err = {k: abs(metrics[k] - want_metrics[k]) for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2",
                                                                 "a3")}
    upload = max(abs(evaluation["ms_metrics"][k] - want_metrics[k]) for k in metric_err)
    if by_mode != want_k1 or len(disps) != n_all or bad or max(metric_err.values()) > EVAL_METRIC_TOL:
        raise AssertionError(f"cli.test --artifact: K1 {by_mode} (want {want_k1}), {len(disps)} images, images {bad} "
                             f"differ (max {disp_err:.3e}), metrics {metric_err}")
    line(f"phase 11 cli.test --artifact (ms-pp, {n_all} images, B={BATCH}) in {secs:.2f} s: K1 {by_mode}, gate "
         f"{sorted(ev.med_checked)}; vs cli.test --pretrained --fp32_upload: max |d disp| {disp_err:.3e} px, max "
         f"|d metric| {max(metric_err.values()):.3e} (tolerance {EVAL_METRIC_TOL}); abs_rel {metrics['abs_rel']:.6f} "
         f"(phase 10's uint8 upload: max |d metric| {upload:.3e} from --fp32_upload's) [{card}]")

    # the artifact's forward against the live model's, in turns (live, artifact, artifact, live): B=8 from
    # raw frames (the live model normalizes on the device first, as cli.infer does), B=1 from floats
    b8, b1 = load_exported(art["b8"]), load_exported(art["b1"])
    x1 = x[:1].permute(0, 2, 3, 1).contiguous()
    with torch.inference_mode():
        for b, live_fn, art_fn in ((BATCH, lambda: live_u8(raw), lambda: b8(raw)),
                                   (1, lambda: model(x[:1], 2.0, 300.0, ret_disp=True), lambda: b1(x1))):
            live_ms = [median_ms(live_fn)]
            art_ms = [median_ms(art_fn) for _ in range(2)]
            live_ms.append(median_ms(live_fn))
            line(f"phase 11 forward FAL_netB N=49 {SERVE_H}x{SERVE_W} disp B={b}: live model "
                 f"{live_ms[0]:.3f}, {live_ms[1]:.3f} ms; artifact {art_ms[0]:.3f}, {art_ms[1]:.3f} ms (in turns) [{card}]")

    # the health gate, in its own process
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fal_net_torch.cli.selfcheck", "--full", "--timeout", "300"],
                          cwd=root, capture_output=True, text=True, timeout=900)
    for ln in proc.stdout.strip().splitlines():
        line(f"phase 11 cli.selfcheck --full: {ln.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"cli.selfcheck --full exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    line(f"phase 11 cli.selfcheck --full exit 0 in {time.perf_counter() - t0:.2f} s")
    return {"k1": sum(report["k1"].values()) + sum(k1_infer.values()) + sum(by_mode.values())}


def peak_gb(fn) -> float:
    """Peak device memory of one call of ``fn``, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def in_turns(fns: dict, reps: int = 20) -> dict:
    """Median ms of each of two callables in turns (a, b, b, a) and each one's
    peak device memory: {name: (ms, ms, GB)}."""
    (a, fa), (b, fb) = fns.items()
    ms = {a: [median_ms(fa, reps=reps)], b: [median_ms(fb, reps=reps)]}
    ms[b].append(median_ms(fb, reps=reps))
    ms[a].append(median_ms(fa, reps=reps))
    return {k: (*ms[k], peak_gb(f)) for k, f in fns.items()}


def phase_bf16_train(root: str, workdir: str) -> dict:
    """Phase 12a: cli.train --dtype bfloat16 on phase 7a's tree, 4 steps;
    the checkpoint's parameters and Adam's state stay fp32."""
    result, trainer, _, k1, k2, secs = run_cli_train(["--stage", "1", "--dtype", "bfloat16"], root, workdir)
    (epoch,) = result["history"]
    data = torch.load(os.path.join(result["save_path"], "checkpoint.pt"), map_location="cpu", weights_only=True)
    dtypes = {v.dtype for v in data["state_dict"].values()}
    dtypes |= {t.dtype for st in data["optimizer"]["state"].values() for t in st.values()
               if torch.is_tensor(t) and t.ndim}
    if (k1, k2) != (TRAIN_STEPS + 1, TRAIN_STEPS + 1) or trainer.model.dtype != torch.bfloat16 or dtypes != {
            torch.float32}:
        raise AssertionError(f"cli.train --dtype bfloat16: K1 {k1}, K2 {k2} launches, model {trainer.model.dtype}, "
                             f"checkpoint dtypes {dtypes}")
    line(f"phase 12 cli.train --dtype bfloat16 FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH}: {TRAIN_STEPS} steps in "
         f"{secs:.2f} s, epoch loss {epoch['loss']:.6f} rec {epoch['rec_loss']:.6f}; K1 {k1}, K2 {k2} launches; "
         f"checkpoint parameters and Adam state fp32")
    return {"k1": k1, "k2": k2}


def phase_bf16(rng, dev, card: str, seed: int, serve_dir: str, evaluation: dict, workdir: str) -> dict:
    """Phase 12: bf16 compute on the card (see the module docstring)."""
    from fal_net_torch.cli import export as cli_export
    from fal_net_torch.cli import test as cli_test
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.serve import load_exported
    from fal_net_torch.train.stages import stage2_loss

    k1_total = k2_total = 0
    model32 = create_model("B", 49, generator=torch.Generator().manual_seed(seed), device=dev)
    model16 = model32.with_dtype("bfloat16")
    frames = np.stack([normalize(synthetic_image(rng)) for _ in range(BATCH)]).transpose(0, 3, 1, 2).copy()
    x8 = torch.from_numpy(frames).to(dev)

    # K1 inside the bf16 model against the plain head on the same fp32 logits, every mode
    _build.reset_launch_counts()
    worst = 0.0
    with torch.inference_mode():
        logits = model16.logits(x8, 300.0)
        if logits.dtype != torch.float32:
            raise AssertionError(f"bf16 model's logits are {logits.dtype}")
        for mode in ("disp", "disp+pan", "disp+pan+subocc"):
            got = med_outputs_fused(logits, x8, 2.0, 300.0, **MODES[mode])
            want = med_outputs(logits, x8, 2.0, 300.0, **MODES[mode])
            worst = max(worst, compare(got, want, f"bf16 model logits B={BATCH} {mode}"))
        del logits
        out = model16(x8, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
        torch.cuda.synchronize()
    k1 = MedForward.launches
    if k1 != 4 or not all(torch.isfinite(t).all() for t in out) or out.disp.dtype != torch.float32:
        raise AssertionError(f"bf16 forward: K1 {k1} launches, outputs {[t.dtype for t in out]}")
    k1_total += k1
    line(f"phase 12 K1 in the bf16 FAL_netB N=49 {SERVE_H}x{SERVE_W} B={BATCH}: fp32 logits, K1 = plain head in every "
         f"mode (phase 3's tolerances), worst abs err {worst:.3e}; {k1} K1 launches")

    # the bf16 drift against fp32, TF32 off (reported, not bounded)
    with torch.inference_mode(), tf32(False):
        d32 = model32(x8, 2.0, 300.0, ret_disp=True).disp
        d16 = model16(x8, 2.0, 300.0, ret_disp=True).disp
        drift = (d16 - d32).abs()
    line(f"phase 12 bf16 drift (FAL_netB N=49 {SERVE_H}x{SERVE_W} B={BATCH} disp, random weights, bf16 vs fp32 "
         f"with TF32 off): max |d disp| {float(drift.max()):.4f} px, mean |d disp| {float(drift.mean()):.5f} px")
    del d32, d16, drift

    # the forward at B=8 and B=1, fp32 (TF32 convs) and bf16 in turns
    times = {}
    with torch.inference_mode():
        for b in (BATCH, 1):
            x = x8[:b].contiguous()
            got = in_turns({"fp32": lambda: model32(x, 2.0, 300.0, ret_disp=True),
                            "bf16": lambda: model16(x, 2.0, 300.0, ret_disp=True)})
            times[f"fwd_b{b}"] = got
            line(f"phase 12 forward FAL_netB N=49 {SERVE_H}x{SERVE_W} disp B={b} (in turns fp32, bf16, bf16, fp32): "
                 f"fp32 {got['fp32'][0]:.3f}, {got['fp32'][1]:.3f} ms, peak {got['fp32'][2]:.2f} GB; bf16 "
                 f"{got['bf16'][0]:.3f}, {got['bf16'][1]:.3f} ms, peak {got['bf16'][2]:.2f} GB [{card}]")
    del model32, model16, x8

    # the stage-1 step at B=8 (192x640), fp32 and bf16 in turns; then one bf16 stage-2 step
    tmodel, opt, sched, batch = train_setup(dev, seed)
    t16 = tmodel.with_dtype("bfloat16")
    _build.reset_launch_counts()
    train_step_fn(t16, opt, sched, batch)()
    torch.cuda.synchronize()
    if (MedForward.launches, MedForward.bwd_launches) != (1, 1):
        raise AssertionError(f"bf16 stage-1 step: K1 {MedForward.launches}, K2 {MedForward.bwd_launches}")
    k1_total, k2_total = k1_total + 1, k2_total + 1
    got = in_turns({"fp32": train_step_fn(tmodel, opt, sched, batch), "bf16": train_step_fn(t16, opt, sched, batch)})
    times["step"] = got
    if not all(torch.isfinite(p).all() for p in tmodel.parameters()) or {p.dtype for p in tmodel.parameters()} != {
            torch.float32}:
        raise AssertionError("bf16 steps left non-finite or non-fp32 parameters")
    line(f"phase 12 stage-1 step FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH} (forward, backward, Adam; in turns): fp32 "
         f"{got['fp32'][0]:.3f}, {got['fp32'][1]:.3f} ms, peak {got['fp32'][2]:.2f} GB; bf16 {got['bf16'][0]:.3f}, "
         f"{got['bf16'][1]:.3f} ms, peak {got['bf16'][2]:.2f} GB [{card}]")
    del tmodel, opt, sched, batch, t16
    s_model, s_opt, s_sched, s_batch = train_setup(dev, seed, batch_size=BATCH // 2)
    teacher = create_model("B", 49, generator=torch.Generator().manual_seed(seed + 1), device=dev,
                           dtype="bfloat16").requires_grad_(False).eval()
    kw = dict(loss_fn=lambda *a, **k: stage2_loss(a[0], a[1], teacher, a_mr=1.0, **k))
    step2 = {"fp32": train_step_fn(s_model, s_opt, s_sched, s_batch, **kw),
             "bf16": train_step_fn(s_model.with_dtype("bfloat16"), s_opt, s_sched, s_batch, **kw)}
    _build.reset_launch_counts()
    step2["bf16"]()
    torch.cuda.synchronize()
    if (MedForward.launches, MedForward.bwd_launches) != (2, 1):
        raise AssertionError(f"bf16 stage-2 step: K1 {MedForward.launches}, K2 {MedForward.bwd_launches}")
    k1_total, k2_total = k1_total + 2, k2_total + 1
    with torch.no_grad():
        loss, _ = stage2_loss(s_model.with_dtype("bfloat16"), s_batch, teacher, min_disp=2.0, max_disp=300.0, a_p=0.0,
                              a_sm=0.4 * 2 / 512, a_mr=1.0)
    got = in_turns(step2, reps=10)
    times["step2"] = got
    line(f"phase 12 stage-2 step, bf16 student and teacher FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH // 2} (double "
         f"batch {BATCH}): K1 2, K2 1 launches, loss {loss.item():.6f}; in turns with the fp32 student (the teacher "
         f"bf16 in both): fp32 {got['fp32'][0]:.3f}, {got['fp32'][1]:.3f} ms, bf16 {got['bf16'][0]:.3f}, "
         f"{got['bf16'][1]:.3f} ms, peak {got['bf16'][2]:.2f} GB [{card}]")
    if not np.isfinite(loss.item()):
        raise AssertionError("bf16 stage-2 loss is not finite")
    del s_model, s_opt, s_sched, s_batch, teacher

    # cli.test --dtype bfloat16 on phase 10's tree
    metrics, (ev,), disps, by_mode, secs = recorded_eval(lambda: cli_test.main([
        "--data_root", evaluation["root"], "--lists_dir", evaluation["lists"], "--pretrained", evaluation["ckpt"],
        "--batch_size", str(BATCH), "--dtype", "bfloat16", "--save_path", os.path.join(workdir, "eval_bf16")]))
    check_eval_outputs(os.path.join(workdir, "eval_bf16"), metrics, "bf16")
    n_all = EVAL_FRAMES * len(EVAL_SHAPES)
    want_k1 = {"disp": 2 * (n_all // BATCH) + 2 * len(EVAL_SHAPES)}
    if by_mode != want_k1 or len(disps) != n_all or ev.model.dtype != torch.bfloat16:
        raise AssertionError(f"cli.test --dtype bfloat16: K1 {by_mode} (want {want_k1}), {len(disps)} images")
    k1_total += sum(by_mode.values())
    d_err = max(float(np.abs(disps[i] - evaluation["ms_disps"][i]).max()) for i in disps)
    line(f"phase 12 cli.test --dtype bfloat16 (ms-pp, {n_all} images, B={BATCH}) in {secs:.2f} s: K1 {by_mode}; "
         f"abs_rel {metrics['abs_rel']:.6f} a1 {metrics['a1']:.6f} (fp32, phase 10: {evaluation['ms_metrics']['abs_rel']:.6f}, "
         f"{evaluation['ms_metrics']['a1']:.6f}); max |d disp| against fp32 {d_err:.4f} px [{card}]")

    # cli.export --dtype bfloat16 of phase 4's checkpoint: the artifact against the live bf16 model
    ckpt = os.path.join(serve_dir, "falnetB_n49.pt")
    art = os.path.join(workdir, "bf16.pt2z")
    t0 = time.perf_counter()
    size = cli_export.main(["--pretrained", ckpt, "--batch", str(BATCH), "--dtype", "bfloat16", "--out", art])
    export_s = time.perf_counter() - t0
    fwd = load_exported(art)
    live = load_checkpoint(ckpt, device=dev, dtype="bfloat16")
    x = torch.from_numpy(frames).to(dev)
    _build.reset_launch_counts()
    with torch.inference_mode():
        (got,) = fwd(x.permute(0, 2, 3, 1).contiguous())
        torch.cuda.synchronize()
        k1_art = MedForward.mode_launches
        want = live(x, 2.0, 300.0, ret_disp=True).disp.permute(0, 2, 3, 1)
    err = float((got - want).abs().max())
    rtol, atol = EVAL_DISP_TOL
    if fwd.meta["dtype"] != "bfloat16" or k1_art != {"disp": 1} or not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"bf16 artifact: dtype {fwd.meta['dtype']}, K1 {k1_art}, max abs err {err:.3e}")
    k1_total += 1
    with torch.inference_mode():
        xa = x.permute(0, 2, 3, 1).contiguous()
        got_t = in_turns({"live": lambda: live(x, 2.0, 300.0, ret_disp=True), "artifact": lambda: fwd(xa)})
    line(f"phase 12 cli.export --dtype bfloat16 {SERVE_H}x{SERVE_W} disp B={BATCH} in {export_s:.2f} s, "
         f"{size / 1e6:.1f} MB, meta dtype {fwd.meta['dtype']}; K1 inside it {k1_art}; vs the live bf16 model max abs "
         f"err {err:.3e} px; forward in turns: live {got_t['live'][0]:.3f}, {got_t['live'][1]:.3f} ms, artifact "
         f"{got_t['artifact'][0]:.3f}, {got_t['artifact'][1]:.3f} ms [{card}]")
    return {"k1": k1_total, "k2": k2_total, "worst": worst, "times": times}


def phase_multi(dev, card: str, evaluation: dict, workdir: str) -> dict:
    """Phase 13: multi-GPU (see the module docstring)."""
    from fal_net_torch.cli import test as cli_test
    from fal_net_torch.data.datasets import kitti_eigen_test_improved
    from fal_net_torch.eval.evaluate import EvalConfig, Evaluator
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.parallel.dryrun import ORDER_ONLY, SAME_SPLIT, dryrun_multigpu
    from fal_net_torch.parallel.mesh import make_mesh

    n_cards = torch.cuda.device_count()
    try:
        make_mesh(n_cards + 1)
        raise AssertionError(f"make_mesh({n_cards + 1}) took {n_cards} visible cards")
    except ValueError as e:
        line(f"phase 13 make_mesh({n_cards + 1}) with {n_cards} visible: ValueError: {e}")
    k1_total = k2_total = 0
    runs = [(2, "cuda:0", "gloo", "two ranks on cuda:0")]
    if torch.cuda.device_count() >= 2:
        runs.append((2, "cuda", "nccl", "two cards"))
    runs.append((1, "cuda", "nccl", "world size 1"))
    for n, device, backend, what in runs:
        cached = torch.cuda.memory_reserved(0) / 2**30  # handed back to the ranks by the dry run
        t0 = time.perf_counter()
        rep = dryrun_multigpu(n, device, backend, store_dir=workdir, timeout=300, join_timeout=600, timed_steps=5)
        secs = time.perf_counter() - t0
        if rep["k1"] != [1] * n or rep["k2"] != [1] * n:
            raise AssertionError(f"dryrun_multigpu({n}, {backend}): K1 {rep['k1']}, K2 {rep['k2']} per rank")
        k1_total += sum(rep["k1"])
        k2_total += sum(rep["k2"])
        line(f"phase 13 dryrun_multigpu({n}) {what} over {backend}: one DDP stage-1 step FAL_netB N=49 "
             f"{TRAIN_H}x{TRAIN_W}, global batch {BATCH} ({BATCH // n} a rank), TF32 off: loss per rank "
             f"{[round(v, 6) for v in rep['loss']]} vs one process {rep['one_process_loss']:.6f}; gradients "
             f"and Adam moments against the one-process step (cuDNN deterministic): worst {rep['worst']:.3f} of "
             f"the tolerance rtol 1e-4, atol 1e-6 max|g| (limit {ORDER_ONLY}); the all-reduced gradients "
             f"against the average of the ranks' own on the global batch's slices [r::{n}]: "
             f"{rep['mean_worst']:.3f} (limit {SAME_SPLIT}); "
             f"K1 per rank {rep['k1']}, K2 per rank {rep['k2']}; step after it (median of 5, host "
             f"clock) per rank {[round(v, 3) for v in rep['step_ms']]} ms, one process "
             f"{rep['one_process_step_ms']:.3f} ms; {secs:.1f} s in all; {cached:.2f} GiB cached here before, "
             f"{rep['free_gib']:.2f} GiB free on the card as the ranks started [{card}]")

    # evaluation: cli.test --num_devices 1 and an Evaluator on ["cuda:0", "cuda:0"] against phase 10
    rtol, atol = EVAL_DISP_TOL
    n_all = EVAL_FRAMES * len(EVAL_SHAPES)

    def against(metrics, disps, want_metrics, want_disps, label):
        d_err = max(float(np.abs(disps[i] - want_disps[i]).max()) for i in want_disps)
        bad = [i for i in want_disps if not np.allclose(disps[i], want_disps[i], rtol=rtol, atol=atol)]
        m_err = max(abs(metrics[k] - want_metrics[k]) for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2",
                                                                 "a3"))
        if len(disps) != n_all or bad or m_err > EVAL_METRIC_TOL:
            raise AssertionError(f"{label}: {len(disps)} images, images {bad} differ (max {d_err:.3e}), metric "
                                 f"{m_err:.3e}")
        return d_err, m_err

    metrics, (ev,), disps, by_mode, secs = recorded_eval(lambda: cli_test.main([
        "--data_root", evaluation["root"], "--lists_dir", evaluation["lists"], "--pretrained", evaluation["ckpt"],
        "--batch_size", str(BATCH), "--num_devices", "1", "--save_path", os.path.join(workdir, "eval_n1")]))
    d_err, m_err = against(metrics, disps, evaluation["ms_metrics"], evaluation["ms_disps"],
                                   "cli.test --num_devices 1")
    k1_total += sum(by_mode.values())
    line(f"phase 13 cli.test --num_devices 1 (ms-pp, {n_all} images) in {secs:.2f} s: K1 {by_mode}; vs phase 10 max "
         f"|d disp| {d_err:.3e} px, max |d metric| {m_err:.3e}")

    model = load_checkpoint(evaluation["ckpt"], device=dev)
    _, ds = kitti_eigen_test_improved(evaluation["root"], split=0, lists_dir=evaluation["lists"])
    ds.raw_uint8 = True

    def evaluate(out, batch, mesh=None):
        cfg = EvalConfig(batch_size=batch, save_path=os.path.join(workdir, out), print_freq=1000)
        metrics, (ev,), disps, by_mode, secs = recorded_eval(lambda: Evaluator(model, cfg, mesh=mesh).run(ds))
        want_k1 = {"disp": 2 * n_all // (batch // len(mesh or [0])) + 2 * len(EVAL_SHAPES)}  # ms-pp a part; gate
        if by_mode != want_k1 or len(disps) != n_all:
            raise AssertionError(f"Evaluator {out}: K1 {by_mode} (want {want_k1}), {len(disps)} images")
        return metrics, disps, by_mode, secs, ev

    # the mesh splits each batch of 8 into two parts of 4: held exactly against one device at batch 4 (the
    # same convolutions), and against phase 10's batch 8 with TF32 off; with TF32 on, cuDNN's TF32 sums at
    # batch 4 and 8 round apart, which the random-weight net carries to pixels (reported, as phase 10's drift)
    mesh = ["cuda:0", "cuda:0"]
    m_on, d_on, k_on, s_on, ev = evaluate("mesh_tf32", BATCH, mesh)
    b4_metrics, b4_disps, k_b4, _, _ = evaluate("b4_tf32", BATCH // 2)
    with tf32(False):
        m_off, d_off, k_off, s_off, _ = evaluate("mesh_no_tf32", BATCH, mesh)
    k1_total += sum(k_on.values()) + sum(k_b4.values()) + sum(k_off.values())
    d4, m4 = against(m_on, d_on, b4_metrics, b4_disps, "mesh Evaluator (TF32) vs one device at batch 4")
    d_o, m_o = against(m_off, d_off, evaluation["off_metrics"], evaluation["off_disps"],
                               "mesh Evaluator (TF32 off) vs phase 10's TF32-off Evaluator")
    drift = max(float(np.abs(d_on[i] - evaluation["ms_disps"][i]).max()) for i in d_on)
    m_drift = max(abs(m_on[k] - evaluation["ms_metrics"][k]) for k in ("abs_rel", "sq_rel", "rms", "log_rms", "a1",
                                                                       "a2", "a3"))
    line(f"phase 13 Evaluator on the mesh [cuda:0, cuda:0] (ms-pp, {n_all} images, B={BATCH} as 2 x {BATCH // 2}) "
         f"in {s_on:.2f} s (TF32), {s_off:.2f} s (TF32 off): K1 {k_on} and {k_off}, gate {sorted(ev.med_checked)}; "
         f"vs one device at B={BATCH // 2} (TF32) max |d disp| {d4:.3e} px, max |d metric| {m4:.3e}; vs phase 10's "
         f"TF32-off Evaluator (TF32 off) {d_o:.3e} px, {m_o:.3e}; vs phase 10's cli.test at B={BATCH} (TF32, not "
         f"bounded) {drift:.4f} px, {m_drift:.3e} [{card}]")
    return {"k1": k1_total, "k2": k2_total}


def phase_scripts(card: str) -> list[dict]:
    """Phase 9: the ported kernel scripts' main() on the card; returns the
    kernels line's entries of K3, K4 and K5."""
    from fal_net_torch.ops import conv3x3, roll_probe
    from fal_net_torch.scripts import probe_roll_bug, proto_conv_kernel, proto_conv_kernel_v2

    t0 = time.perf_counter()
    _build.reset_launch_counts()
    k3 = proto_conv_kernel.main([])  # each sets TF32 itself: off for the plain versions
    k3_launches = conv3x3.LAUNCHES["conv3x3"]  # one op, fal_net_torch::conv3x3, for K3 and K4
    k4 = proto_conv_kernel_v2.main([])
    k5 = probe_roll_bug.main([])
    secs = time.perf_counter() - t0
    if not k5["ok"]:
        raise AssertionError("K5: ROLL PROBE: FAIL")
    launches = {
        "conv3x3_packed": k3_launches,
        "conv3x3_v2": conv3x3.LAUNCHES["conv3x3"] - k3_launches,
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
         f"{k5['plain_ms']:.4f} ms, torch.roll of the zero-padded row {k5['library_ms']:.4f} ms, bound "
         f"{b_ms:.6f} ms by {b_by}; {launches['roll_window']} launches [{card}]")
    entries.append({
        "name": "roll_window", "route": "cuda", "source": "fal_net_torch/csrc/roll_probe.cu",
        "replaces": "scripts/probe_roll_bug.py:25", "launches": launches["roll_window"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": k5["library_ms"],  # torch.roll of the padded row
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
    with tempfile.TemporaryDirectory() as serve_dir, tempfile.TemporaryDirectory() as eval_dir:
        model, lefts, serve_launches, worst4 = phase_slice(rng, dev, args.seed, serve_dir)
        times = phase_times(model, lefts, card, dev, args.seed)
        if args.profile:
            phase_profile(model, lefts, card, args.profile, dev, args.seed)
        del model, lefts
        with tempfile.TemporaryDirectory() as workdir:
            train = phase_train(rng, dev, workdir)
            later = phase_later_stages(dev, train["root"], train["ckpt"], workdir)
            default = phase_default_run(rng, dev, train["root"], workdir, card, args.seed)
            bf16_train = phase_bf16_train(train["root"], workdir)
        phase_converge_stage2(dev, *phase_converge(dev))
        evaluation = phase_eval(rng, dev, args.seed, card, eval_dir)
        script_kernels = phase_scripts(card)
        with tempfile.TemporaryDirectory() as workdir:
            artifact = phase_artifact(dev, card, serve_dir, evaluation, workdir)
        with tempfile.TemporaryDirectory() as workdir:
            bf16 = phase_bf16(rng, dev, card, args.seed, serve_dir, evaluation, workdir)
            multi = phase_multi(dev, card, evaluation, workdir)
    k1_bound, k1_by = bound(times["disp"][2], OPS_PER_LOGIT["med_fwd"] * times["disp_logits"])
    k2_bound, k2_by = bound(times["k2_bytes"], OPS_PER_LOGIT["med_bwd"] * times["k2_logits"])
    print(json.dumps({"kernels": [
        {
            "name": "med_fwd",
            "route": "cuda",
            "source": "fal_net_torch/csrc/med_fwd.cu",
            "replaces": "fal_net_tpu/ops/med_pallas.py:116",
            # serving (phase 4), training (phase 7a-c, 7d stage 2, 7e stage 1 slow, 7f the default run with
            # validation), evaluation (phase 10), the serving artifacts (phase 11), bf16 (phase 12) and the
            # DDP ranks and evaluation replicas (phase 13)
            "launches": serve_launches + train["k1"] + later["k1"] + default["k1"] + evaluation["k1"] + artifact["k1"]
            + bf16_train["k1"] + bf16["k1"] + multi["k1"],
            "max_abs_err": max(worst3, worst4, default["worst"], evaluation["worst"], bf16["worst"]),
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
            # training paths (phase 7a-c, 7d, 7e, 7f, the bf16 steps of phase 12, the DDP ranks of phase 13)
            "launches": train["k2"] + later["k2"] + default["k2"] + bf16_train["k2"] + bf16["k2"] + multi["k2"],
            "max_abs_err": max(worst3b, train["worst"], later["worst"], default["k2_worst"]),
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

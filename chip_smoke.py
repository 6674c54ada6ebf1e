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
     the serving shape (8, 49, 384, 1280), at FAL_netA and C's N = 33 at the
     serving width (2, 33, 16, 1280), and at W = 11,572, 32,768 and
     65,536 (the direct path: slot rows hold a 1,280-column chunk's window
     and the shift margin, the image row is read from device memory), with
     those tests' tolerances.
     Both MED kernels stage plane rows in shared memory
     (csrc/med_stage.cuh) by one of three paths, printed beside each shape:
     the whole row (N = 49, W = 640), a ring that streams the planes once a
     sweep (N = 49, W = 1280; two column chunks at W = 1500),
     and cp.async copies where W * 4 is not a multiple of 16 (W = 187);
     then the scale pass (fal_net_torch/scripts/med_scales.py): K1 in every
     mode against the plain head at TOL at logits z * s (spread) and s + z
     (offset) for s = 1e1 ... 1e6, on every staging path (whole row by bulk
     copies, cp.async, the ring, N = 33's whole row, the direct paths), one
     line a (scale, form) with the worst error over TOL and where it is;
  3b. K2 vs plain: the MED backward kernel against the plain VJP (evaluated
     in float64 on the same inputs: in fp32 its own error reaches the
     tolerance at |disparity| 300, see ``plain_vjp64``) at the TPU
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
     direct path takes; then the scale pass for K2 (as phase 3's), every
     cotangent mode against the exact VJP of the plain head's function
     (``med_scales.exact_vjp``: float64 but for the forward's fp32 lerped
     logits; the fp32 plain VJP misses by up to ~10x in the spread form, its
     disp term, and the float64 one lerps in double), one line a (scale,
     form) with K2's worst error over GRAD_TOL and the fp32 plain VJP's;
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
     staging plan) beside its bound; ``phase_deconv`` (the decoder's 2x
     deconvs as one transposed conv) against the plain deconvs on the same
     weights, in turns with peak memory: the disp forward at 384x1280, B=8
     and B=1, fp32 (TF32 convolutions) and bf16, the stage-1 step at B=8,
     and the two models' disparities with TF32 off (printed);
  6. only with ``--profile DIR``: ``torch.profiler`` over the disp-only
     forward at batch 8 and 1 and over the stage-1 training step (device
     window, busy share, kernel time by kind; the per-kernel tables go to
     DIR), and the forward with TF32 convolutions off;
  7. the training slice: a synthetic KITTI-raw tree (16 smooth 375x1242 stereo
     pairs, right = left shifted by 20 px) trains FAL_netB N=49 through
     ``fal_net_torch.cli.train --stage 1`` at batch 8, 192x640, for 2 steps;
     K1 and K2 launch once per step (and once each in the setup gate), every
     loss is finite, the checkpoint serves two frames through cli.infer; then
     one step with per-sample bound tensors (fix_order=False), and K2 against
     the plain VJP on the model's own logits; one batch's 16 PNGs decoded by
     the native decoder (where it built) and by PIL, beside the run's Data
     meter;
  7d. ``cli.train --stage 2`` on the same tree, FAL_netB N=49, 192x640, batch
     4 (double batch 8), a_p 0, 2 steps, with phase 7a's checkpoint as the
     frozen teacher (``--fix_model``): the reference's stage-1 -> stage-2
     chain.  Every loss finite; the setup gate launches K1 twice (the
     student's subocc mode, the teacher's disp-only mode) and K2 once, each
     step K1 twice (teacher, student) and K2 once; the teacher's parameters
     bit-identical afterwards; K2 against the plain VJP on the student's own
     logits after a subocc forward, with the stage-2 loss's cotangents;
  7e. ``cli.train --stage 1 --slow``, the same, 2 steps: one K1 and one K2
     launch a step on the double batch (and one each in the gate);
  7f. the reference's default run: a synthetic KITTI 2015 tree (4 frames at
     375x1242, 2 at 370x1224, sparse uint16 disparity and 16-bit RGB flow
     PNGs) read back by ``kitti2015(of=True)`` exactly; ``cli.train --stage
     1 --a_p 0.01 --vgg_weights`` (seeded random VGG19 saved with
     torchvision's keys) ``--val_root --tbatch_size 4 --profile_steps 2``
     for 2 epochs of 2 steps, ``--resume`` for a third epoch (step, Adam's
     moments and the learning rate as saved, start_epoch 2; as JAX's, a new
     run directory whose model_best is the resumed epoch, the first run's
     metrics.jsonl and settings.txt byte for byte as before), and ``--stage 2 --fix_model <model_best> --a_p 0.01``; K1's
     launches counted by (mode, shape): the validation gate once per frame
     shape and trainer, then one launch per validation batch; model_best is
     the epoch of lowest RMSE; validation on K1 equals validation on the
     plain head (phase 10's tolerances); K2 against the plain VJP with the
     perceptual term's cotangents; the decoder that served is printed;
  7g. ``remat``: ``cli.train --remat`` on the same tree, 2 steps (K1 twice a
     step: the forward and its recompute; K2 once; the gate once each;
     settings.txt says remat: True); the stage-1 loss at 192x640, B=8, and
     the stage-2 loss at B=4 (double batch 8; K1 3: the teacher's, the
     student's and its recompute) with remat, their launches counted, and
     without it from the same weights and batch (cuDNN deterministic): the
     loss and every parameter gradient bit-identical; each step timed in
     turns with the step without it (CUDA events, median of 20) with its
     peak device memory;
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
     ``--save --save_pan --save_pc`` on 2 frames (K1 disp+pan+subocc and
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
     ``python -m fal_net_torch.cli.selfcheck --full``, in its own process
     beside the fresh interpreter, which must exit 0.
  12. bf16 compute (FAL_netB N=49, the backbone in bf16, its parameters, the
     MED head and the logits fp32; the logits conv is L1,
     ``csrc/logits_conv.cu``: bf16 operands, fp32 sums and output):
     ``cli.train --dtype bfloat16`` on phase 7a's tree for 2 steps (K1, K2
     per step, L1 once a step; the checkpoint's parameters and Adam's state
     fp32); L1 against its plain version (TF32 off) at rtol 1e-5, atol 1e-5
     max|plain| (the same products summed in another order) at
     (8, 96, 384, 1280), (1, 96, 384, 1280), (8, 96, 192, 640),
     (4, 96, 375, 1242) and (8, 96, 375, 1242) -> 49, (8, 96, 384, 1280) and
     (8, 96, 192, 640) -> 33 (FAL_netA and C; x on L1's 16-byte row
     pitch, as the model builds it: 8-column padded rows at W = 1242), and
     on halo'd rows (8, 96, 98, 640) with
     pad_h 0 (a --spatial rank's), each timed in turns (medians of 20)
     beside its bound, the plain path the port ran before (an fp32 copy,
     then cuDNN with TF32) and cuDNN's bf16 conv (bf16 out, the nearest
     library call); K1 inside the bf16 model against the plain head on its
     fp32 logits in every mode at phase 3's tolerances (L1 twice); the bf16
     drift against fp32 with TF32 off (printed, not bounded); the disp
     forward at 384x1280, B=8 and B=1, and the stage-1 step at 192x640, B=8,
     fp32 and bf16 in turns (CUDA events, median of 20) with peak memory,
     the bf16 forward's peak at B=8 below fp32's; one stage-2 step with a
     bf16 student and teacher (K1 twice, K2 once, L1 twice), timed in turns
     with the fp32 student; ``cli.test --dtype bfloat16`` on phase 10's tree
     (finite metrics, K1 by mode, L1 twice a batch); ``cli.export --dtype
     bfloat16`` of phase 4's checkpoint (meta dtype bfloat16, K1 and L1
     inside it, its output equal to the live bf16 model's at phase 10's
     tolerances);
  13. multi-GPU: ``dryrun_multigpu(2)``, two ranks on cuda:0 over gloo (NCCL
     refuses two ranks on one card), one DDP stage-1 step of FAL_netB at
     global batch 8 with TF32 off (then 5 more timed with TF32 on): the ranks' all-reduced gradients held
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
     on against phase 10's batch 8: printed);
  14. row (spatial) partitioning: one spawn of two gloo ranks on cuda:0
     that split each image's rows (``parallel/spatial.py``), FAL_netB N=49:
     the disp+pan forward at 384x1280, B=8, and a stage-1 step (192x640,
     B=8) and a stage-2 step (B=4, double batch 8, a_mr 1, a seeded
     teacher), each compared with TF32 off and cuDNN deterministic against
     the same in this process: each rank's rows of disp and pan within
     phase 10's tolerances, the steps' loss at rtol 1e-5 and gradients and
     Adam moments within fixed limits in units: stage 1 ``dryrun.ORDER_ONLY``,
     stage 2 ``dryrun.STAGE2_ORDER`` (the units between the one-process
     step and the same step as two microbatches, fp32 summation order
     alone, are printed beside them); K1 and K2 per rank and K1's launch shapes (each rank's
     rows); which levels each shape splits and keeps whole; each rank's ms
     (median of 5 more, TF32 on, host clock to a device synchronise) and
     peak device memory beside one process's;
  15. the quickstart and the console scripts: ``main(["--device",
     "cuda"])`` of examples/quickstart_synthetic_torch.py in a temporary
     working directory (the tiny model, N = 9, 64x128, batch 8: the MED
     gate, 16 stage-1 steps, then the disp forward and multi-scale
     post-processing), K1 and K2 counted (gate 1 each, steps 16 each, ms-pp
     2 K1), every epoch's loss finite, the post-processed disparity finite
     within [2, 24] px (the model's disparity bounds); then each
     ``falnet-torch-*`` console script of pyproject.toml's
     ``[project.scripts]``, resolved as an installed script's wrapper
     resolves it: ``--help`` exits 0;
  16. FAL_netA and FAL_netC at their published widths and N = 33
     (fal_net_torch/scripts/verify_variants.py, the JAX package's
     scripts/verify_variants_tpu.py, from the weights that script draws):
     per variant K1 against the plain head at (1, 33, 384, 1280) with its
     plan, the disp+pan+subocc forward at 384x1280 finite in [0, 300] and
     timed at B=1 and 8, for A the maskR quirk on the same weights (maskR
     differs by more than 1e-4, disp, pan and maskL bit-identical; its B=8
     time and peak memory beside the default's), and 400 stage-1 steps
     (64x128, B=4, bounds 2..18) whose median disparity lands within half a
     level spacing of 6.00 px with falling loss, K1 401 and K2 400 launches;
     then K1 in every mode at phase 3's tolerances and K2 in every cotangent
     mode at phase 3b's at the serving (8, 33, 384, 1280), stage-1
     (8, 33, 192, 640) and evaluation (8, 33, 375, 1242; cp.async) shapes,
     each plan printed, and their times beside the plain versions and the
     bytes bound; per variant one stage-1 step (192x640, B=8; K1 1, K2 1),
     K2 against the plain VJP on the model's own logits with the loss's
     cotangents, the steps timed in turns with FAL_netB N=49's (medians of
     10) with peak memory; the bf16 forward at 384x1280, B=8 (K1 = plain head on its fp32
     logits in every mode; K1 1, L1 1 at 33 output channels), timed in turns
     with fp32 (medians of 10); ``cli.train --model A|C --no_levels 33`` on a KITTI-raw tree
     as phase 7a's, for 2 steps (K1, K2 3 each), each checkpoint through
     ``cli.infer`` with the variant read from it (K1 at N = 33), and
     ``cli.test --maskr_quirk
     --save --save_pan`` on A's checkpoint and 2 of phase 10's frames (K1 by
     mode, metrics finite, exports written);
  17. the training soak (fal_net_torch/scripts/soak_train.py, the JAX
     package's scripts/soak_train_tpu.py): ``Trainer.fit`` on FAL_netB N=49
     at 192x640, batch 8, in bf16, on the JAX script's smooth stereo, 2
     epochs of 25 steps with a checkpoint every 10 steps, then a fresh
     Trainer resumed from the last checkpoint for a third epoch: the step at
     50 and 75, one resumed epoch, finite losses, the resumed loss below 1.2x
     phase 1's, the step-10 checkpoint restoring its step, weights and Adam
     state exactly in a throwaway Trainer, K1 and K2 once a step and once a
     gate, L1 once a step; each phase's host seconds, the median step by
     CUDA events and the Data meter printed.
After the phases a line gives the seconds each took on the host clock.
The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
from fal_net_torch.ops.logits_conv import LAUNCHES as L1_LAUNCHES
from fal_net_torch.ops.logits_conv import logits_conv, logits_conv_plain, pitched_empty
from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_kernel import MedForward, describe_plan, med_outputs_fused, med_vjp_fused, stage_plan
from fal_net_torch.ops.med_vjp import med_vjp
from fal_net_torch.scripts import med_scales
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
    (2, 33, 16, 1280, 3, 2.0, 300.0),  # FAL_netA and C's N = 33 at the serving width
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
TRAIN_H, TRAIN_W, TRAIN_STEPS, KITTI_H, KITTI_W, KITTI_PAIRS, KITTI_DISP = 192, 640, 2, 375, 1242, 16, 20
A_P = 0.01  # the reference's perceptual weight (Train_Stage1_K.py:43)
# phase 7f's KITTI 2015 validation tree: frames per shape
VAL_SHAPES = {(375, 1242): 4, (370, 1224): 2}
VAL_BATCH = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, NVIDIA data sheet
TF32_FLOPS = 494.7e12  # H100 SXM TF32 tensor cores, dense, NVIDIA data sheet
BF16_FLOPS = 989.4e12  # H100 SXM bf16 tensor cores, dense, NVIDIA data sheet
# L1 (the composed logits conv) against its plain version: ((B, Cin, H, W), Cout, pad_h); the serving, B=1,
# stage-1, validation and bf16 cli.test shapes, a rank's halo'd rows under --spatial 4 at 384 rows (96 + 2), and
# FAL_netA and C's serving and stage-1 shapes (33 output channels)
L1_SHAPES = [((8, 96, 384, 1280), 49, 1), ((1, 96, 384, 1280), 49, 1), ((8, 96, 192, 640), 49, 1),
             ((4, 96, 375, 1242), 49, 1), ((8, 96, 375, 1242), 49, 1), ((8, 96, 98, 640), 49, 0),
             ((8, 96, 384, 1280), 33, 1), ((8, 96, 192, 640), 33, 1)]
L1_TOL = 1e-5  # rtol, and atol as a fraction of max|plain|: the same products summed in another order
CONV_TIMED = (8, 64, 192, 640, 64)  # the conv case whose times go into the kernels line
# fp32 operations per logit, counted from the kernel sources (an exp2 counts
# one): K1 disp-only (max, subtract, multiply by log2 e, exp2, add,
# multiply-add; the rescale once a stage of 7 planes is below one); K2 in the
# training mode, C=3 (statistics sweep 25 with two exp2, gradient sweep 41
# with three, each with one logit lerp of four operations; disp's weights,
# taken in double, count as one fp32 exp2 each, so the operations bound is
# low: bytes bound K2 at every shape timed here)
OPS_PER_LOGIT = {"med_fwd": 6, "med_bwd": 66}


PHASE_S: dict = {}  # seconds each phase took, by phase


def timed(label: str, fn, *args):
    """``fn(*args)``, its seconds on the host clock kept in PHASE_S[label]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[label] = round(time.perf_counter() - t0, 1)


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


def plan_words(kernel: str, n: int, c: int, w: int, **flags) -> str:
    """The staging plan in words (``describe_plan``) with its threads and
    columns a thread."""
    p = stage_plan(kernel, n, c, w, **flags)
    return f"{describe_plan(kernel, n, c, w, **flags)}, {p['consumers']} threads x {p['cpt']} columns"


def k1_vs_plain(rng, dev, shapes) -> float:
    """K1 against the plain head at each of ``shapes`` in every mode at TOL;
    returns the worst abs error."""
    worst = 0.0
    for b, n, h, w, c, mn, mx in shapes:
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
            path = plan_words("med_fwd", n, c, w, disp=kw["ret_disp"], pan=kw.get("ret_pan", False),
                           subocc=kw.get("ret_subocc", False))
            worst = max(worst, compare(got, want, f"{label} {mode} [{path}]"))
    return worst


def scale_pass(phase: str, kernel: str, dev) -> None:
    """``med_scales.check`` of ``kernel`` ("k1" or "k2") at every scale and
    form; raises on a miss."""
    res = med_scales.check(kernels=(kernel,), device=dev, say=line)
    worst = max(res[kernel].values())
    line(f"phase {phase} scale pass: {kernel.upper()} at logits of 1e1 to 1e6 (spread and offset) on "
         f"{len(med_scales.PATHS[kernel])} staging paths, worst {worst:.3f} of its tolerance")
    if not res["ok"]:
        raise AssertionError(f"phase {phase}: {kernel.upper()} misses its tolerance at large logits: {res}")


def phase_kernel_vs_plain(rng, dev) -> float:
    worst = k1_vs_plain(rng, dev, SHAPES)
    line(f"phase 3 kernel vs plain: {len(SHAPES)} shapes x {len(MODES)} modes agree, "
         f"worst abs err {worst:.3e}")
    scale_pass("3", "k1", dev)
    return worst


def plain_vjp64(logits, image, mn, mx, g_disp, g_pan, image_grad=True):
    """The plain VJP evaluated in float64 on the same inputs (and the same
    fp32 plane tables), cast back to fp32: the reference K2 is held to.  Its
    fp32 evaluation comes within a hair of GRAD_TOL by itself where d_n is
    near disp at |disparity| up to 300 (disp's rounding times sm0_n g_disp;
    fal_net_torch/scripts/med_times.py prints both errors), so that
    it would measure its own error beside the kernel's."""
    up = lambda t: t.double() if torch.is_tensor(t) else t
    g, g_img = med_vjp(up(logits), up(image), up(mn), up(mx), up(g_disp), up(g_pan), image_grad=image_grad)
    return g.float(), None if g_img is None else g_img.float()


def k2_vs_plain(rng, dev, shapes) -> float:
    """K2 against the plain VJP (in float64, :func:`plain_vjp64`) at each of
    ``shapes`` in every cotangent mode and through autograd after a subocc
    forward, at GRAD_TOL; returns the worst abs error."""
    worst = 0.0
    for b, n, h, w, c, mn, mx in shapes:
        draw = lambda ch: torch.from_numpy(rng.standard_normal((b, ch, h, w), np.float32)).to(dev)
        logits, image, g_disp, g_pan = draw(n), draw(c), draw(1), draw(c)
        label = f"{(b, n, h, w, c)} [{mn},{mx}]"
        if isinstance(mn, tuple) or isinstance(mx, tuple):
            mn, mx = (torch.tensor(v, dtype=torch.float32, device=dev).expand(b) for v in (mn, mx))
        for mode, (want_d, want_p, img) in GRAD_MODES.items():
            gd, gp = (g_disp if want_d else None), (g_pan if want_p else None)
            got = med_vjp_fused(logits, image, mn, mx, gd, gp, image_grad=img)
            torch.cuda.synchronize()
            want = plain_vjp64(logits, image, mn, mx, gd, gp, image_grad=img)
            path = plan_words("med_bwd", n, c, w, disp=want_d, pan=want_p, image_grad=img)
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
        want = plain_vjp64(logits, image, mn, mx, g_disp, g_pan)
        worst = max(worst, compare_grads(got, want, f"{label} autograd after subocc forward"))
    return worst


def phase_bwd_vs_plain(rng, dev) -> float:
    worst = k2_vs_plain(rng, dev, GRAD_SHAPES)
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
    scale_pass("3b", "k2", dev)
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
        Image.fromarray(synthetic_image(rng)).save(os.path.join(img_dir, f"frame{i:02d}.png"), compress_level=1)
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
            Image.fromarray(np.ascontiguousarray(img)).save(os.path.join(d, f"{i:010d}.png"), compress_level=1)
        lines.append(f"{stem}/image_02/data/{i:010d}.png {stem}/image_03/data/{i:010d}.png")
    with open(os.path.join(root, "kitti_eigen_train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_train(rng, dev, workdir: str):
    """cli.train on a synthetic tree, then one per-sample-bound step."""
    from PIL import Image

    from fal_net_torch.data.loader import to_device
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
        Image.fromarray(smooth_frame(rng, KITTI_H, KITTI_W)).save(os.path.join(frames, f"f{i}.png"), compress_level=1)
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
    worst = k2_on_logits(logits, batch, mn, mx, cfg.a_sm, f"model logits B=8 per-sample bounds ({signs} swapped)")
    line(f"phase 7c per-sample-bound step (fix_order=False): loss {metrics['loss']:.6f}, K1 {k1_t}, "
         f"K2 {k2_t} launches; K2 vs plain VJP on the model's logits, worst abs err {worst:.3e}")
    return {"k1": k1 + infer_k1 + k1_t, "k2": k2 + k2_t, "worst": worst, "root": root, "ckpt": ckpt}


def k2_on_logits(logits, batch, mn, mx, a_sm: float, label: str) -> float:
    """K2 against the plain VJP (in float64, :func:`plain_vjp64`) on a
    model's own ``logits`` with the stage-1 loss's cotangents (a_p 0), the
    loss in sum form (times the pan's element count) so that the cotangents
    are O(1) and atol 1e-5 means something; returns the worst abs error."""
    from fal_net_torch.losses.photometric import rec_loss
    from fal_net_torch.losses.smoothness import smoothness

    left, right = batch["left"], batch["right"]
    lg = logits.clone().requires_grad_()
    out = med_outputs_fused(lg, left, mn, mx, ret_disp=True, ret_pan=True)
    x0 = int(0.2 * left.shape[-1])
    loss = out.pan.numel() * (
        rec_loss(1.0, out.pan, right, None, 0.0) + a_sm * smoothness(left[..., x0:], out.disp[..., x0:], gamma=2.0)
    )
    g_disp, g_pan = torch.autograd.grad(loss, (out.disp, out.pan), retain_graph=True)
    (g_k2,) = torch.autograd.grad(loss, lg)
    torch.cuda.synchronize()
    g_plain, _ = plain_vjp64(logits, left, mn, mx, g_disp, g_pan, image_grad=False)
    return compare_grads((g_k2, None), (g_plain, None), label)


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


def run_cli_train(flags, root: str, workdir: str, model: str = "B", levels: int = 49):
    """cli.train for TRAIN_STEPS steps of ``model`` (FAL_netB N=49 unless
    given) at 192x640 with the stage's default batch, a_p 0; returns
    (result, trainer, teacher state after setup, K1 launches, K2 launches,
    seconds)."""
    _build.reset_launch_counts()
    result, trainer, record, secs = recorded_train([
        *flags, "--model", model, "--no_levels", str(levels), "--a_p", "0", "--epochs", "1",
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
                        os.path.join(root, "training", cam, f"{i:06d}_{fr}.png"), compress_level=1)
            gt = np.where(rng.random((h, w)) < 0.3, KITTI_DISP * 256, 0).astype(np.uint16)
            Image.fromarray(gt).save(os.path.join(root, "training", "disp_occ_0", f"{i:06d}_10.png"), compress_level=1)
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
    root_7f = os.path.join(workdir, "runs_7f")
    common = ["--model", "B", "--no_levels", "49", "--a_p", str(A_P), "--vgg_weights", weights, "--val_root", val_root,
              "--tbatch_size", str(VAL_BATCH), "--epoch_size", "2", "--print_freq", "1", "--data_root", kitti_root,
              "--lists_dir", kitti_root, "--save_path", root_7f]
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
    first_files = {name: open(os.path.join(run_dir, name), "rb").read() for name in ("metrics.jsonl", "settings.txt")}
    worst = gate_err(trainer)
    line(f"phase 7f cli.train --stage 1 --a_p {A_P} --vgg_weights <random VGG19, torchvision keys> --val_root "
         f"--tbatch_size {VAL_BATCH} --profile_steps 2, FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH}, 2 epochs x 2 "
         f"steps in {secs:.2f} s: {epochs_line(first)}; model_best epoch {best['epoch']} (rmse "
         f"{best['best_value']:.4f}); trace {traces}; metrics.jsonl {log_lines} lines; validation gate "
         f"{ {k[1:]: f'{v:.3e}' for k, v in trainer.val_checked.items()} }")
    line(f"phase 7f K1 launches by (mode, shape): {dict(got)}; K2 {1 + steps}")
    k1_total, k2_total = sum(got.values()), 1 + steps
    kernel_trainer = trainer

    # 2: --resume for a third epoch, in a new run directory whose best starts at -1 (as JAX's)
    ckpt = first["checkpoint"]
    saved = torch.load(ckpt, weights_only=True)
    want = Counter({("disp+pan", (1, *train_shape)): 1, ("disp+pan", (BATCH, *train_shape)): 2}) + val_gate + val_batches
    second, trainer, record, secs, got = run(["--stage", "1", "--epochs", "3", "--resume", ckpt, *common], want, 3,
                                             "7f --resume")
    adam_equal = all(torch.equal(record["adam"][i][k], v[k]) for i, v in saved["optimizer"]["state"].items()
                     for k in ("exp_avg", "exp_avg_sq", "step"))
    new_dir = second["save_path"]
    if not (record["step"] == saved["step"] and record["start_epoch"] == 2 and adam_equal
            and record["lr"] == saved["scheduler"]["_last_lr"] and new_dir != run_dir):
        raise AssertionError(f"--resume restored step {record['step']} (saved {saved['step']}), start_epoch "
                             f"{record['start_epoch']}, Adam equal {adam_equal}, lr {record['lr']} (saved "
                             f"{saved['scheduler']['_last_lr']}), run dir {new_dir} (the first run's {run_dir})")
    untouched = [name for name, data in first_files.items() if open(os.path.join(run_dir, name), "rb").read() != data]
    resumed_best = torch.load(os.path.join(new_dir, BEST_NAME), weights_only=True)
    (epoch2,) = second["history"]
    if untouched or (resumed_best["epoch"], resumed_best["best_value"]) != (2, epoch2["rmse"]) or \
            second["best_value"] != epoch2["rmse"]:
        raise AssertionError(f"--resume: the first run's {untouched} changed; the resumed run's model_best epoch "
                             f"{resumed_best['epoch']} rmse {resumed_best['best_value']} (its epoch 2: {epoch2['rmse']})")
    new_lines = sum(1 for _ in open(os.path.join(new_dir, "metrics.jsonl")))
    line(f"phase 7f cli.train --resume <epoch 1's checkpoint> --epochs 3 in {secs:.2f} s: step {record['step']}, "
         f"start_epoch {record['start_epoch']}, Adam exp_avg/exp_avg_sq/step and lr {record['lr']} equal the saved "
         f"ones; {epochs_line(second)}; a new run directory {os.path.relpath(new_dir, root_7f)!r} "
         f"beside the first's {os.path.relpath(run_dir, root_7f)!r}; its model_best epoch 2 (best starts at -1: rmse {second['best_value']:.4f}, the first "
         f"run's best {best['best_value']:.4f}); the first run's metrics.jsonl ({log_lines} lines) and settings.txt "
         f"byte for byte as before; the resumed run's metrics.jsonl {new_lines} lines")
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
    g_plain, _ = plain_vjp64(logits, batch["left"], 2.0, 300.0, g_disp, g_pan, image_grad=False)
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
    g_plain, _ = plain_vjp64(logits, s_in, mn, mx, g_disp, g_pan, image_grad=False)
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
    from fal_net_torch.ops.med import disparity_levels
    from fal_net_torch.scripts.verify_variants import synthetic_stereo
    from fal_net_torch.train.stages import stage1_loss

    disp_px, h, w, b, n, mn, mx, steps = CONVERGE.values()
    batch = dict(zip(("left", "right"), (torch.from_numpy(a).to(dev) for a in synthetic_stereo(disp_px, h, w, b))))
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


def train_setup(dev, seed: int, batch_size: int = BATCH, phase_deconv: bool = False, variant: str = "B",
                levels: int = 49):
    """FAL_netB N=49 (or ``variant`` at ``levels``), its Adam and a seeded
    192x640 batch: the training step that phase 5 times (stage 1 at batch 8;
    stage 1 slow and stage 2 at their batch 4, a double batch of 8), phase 6
    profiles and phase 16 runs for FAL_netA and C."""
    from fal_net_torch.train.state import create_optimizer

    model = create_model(variant, levels, generator=torch.Generator().manual_seed(seed), device=dev,
                         phase_deconv=phase_deconv)
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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def loss_and_grads(step_model, model, batch, loss_fn=None) -> dict:
    """The stage loss of ``step_model`` (``model`` or a wrapper of it) as a
    training step computes it, and every gradient of ``model``'s parameters,
    by name; no optimizer step."""
    from fal_net_torch.train.stages import stage1_loss

    model.zero_grad(set_to_none=True)
    loss, _ = (loss_fn or stage1_loss)(step_model, batch, min_disp=2.0, max_disp=300.0, a_p=0.0, a_sm=0.2 * 2 / 512)
    loss.backward()
    grads = {"loss": loss.detach().clone(),
             **{n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}}
    model.zero_grad(set_to_none=True)
    return grads


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
    times.update(timed("5 phase_deconv", phase_deconv_times, lefts, card, dev, seed))
    return times


def phase_deconv_times(lefts, card: str, dev, seed: int) -> dict:
    """Phase 5's phase_deconv rows: the decoder's exactly-2x deconvs as one
    transposed conv (phase) against the upsample and 3x3 conv (plain), on
    the same weights, in turns (plain, phase, phase, plain; CUDA events,
    median of 20) with each one's peak device memory: the disp forward at
    384x1280, B=8 and B=1, in fp32 (TF32 convolutions) and bf16, and the
    stage-1 step at 192x640, B=8; then the phase model's disparities
    against the plain model's with TF32 off (printed, not bounded)."""
    plain = create_model("B", 49, generator=torch.Generator().manual_seed(seed), device=dev).eval()
    phase = create_model("B", 49, device=dev, phase_deconv=True).eval()
    phase.load_state_dict(plain.state_dict())
    times = {}
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            a, b_ = plain.with_dtype(dtype), phase.with_dtype(dtype)
            for b in (BATCH, 1):
                x = lefts[b]
                got = in_turns({"plain": lambda: a(x, 2.0, 300.0, ret_disp=True),
                                "phase": lambda: b_(x, 2.0, 300.0, ret_disp=True)})
                times[f"phase_fwd_{dtype}_b{b}"] = got
                line(f"phase 5 phase_deconv forward FAL_netB N=49 {SERVE_H}x{SERVE_W} disp B={b} {dtype} (in turns "
                     f"plain, phase, phase, plain): plain {got['plain'][0]:.3f}, {got['plain'][1]:.3f} ms, peak "
                     f"{got['plain'][2]:.2f} GB; phase {got['phase'][0]:.3f}, {got['phase'][1]:.3f} ms, peak "
                     f"{got['phase'][2]:.2f} GB [{card}]")
        with tf32(False):
            d_plain = plain(lefts[BATCH], 2.0, 300.0, ret_disp=True).disp
            d_phase = phase(lefts[BATCH], 2.0, 300.0, ret_disp=True).disp
            diff = (d_phase - d_plain).abs()
    line(f"phase 5 phase_deconv vs plain deconv, FAL_netB N=49 {SERVE_H}x{SERVE_W} B={BATCH} disp, TF32 off, random "
         f"weights: max |d disp| {float(diff.max()):.3e} px, mean {float(diff.mean()):.3e} px")
    del plain, phase, d_plain, d_phase, diff
    steps = {}
    for name, on in (("plain", False), ("phase", True)):
        steps[name] = train_step_fn(*train_setup(dev, seed, phase_deconv=on))
    got = in_turns(steps)
    times["phase_step"] = got
    line(f"phase 5 phase_deconv stage-1 step FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH} (forward, backward, Adam; "
         f"in turns): plain {got['plain'][0]:.3f}, {got['plain'][1]:.3f} ms, peak {got['plain'][2]:.2f} GB; phase "
         f"{got['phase'][0]:.3f}, {got['phase'][1]:.3f} ms, peak {got['phase'][2]:.2f} GB [{card}]")
    return times


def phase_remat(dev, root: str, workdir: str, card: str, seed: int) -> dict:
    """Phase 7g: ``remat`` (train/trainer.py::Remat) on the card: ``cli.train
    --remat`` on phase 7a's tree (K1 twice a step: the forward and the
    recompute; K2 once; the gate once each), then the stage-1 loss at
    192x640, B=8, and the stage-2 loss at B=4 (double batch 8, the teacher
    outside the recompute): with remat (its launches counted) and without
    it, from the same weights and batch with cuDNN's deterministic
    algorithms, the loss and every parameter gradient must be bit-identical
    (the CUDA K1 runs again in the recompute); then each step is timed in
    turns with the step without remat (CUDA events, median of 20) with its
    peak device memory."""
    from fal_net_torch.train.stages import stage2_loss
    from fal_net_torch.train.trainer import Remat

    result, trainer, _, k1, k2, secs = run_cli_train(["--stage", "1", "--remat"], root, workdir)
    (epoch,) = result["history"]
    want = (1 + 2 * TRAIN_STEPS, 1 + TRAIN_STEPS)
    if (k1, k2) != want or not isinstance(trainer.train_model, Remat) or not np.isfinite(epoch["loss"]):
        raise AssertionError(f"cli.train --remat: K1 {k1}, K2 {k2} launches (want {want}), student "
                             f"{type(trainer.train_model).__name__}, loss {epoch['loss']}")
    with open(os.path.join(result["save_path"], "settings.txt")) as f:
        if "remat: True" not in f.read():
            raise AssertionError("cli.train --remat: settings.txt does not say remat: True")
    line(f"phase 7g cli.train --remat FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH}: {TRAIN_STEPS} steps in "
         f"{secs:.2f} s, epoch loss {epoch['loss']:.6f}; K1 {k1} launches (1 in the gate, 2 a step: forward and "
         f"recompute), K2 {k2}; settings.txt remat: True")
    k1_total, k2_total = k1, k2
    del trainer

    times = {}
    model, opt, sched, batch = train_setup(dev, seed)
    s_model, s_opt, s_sched, s_batch = train_setup(dev, seed, batch_size=BATCH // 2)
    teacher = create_model("B", 49, generator=torch.Generator().manual_seed(seed + 1), device=dev)
    teacher.requires_grad_(False).eval()
    stage2 = dict(loss_fn=lambda *a, **k: stage2_loss(a[0], a[1], teacher, a_mr=1.0, **k))
    for label, m, b_, extra, want in (("stage-1 step", model, batch, {}, (2, 1)),
                                      ("stage-2 step", s_model, s_batch, stage2, (3, 1))):
        _build.reset_launch_counts()
        with cudnn_deterministic():
            got = loss_and_grads(Remat(m), m, b_, **extra)
            torch.cuda.synchronize()
            if (MedForward.launches, MedForward.bwd_launches) != want:
                raise AssertionError(f"remat {label}: K1 {MedForward.launches}, K2 {MedForward.bwd_launches} "
                                     f"(want {want})")
            ref = loss_and_grads(m, m, b_, **extra)
        differ = {n: float((g - ref[n]).abs().max()) for n, g in got.items() if not torch.equal(g, ref[n])}
        if differ:
            raise AssertionError(f"remat {label}: {len(differ)} of {len(got)} items not bit-identical to the step "
                                 f"without remat: {dict(list(differ.items())[:6])}")
        line(f"phase 7g {label} with remat vs without, same weights and batch, cuDNN deterministic: the loss and "
             f"{len(got) - 1} parameter gradients bit-identical")
        k1_total, k2_total = k1_total + want[0], k2_total + want[1]
        opt_, sched_ = (opt, sched) if m is model else (s_opt, s_sched)
        got = in_turns({"plain": train_step_fn(m, opt_, sched_, b_, **extra),
                        "remat": train_step_fn(Remat(m), opt_, sched_, b_, **extra)})
        times[label] = got
        b = BATCH if label.startswith("stage-1") else BATCH // 2
        line(f"phase 7g {label} FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={b}{' (double batch 8)' if b < BATCH else ''} "
             f"with remat: K1 {want[0]}, K2 {want[1]} launches; in turns without it (plain, remat, remat, plain): "
             f"plain {got['plain'][0]:.3f}, {got['plain'][1]:.3f} ms, peak {got['plain'][2]:.2f} GB; remat "
             f"{got['remat'][0]:.3f}, {got['remat'][1]:.3f} ms, peak {got['remat'][2]:.2f} GB [{card}]")
    if not all(torch.isfinite(p).all() for m in (model, s_model) for p in m.parameters()):
        raise AssertionError("remat steps left non-finite parameters")
    return {"k1": k1_total, "k2": k2_total, "times": times}


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
EVAL_FRAMES, EVAL_REPEAT, EVAL_SAVED = 8, 3, 2
# the kernel path vs the plain head, same convolutions: disparities within
# 5e-3 px + 1e-4 relative (K1 = plain head within 1e-4 in each of the two
# passes, blended by a percentile of the first), metrics within 1e-3
EVAL_DISP_TOL, EVAL_METRIC_TOL = (1e-4, 5e-3), 1e-3


def write_eigen_tree(rng, root: str) -> dict:
    """The Kitti_eigen_test_improved layout: per frame the stereo pair and
    sparse uint16 groundtruth and velodyne depth PNGs (depth * 256, about 5%
    of the pixels set, as projected lidar); list directories "all" (the 16
    frames), "save" (the first EVAL_SAVED) and "timed" (the 16 listed EVAL_REPEAT
    times)."""
    from PIL import Image

    lines = []
    for drive, (h, w) in EVAL_SHAPES.items():
        for i in range(EVAL_FRAMES):
            frame = f"{i:010d}.png"
            for cam in ("image_02", "image_03"):
                d = os.path.join(root, drive, cam, "data")
                os.makedirs(d, exist_ok=True)
                Image.fromarray(smooth_frame(rng, h, w)).save(os.path.join(d, frame), compress_level=1)
            for kind in ("groundtruth", "velodyne_raw"):
                d = os.path.join(root, drive, "proj_depth", kind, "image_02")
                os.makedirs(d, exist_ok=True)
                depth = (rng.uniform(2, 80, (h, w)) * 256).astype(np.uint16)
                depth[rng.random((h, w)) > 0.05] = 0
                Image.fromarray(depth).save(os.path.join(d, frame), compress_level=1)
            lines.append(f"{drive}/image_02/data/{frame} {drive}/image_03/data/{frame}")
    lists = {}
    for name, lst in (("all", lines), ("save", lines[:EVAL_SAVED]), ("timed", lines * EVAL_REPEAT)):
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
        n = n_all if lst == "all" else EVAL_SAVED
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
               for i in range(EVAL_SAVED) for sub, ext in (("disp", "png"), ("pan", "png"), ("pc", "ply"))):
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
            "root": root, "lists": lists["all"], "save_lists": lists["save"], "ckpt": ckpt, "ms_metrics": ms_metrics,
            "ms_disps": ms_disps, "off_metrics": off_metrics, "off_disps": off_disps}


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
    # the health gate in its own process, started beside the fresh interpreter: both spend most of their
    # time starting up on the host, and the gate's throughput phase comes last
    t0 = time.perf_counter()
    gate = subprocess.Popen([sys.executable, "-m", "fal_net_torch.cli.selfcheck", "--full", "--timeout", "300"],
                            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHILD, json.dumps([child, frames, npz])], cwd=root,
                              capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        gate_out, gate_err = gate.communicate(timeout=900)
        gate_s = time.perf_counter() - t0
    finally:
        if gate.poll() is None:
            gate.kill()
            gate.wait()
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

    for ln in gate_out.strip().splitlines():
        line(f"phase 11 cli.selfcheck --full: {ln.strip()}")
    if gate.returncode != 0:
        raise AssertionError(f"cli.selfcheck --full exited {gate.returncode}:\n{gate_err[-4000:]}")
    line(f"phase 11 cli.selfcheck --full (beside the fresh interpreter) exit 0 in {gate_s:.2f} s")
    return {"k1": sum(report["k1"].values()) + sum(k1_infer.values()) + sum(by_mode.values())}


def peak_gb(fn) -> float:
    """Peak device memory of one call of ``fn``, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def in_turns(fns: dict, reps: int = 20) -> dict:
    """Median ms of each callable in turns (a, b, ..., ..., b, a; medians
    of ``reps``) and each one's peak device memory: {name: (ms, ms, GB)}."""
    ms = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):
        ms[k].append(median_ms(fns[k], reps=reps))
    return {k: (*ms[k], peak_gb(f)) for k, f in fns.items()}


def logits_conv_vs_plain(rng, dev, card: str) -> dict:
    """Phase 12: L1 against its plain version at L1_SHAPES (TF32 off for the
    plain version, so that only the order of the fp32 sums differs), then
    timed in turns (kernel, plain, cuDNN bf16, and back; medians of 20):
    the plain version with TF32 on, as the port ran the logits conv before
    L1 (an fp32 copy of the input, then cuDNN), and cuDNN's bf16 conv with
    a bf16 output, the nearest library call (not the same function).
    Returns the kernels line's numbers at the serving shape."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))  # inputs drawn on the card
    worst, serving = 0.0, None
    for shape, cout, pad_h in L1_SHAPES:
        b, cin, h, w = shape
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        x = pitched_empty(shape, x).copy_(x)  # on the 16-byte row pitch, as the model builds its concat
        k = (torch.randn((cout, cin, 3, 3), device=dev, generator=gen) / np.sqrt(9 * cin)).to(torch.bfloat16)
        bias = torch.randn(cout, device=dev, generator=gen)
        got = logits_conv(x, k, bias, pad_h)
        torch.cuda.synchronize()
        with tf32(False):
            want = logits_conv_plain(x, k, bias, pad_h)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if got.dtype != torch.float32 or got.shape != want.shape or not torch.allclose(
                got, want, rtol=L1_TOL, atol=L1_TOL * scale):
            raise AssertionError(f"L1 {shape} -> {cout} pad_h {pad_h}: {got.dtype} {tuple(got.shape)}, max abs err "
                                 f"{err:.3e} (rtol {L1_TOL}, atol {L1_TOL} x {scale:.3e})")
        worst = max(worst, err)
        del got, want
        lib_bias = bias.to(torch.bfloat16)
        fns = {"kernel": lambda: logits_conv(x, k, bias, pad_h), "plain": lambda: logits_conv_plain(x, k, bias, pad_h),
               "cudnn_bf16": lambda: torch.nn.functional.conv2d(x, k, lib_bias, 1, (pad_h, 1))}
        ms = {name: [] for name in fns}
        for name in (*fns, *reversed(fns)):
            ms[name].append(median_ms(fns[name], reps=20))
        out_shape = (b, cout, h - 2 + 2 * pad_h, w)
        nbytes_ = nbytes(x, k, bias) + int(np.prod(out_shape)) * 4
        b_ms, b_by = bound(nbytes_, 2.0 * np.prod(out_shape) * 9 * cin, BF16_FLOPS)
        line(f"phase 12 L1 logits_conv {shape} -> {cout}, pad_h {pad_h}: max abs err {err:.3e} (max|plain| "
             f"{scale:.3e}); kernel {ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
             f"({nbytes_ / 1e6:.1f} MB, {2.0 * np.prod(out_shape) * 9 * cin / 1e9:.1f} GFLOP); plain (fp32 copy + "
             f"cuDNN, TF32) {ms['plain'][0]:.4f}, {ms['plain'][1]:.4f} ms; cuDNN bf16 conv2d, bf16 out (the nearest "
             f"library call, not the same function) {ms['cudnn_bf16'][0]:.4f}, {ms['cudnn_bf16'][1]:.4f} ms [{card}]")
        if serving is None:
            serving = {"ms": float(np.mean(ms["kernel"])), "plain_ms": float(np.mean(ms["plain"])),
                       "library_ms": float(np.mean(ms["cudnn_bf16"])), "bound_ms": b_ms, "bound_by": b_by}
        del x, k, bias
    torch.cuda.empty_cache()
    return {**serving, "max_abs_err": worst}


def phase_bf16_train(root: str, workdir: str) -> dict:
    """Phase 12a: cli.train --dtype bfloat16 on phase 7a's tree, TRAIN_STEPS steps;
    the checkpoint's parameters and Adam's state stay fp32."""
    result, trainer, _, k1, k2, secs = run_cli_train(["--stage", "1", "--dtype", "bfloat16"], root, workdir)
    l1 = L1_LAUNCHES["logits_conv"]  # one a step's forward: the gate runs K1 and K2 alone
    (epoch,) = result["history"]
    data = torch.load(os.path.join(result["save_path"], "checkpoint.pt"), map_location="cpu", weights_only=True)
    dtypes = {v.dtype for v in data["state_dict"].values()}
    dtypes |= {t.dtype for st in data["optimizer"]["state"].values() for t in st.values()
               if torch.is_tensor(t) and t.ndim}
    if (k1, k2, l1) != (TRAIN_STEPS + 1, TRAIN_STEPS + 1, TRAIN_STEPS) or trainer.model.dtype != torch.bfloat16 or \
            dtypes != {torch.float32}:
        raise AssertionError(f"cli.train --dtype bfloat16: K1 {k1}, K2 {k2}, L1 {l1} launches, model "
                             f"{trainer.model.dtype}, checkpoint dtypes {dtypes}")
    line(f"phase 12 cli.train --dtype bfloat16 FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH}: {TRAIN_STEPS} steps in "
         f"{secs:.2f} s, epoch loss {epoch['loss']:.6f} rec {epoch['rec_loss']:.6f}; K1 {k1}, K2 {k2}, L1 {l1} "
         f"launches; checkpoint parameters and Adam state fp32")
    return {"k1": k1, "k2": k2, "l1": l1}


def phase_bf16(rng, dev, card: str, seed: int, serve_dir: str, evaluation: dict, workdir: str) -> dict:
    """Phase 12: bf16 compute on the card (see the module docstring)."""
    from fal_net_torch.cli import export as cli_export
    from fal_net_torch.cli import test as cli_test
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.serve import load_exported
    from fal_net_torch.train.stages import stage2_loss

    l1_kernel = logits_conv_vs_plain(rng, dev, card)
    k1_total = k2_total = l1_total = 0
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
    k1, l1 = MedForward.launches, L1_LAUNCHES["logits_conv"]
    if (k1, l1) != (4, 2) or not all(torch.isfinite(t).all() for t in out) or out.disp.dtype != torch.float32:
        raise AssertionError(f"bf16 forward: K1 {k1}, L1 {l1} launches, outputs {[t.dtype for t in out]}")
    k1_total, l1_total = k1_total + k1, l1_total + l1
    line(f"phase 12 K1 in the bf16 FAL_netB N=49 {SERVE_H}x{SERVE_W} B={BATCH}: fp32 logits, K1 = plain head in every "
         f"mode (phase 3's tolerances), worst abs err {worst:.3e}; {k1} K1 launches, {l1} L1 launches (the logits "
         f"and the forward)")

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
    peaks = {k: v[2] for k, v in times[f"fwd_b{BATCH}"].items()}
    if not peaks["bf16"] < peaks["fp32"]:
        raise AssertionError(f"bf16 forward B={BATCH} peaks at {peaks['bf16']:.3f} GB, not below fp32's "
                             f"{peaks['fp32']:.3f} GB")
    del model32, model16, x8

    # the stage-1 step at B=8 (192x640), fp32 and bf16 in turns; then one bf16 stage-2 step
    tmodel, opt, sched, batch = train_setup(dev, seed)
    t16 = tmodel.with_dtype("bfloat16")
    _build.reset_launch_counts()
    train_step_fn(t16, opt, sched, batch)()
    torch.cuda.synchronize()
    if (MedForward.launches, MedForward.bwd_launches, L1_LAUNCHES["logits_conv"]) != (1, 1, 1):
        raise AssertionError(f"bf16 stage-1 step: K1 {MedForward.launches}, K2 {MedForward.bwd_launches}, L1 "
                             f"{L1_LAUNCHES['logits_conv']}")
    k1_total, k2_total, l1_total = k1_total + 1, k2_total + 1, l1_total + 1
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
    if (MedForward.launches, MedForward.bwd_launches, L1_LAUNCHES["logits_conv"]) != (2, 1, 2):
        raise AssertionError(f"bf16 stage-2 step: K1 {MedForward.launches}, K2 {MedForward.bwd_launches}, L1 "
                             f"{L1_LAUNCHES['logits_conv']} (the teacher's and the student's forward)")
    k1_total, k2_total, l1_total = k1_total + 2, k2_total + 1, l1_total + 2
    with torch.no_grad():
        loss, _ = stage2_loss(s_model.with_dtype("bfloat16"), s_batch, teacher, min_disp=2.0, max_disp=300.0, a_p=0.0,
                              a_sm=0.4 * 2 / 512, a_mr=1.0)
    got = in_turns(step2, reps=10)
    times["step2"] = got
    line(f"phase 12 stage-2 step, bf16 student and teacher FAL_netB N=49 {TRAIN_H}x{TRAIN_W} B={BATCH // 2} (double "
         f"batch {BATCH}): K1 2, K2 1, L1 2 launches, loss {loss.item():.6f}; in turns with the fp32 student (the teacher "
         f"bf16 in both): fp32 {got['fp32'][0]:.3f}, {got['fp32'][1]:.3f} ms, bf16 {got['bf16'][0]:.3f}, "
         f"{got['bf16'][1]:.3f} ms, peak {got['bf16'][2]:.2f} GB [{card}]")
    if not np.isfinite(loss.item()):
        raise AssertionError("bf16 stage-2 loss is not finite")
    del s_model, s_opt, s_sched, s_batch, teacher

    # cli.test --dtype bfloat16 on phase 10's tree
    metrics, (ev,), disps, by_mode, secs = recorded_eval(lambda: cli_test.main([
        "--data_root", evaluation["root"], "--lists_dir", evaluation["lists"], "--pretrained", evaluation["ckpt"],
        "--batch_size", str(BATCH), "--dtype", "bfloat16", "--save_path", os.path.join(workdir, "eval_bf16")]))
    l1 = L1_LAUNCHES["logits_conv"]
    check_eval_outputs(os.path.join(workdir, "eval_bf16"), metrics, "bf16")
    n_all = EVAL_FRAMES * len(EVAL_SHAPES)
    want_k1 = {"disp": 2 * (n_all // BATCH) + 2 * len(EVAL_SHAPES)}
    if by_mode != want_k1 or l1 != 2 * (n_all // BATCH) or len(disps) != n_all or ev.model.dtype != torch.bfloat16:
        raise AssertionError(f"cli.test --dtype bfloat16: K1 {by_mode} (want {want_k1}), L1 {l1} (want "
                             f"{2 * (n_all // BATCH)}: two forwards a batch), {len(disps)} images")
    k1_total, l1_total = k1_total + sum(by_mode.values()), l1_total + l1
    d_err = max(float(np.abs(disps[i] - evaluation["ms_disps"][i]).max()) for i in disps)
    line(f"phase 12 cli.test --dtype bfloat16 (ms-pp, {n_all} images, B={BATCH}) in {secs:.2f} s: K1 {by_mode}, L1 {l1}; "
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
        k1_art, l1_art = MedForward.mode_launches, L1_LAUNCHES["logits_conv"]
        want = live(x, 2.0, 300.0, ret_disp=True).disp.permute(0, 2, 3, 1)
    err = float((got - want).abs().max())
    rtol, atol = EVAL_DISP_TOL
    if fwd.meta["dtype"] != "bfloat16" or k1_art != {"disp": 1} or l1_art != 1 or not torch.allclose(
            got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"bf16 artifact: dtype {fwd.meta['dtype']}, K1 {k1_art}, L1 {l1_art}, max abs err "
                             f"{err:.3e}")
    k1_total, l1_total = k1_total + 1, l1_total + 1
    with torch.inference_mode():
        xa = x.permute(0, 2, 3, 1).contiguous()
        got_t = in_turns({"live": lambda: live(x, 2.0, 300.0, ret_disp=True), "artifact": lambda: fwd(xa)})
    line(f"phase 12 cli.export --dtype bfloat16 {SERVE_H}x{SERVE_W} disp B={BATCH} in {export_s:.2f} s, "
         f"{size / 1e6:.1f} MB, meta dtype {fwd.meta['dtype']}; K1 inside it {k1_art}, L1 {l1_art}; vs the live bf16 model max abs "
         f"err {err:.3e} px; forward in turns: live {got_t['live'][0]:.3f}, {got_t['live'][1]:.3f} ms, artifact "
         f"{got_t['artifact'][0]:.3f}, {got_t['artifact'][1]:.3f} ms [{card}]")
    return {"k1": k1_total, "k2": k2_total, "l1": l1_total, "l1_kernel": l1_kernel, "worst": worst, "times": times}


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
             f"K1 per rank {rep['k1']}, K2 per rank {rep['k2']}; step after it (median of 5, TF32 on, host "
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


# phase 14: FAL_netB N=49 on two gloo ranks on cuda:0 that split each image's rows
SPATIAL_TIMED = 5  # forwards and steps timed after the compared one, per rank and in one process


def spatial_rank(rank: int, world: int, calls) -> list:
    """One of phase 14's ranks (spawned, in a process group): each call of
    ``calls`` (parallel/dryrun.py's rank_forward and rank_step: the compared
    forward or step with TF32 off, the timed ones in the port's settings)
    and the distinct (mode, logits shape) of the K1 launches it made."""
    from fal_net_torch.parallel.dryrun import rank_calls

    out = []
    for call in calls:
        with k1_by_shape() as shapes:
            (res,) = rank_calls(rank, world, [call])
        out.append({**res, "k1_shapes": sorted(set(shapes))})
    return out


def phase_spatial(dev, card: str, workdir: str) -> dict:
    """Phase 14: row (spatial) partitioning (see the module docstring)."""
    import gc

    from fal_net_torch.data.loader import DataLoader
    from fal_net_torch.parallel import ddp
    from fal_net_torch.parallel.dryrun import (ORDER_ONLY, STAGE2_ORDER, SyntheticStereo, rank_forward, rank_step,
                                               step_units)
    from fal_net_torch.parallel.spatial import RowShard
    from fal_net_torch.train.config import Stage1Config, Stage2Config

    seed = 0
    images = np.random.default_rng(seed).standard_normal((BATCH, SERVE_H, SERVE_W, 3)).astype(np.float32) * 0.3
    model_kw = dict(variant="B", num_levels=49)
    teacher = os.path.join(workdir, "spatial_teacher.pt")
    save_checkpoint(teacher, create_model("B", 49, device=dev, generator=torch.Generator().manual_seed(1)))
    common = dict(model="B", num_levels=49, crop_size=(TRAIN_H, TRAIN_W), a_p=0.0, workers=2, seed=seed)
    steps = {"stage1": Stage1Config(batch_size=BATCH, **common),
             "stage2": Stage2Config(batch_size=BATCH // 2, a_mr=1.0, fix_model=teacher, **common)}
    data = {k: SyntheticStereo(cfg.batch_size, TRAIN_H, TRAIN_W, seed) for k, cfg in steps.items()}
    whole = {}
    for k, cfg in steps.items():
        with contextlib.closing(iter(DataLoader(data[k], batch_size=cfg.batch_size, seed=seed, num_workers=2))) as it:
            whole[k] = next(it)
    fwd_args = (dev, images, 2.0, 300.0, model_kw)
    calls = [(rank_forward, (2, str(dev), *fwd_args[1:]), dict(timed=SPATIAL_TIMED, ret_pan=True))]
    calls += [(rank_step, (cfg, k, str(dev), data[k], SPATIAL_TIMED), dict(spatial=2)) for k, cfg in steps.items()]
    one = spatial_rank(0, 1, [(rank_forward, (1, dev, *fwd_args[1:]), dict(timed=SPATIAL_TIMED, ret_pan=True))]
                       + [(rank_step, (cfg, k, dev, data[k], SPATIAL_TIMED, whole[k]), {}) for k, cfg in steps.items()])
    # fp32 summation order alone: the same one-process step as two microbatches of half the batch
    order = {k: step_units(rank_step(0, 1, dataclasses.replace(cfg, grad_accum=2), k, dev, data[k], batch=whole[k]),
                           one[i]) for i, (k, cfg) in enumerate(steps.items(), start=1)}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this card
    t0 = time.perf_counter()
    ranks = ddp.launch(spatial_rank, 2, (calls,), store_path=os.path.join(workdir, "spatial_store"), backend="gloo",
                       device=str(dev), timeout=300, join_timeout=600)
    secs = time.perf_counter() - t0
    rows = RowShard(2, 0)
    for h in (SERVE_H, TRAIN_H):
        line(f"phase 14 levels at {h} rows over 2 ranks: {rows.describe(h)}")

    # the forward: each rank's rows against the one-process forward's, TF32 off in both
    rtol, atol = EVAL_DISP_TOL
    errs = {}
    for r in ranks:
        lo, hi = rows.bounds(SERVE_H, r[0]["s"])
        for k in ("disp", "pan"):
            got, want = r[0]["outputs"][k], one[0]["outputs"][k][:, :, lo:hi]
            errs[k] = max(errs.get(k, 0.0), float(np.abs(got - want).max()))
            if not np.allclose(got, want, rtol=rtol, atol=atol):
                raise AssertionError(f"phase 14 rank {r[0]['s']} {k} rows {lo}:{hi}: max |diff| "
                                     f"{float(np.abs(got - want).max()):.3e} past {atol} px + {rtol} relative")
    want_fwd = [("disp+pan", (BATCH, 49, SERVE_H // 2, SERVE_W))]
    if any(r[0]["k1"] != 1 or r[0]["k1_shapes"] != want_fwd for r in ranks):
        raise AssertionError(f"phase 14 forward: K1 {[(r[0]['k1'], r[0]['k1_shapes']) for r in ranks]}, want 1 at "
                             f"{want_fwd} a rank")
    line(f"phase 14 spatial forward FAL_netB N=49 {SERVE_H}x{SERVE_W} B={BATCH} disp+pan, two gloo ranks on cuda:0, "
         f"TF32 off: each rank's rows against the one-process forward max |d disp| {errs['disp']:.3e} px, "
         f"|d pan| {errs['pan']:.3e} (limit {atol} + {rtol} relative); K1 per rank "
         f"{[r[0]['k1'] for r in ranks]} at {ranks[0][0]['k1_shapes']}; per rank "
         f"{[round(r[0]['ms'], 3) for r in ranks]} ms (median of {SPATIAL_TIMED}, TF32 on, host clock to a device "
         f"synchronise) and {[round(r[0]['peak_gb'], 3) for r in ranks]} GB peak, one process {one[0]['ms']:.3f} ms "
         f"and {one[0]['peak_gb']:.3f} GB [{card}]")

    k1_total = sum(r[0]["k1"] for r in ranks)
    k2_total = 0
    local = (BATCH, 49, TRAIN_H // 2, TRAIN_W)
    for i, (k, cfg) in enumerate(steps.items(), start=1):
        got = ranks[0][i]
        units = step_units(got, one[i])
        worst, noise = max(units.values()), max(order[k].values())
        limit = STAGE2_ORDER if k == "stage2" else ORDER_ONLY
        top = lambda u: {n: round(v, 1) for n, v in sorted(u.items(), key=lambda kv: -kv[1])[:3]}
        local_k = (2 * cfg.batch_size,) + local[1:] if k == "stage2" else local
        want_k1 = ({("disp", local_k), ("disp+pan+subocc", local_k)} if k == "stage2" else {("disp+pan", local_k)})
        counts = [(r[i]["k1"], r[i]["k2"]) for r in ranks]
        if counts != [(len(want_k1), 1)] * 2 or not all(want_k1 <= set(r[i]["k1_shapes"]) for r in ranks):
            raise AssertionError(f"phase 14 {k}: K1, K2 per rank {counts}; K1 shapes "
                                 f"{[r[i]['k1_shapes'] for r in ranks]} (want {sorted(want_k1)})")
        k1_total += sum(c[0] for c in counts)
        k2_total += sum(c[1] for c in counts)
        line(f"phase 14 spatial {k} step FAL_netB N=49 {TRAIN_H}x{TRAIN_W} batch {cfg.batch_size}"
             f"{' (double batch ' + str(2 * cfg.batch_size) + ')' if k == 'stage2' else ''}, rows over two gloo ranks "
             f"on cuda:0, TF32 off, cuDNN deterministic: loss per rank {[round(r[i]['aux']['loss'], 6) for r in ranks]}"
             f" vs one process {one[i]['aux']['loss']:.6f}; gradients and Adam moments against the one-process "
             f"step: worst {worst:.3f} of the tolerance rtol 1e-4, atol 1e-6 max|g| (the worst three {top(units)}; "
             f"limit {limit}; the one-process step as two microbatches against it, summation order alone: "
             f"{noise:.3f}, {top(order[k])}); K1, K2 "
             f"per rank {counts}, K1 at {sorted(want_k1)}; step per rank {[round(r[i]['step_ms'], 3) for r in ranks]}"
             f" ms (median of {SPATIAL_TIMED}, TF32 on, host clock to a device synchronise), one process "
             f"{one[i]['step_ms']:.3f} ms; peak per rank {[round(r[i]['peak_gb'], 3) for r in ranks]} GB, one process "
             f"{one[i]['peak_gb']:.3f} GB [{card}]")
        if worst > limit:
            raise AssertionError(f"phase 14 {k}: {worst:.3f} units against the one-process step (limit {limit:.3f})")
    line(f"phase 14: the two ranks' group ran {secs:.1f} s (spawn, model and trainer set-up, the gates, the compared "
         f"and timed forwards and steps)")
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


def phase_quickstart() -> dict:
    """Phase 15: the port's quickstart on the card, then the console scripts
    (see the module docstring).  Returns K1's and K2's launches on the
    quickstart's path, the gate's apart."""
    import importlib.metadata
    import importlib.util
    import io
    import tomllib

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "quickstart_synthetic_torch", os.path.join(here, "examples", "quickstart_synthetic_torch.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    cwd, t0 = os.getcwd(), time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        os.chdir(workdir)  # the example writes runs/quickstart under the working directory
        try:
            _build.reset_launch_counts()
            result = quickstart.main(["--device", "cuda"])
            torch.cuda.synchronize()
            k1, k2 = MedForward.launches, MedForward.bwd_launches
        finally:
            os.chdir(cwd)
    secs = time.perf_counter() - t0
    steps = 2 * (len(quickstart.SyntheticStereo()) // 8)  # 2 epochs of batch 8
    # the gate once each, every step once each, the ms-pp forwards (disp, then the flipped 2/3 pass) K1 twice
    if (k1, k2) != (1 + steps + 2, 1 + steps):
        raise AssertionError(f"phase 15 quickstart: K1 {k1}, K2 {k2} launches; want {1 + steps + 2} and {1 + steps}")
    losses = [(h["loss"], h["rec_loss"]) for h in result["history"]]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"phase 15 quickstart: history {result['history']}")
    d = result["disparity"]
    lo, hi = float(d.min()), float(d.max())
    if tuple(d.shape) != (1, 1, 64, 128) or not torch.isfinite(d).all() or not 2.0 <= lo <= hi <= 24.0:
        raise AssertionError(f"phase 15 quickstart: disparity {tuple(d.shape)} in [{lo}, {hi}]")
    line(f"phase 15 quickstart (tiny, N=9, 64x128, B=8, {steps} stage-1 steps, then ms-pp) in {secs:.2f} s: epoch "
         f"(loss, rec_loss) {losses}; disparity median {float(d.median()):.4f} px, range [{lo:.4f}, {hi:.4f}] "
         f"(ground truth {quickstart.SyntheticStereo.DISP}); K1 {k1} (gate 1, steps {steps}, ms-pp 2), K2 {k2} "
         f"(gate 1, steps {steps})")

    with open(os.path.join(here, "pyproject.toml"), "rb") as f:
        scripts = {k: v for k, v in tomllib.load(f)["project"]["scripts"].items() if k.startswith("falnet-torch-")}
    want = {f"falnet-torch-{c}" for c in ("train", "test", "export", "infer", "convert", "selfcheck")}
    if set(scripts) != want:
        raise AssertionError(f"phase 15 console scripts: {sorted(scripts)}, want {sorted(want)}")
    for name, value in sorted(scripts.items()):
        entry = importlib.metadata.EntryPoint(name, value, "console_scripts").load()
        code = "no exit"
        with contextlib.redirect_stdout(io.StringIO()) as out:
            try:
                entry(["--help"])
            except SystemExit as e:
                code = e.code
        if code != 0 or "usage:" not in out.getvalue():
            raise AssertionError(f"phase 15 {name} = {value}: --help gave {code!r}")
    line(f"phase 15 console scripts: {', '.join(f'{k} = {v}' for k, v in sorted(scripts.items()))}: each imports "
         f"and --help exits 0")
    return {"k1": k1 - 1, "k2": k2 - 1}


# phase 16: K1 and K2 at FAL_netA and C's plane count, at the serving, stage-1 and evaluation shapes (the last
# at W = 1242: cp.async copies), (B, N, H, W, C, min_disp, max_disp)
VARIANT_SHAPES = [(8, 33, SERVE_H, SERVE_W, 3, 2.0, 300.0), (8, 33, TRAIN_H, TRAIN_W, 3, 2.0, 300.0),
                  (8, 33, KITTI_H, KITTI_W, 3, 2.0, 300.0)]
VARIANT_LEVELS = 33  # FAL_netA's and FAL_netC's default (models/backbone.py)


def med_times_n33(rng, dev, card: str) -> None:
    """K1 (disp, disp+pan, disp+pan+subocc) and K2 (the training step's
    disp+pan cotangents) at VARIANT_SHAPES beside their plain versions and
    their bytes bounds (CUDA events; kernels median of 20, plain versions of
    5), printed."""
    for b, n, h, w, c, mn, mx in VARIANT_SHAPES:
        draw = lambda ch: torch.from_numpy(rng.standard_normal((b, ch, h, w), np.float32)).to(dev)
        logits, image, gd, gp = draw(n), draw(c), draw(1), draw(c)
        shape = (b, n, h, w)
        for mode in ("disp", "disp+pan", "disp+pan+subocc"):
            kw = MODES[mode]
            k = median_ms(lambda: med_outputs_fused(logits, image, mn, mx, **kw))
            p = median_ms(lambda: med_outputs(logits, image, mn, mx, **kw), reps=5)
            out = med_outputs_fused(logits, image, mn, mx, **kw)
            need = nbytes(logits, image if "pan" in mode else None, *out)
            b_ms = need / HBM_BYTES_PER_S * 1e3
            plan = plan_words("med_fwd", n, c, w, pan="pan" in mode, subocc="subocc" in mode)
            line(f"phase 16 K1 {shape} {mode}: kernel {k:.4f} ms, plain {p:.4f} ms, bound {b_ms:.4f} ms from "
                 f"{need / 1e6:.1f} MB (bytes) [{plan}] [{card}]")
            del out
        k = median_ms(lambda: med_vjp_fused(logits, image, mn, mx, gd, gp, image_grad=False))
        p = median_ms(lambda: med_vjp(logits, image, mn, mx, gd, gp, image_grad=False), reps=5)
        # inputs once and g_logits (the logits' size) written once
        b_ms, b_by = bound(nbytes(logits, image, gd, gp, logits), OPS_PER_LOGIT["med_bwd"] * logits.numel())
        line(f"phase 16 K2 {shape} disp+pan: kernel {k:.4f} ms, plain VJP {p:.4f} ms, bound {b_ms:.4f} ms by "
             f"{b_by} [{plan_words('med_bwd', n, c, w, pan=True)}] [{card}]")
        del logits, image, gd, gp
    torch.cuda.empty_cache()


def phase_variants(rng, dev, card: str, seed: int, evaluation: dict, workdir: str) -> dict:
    """Phase 16: FAL_netA and FAL_netC on the card (see the module
    docstring).  ``evaluation`` is phase 10's record (its Eigen tree); the
    KITTI-raw training tree and two frames are written anew in ``workdir``.
    Returns the launches of the phase's main paths (K1, K2, L1; the
    comparisons' and the gates' apart) and its worst errors."""
    from PIL import Image

    from fal_net_torch.cli import test as cli_test
    from fal_net_torch.models.checkpoint import load_checkpoint
    from fal_net_torch.scripts import verify_variants

    k1 = k2 = l1 = 0
    worst_k1 = 0.0
    # (a) the counterpart of scripts/verify_variants_tpu.py, each variant at its default N
    for v in verify_variants.VARIANTS:
        line(f"phase 16 verify_variants FAL_net{v} [{card}]")
        _build.reset_launch_counts()
        res = verify_variants.check_variant(v)
        torch.cuda.synchronize()
        k1 += MedForward.launches
        med = verify_variants.check_med_numerics(res["num_levels"])
        worst_k1 = max(worst_k1, *med["errs"].values())
        conv = verify_variants.check_training(v)
        k1, k2 = k1 + conv["launches"][0], k2 + conv["launches"][1]
        if not (res["ok"] and med["ok"] and conv["ok"]) or res["num_levels"] != VARIANT_LEVELS:
            raise AssertionError(f"verify_variants FAL_net{v}: forward {res['ok']} (N={res['num_levels']}), K1 "
                                 f"numerics {med['ok']}, convergence {conv['ok']}")
        quirk = res.get("quirk")
        line(f"phase 16 FAL_net{v} N={res['num_levels']}: forward {SERVE_H}x{SERVE_W} disp+pan B=1 "
             f"{res['ms'][1]:.3f} ms, B={BATCH} {res['ms'][BATCH]:.3f} ms ({1000 * BATCH / res['ms'][BATCH]:.2f} "
             f"imgs/s); K1 numerics at (1, {res['num_levels']}, {SERVE_H}, {SERVE_W}) max errs {med['errs']}; "
             f"convergence {conv['first']:.6f} -> {conv['last']:.6f}, median disparity {conv['median']:.4f} px (half "
             f"spacing {conv['spacing'] / 2:.4f}) in {conv['seconds']:.2f} s, K1 {conv['launches'][0]}, K2 "
             f"{conv['launches'][1]}" + ("" if quirk is None else
             f"; a_maskr_quirk: maskR max |d| {quirk['mask_diff']:.4f}, disp, pan, maskL bit-identical; B={BATCH} "
             f"disp+pan+subocc default {quirk['default'][0]:.3f} ms, peak {quirk['default'][1]:.2f} GB, quirk "
             f"{quirk['quirk'][0]:.3f} ms, peak {quirk['quirk'][1]:.2f} GB") + f" [{card}]")

    # (b) K1 and K2 at N = 33: the serving, stage-1 and evaluation shapes, every mode, each plan printed
    worst_k1 = max(worst_k1, k1_vs_plain(rng, dev, VARIANT_SHAPES))
    worst_k2 = k2_vs_plain(rng, dev, VARIANT_SHAPES)
    line(f"phase 16 K1 and K2 at N = {VARIANT_LEVELS}: {len(VARIANT_SHAPES)} shapes, K1 x {len(MODES)} modes, worst "
         f"abs err {worst_k1:.3e}; K2 x {len(GRAD_MODES) + 1} modes, worst abs err {worst_k2:.3e}")
    med_times_n33(rng, dev, card)

    # (c) one stage-1 step per variant on K1 and K2 (K2 against the plain VJP on the model's own logits), then
    # the steps timed in turns with FAL_netB's, with peak memory
    steps = {"FAL_netB": train_step_fn(*train_setup(dev, seed))}
    for v in verify_variants.VARIANTS:
        model, opt, sched, batch = train_setup(dev, seed, variant=v, levels=VARIANT_LEVELS)
        step = train_step_fn(model, opt, sched, batch)
        _build.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        if (MedForward.launches, MedForward.bwd_launches) != (1, 1):
            raise AssertionError(f"FAL_net{v} stage-1 step: K1 {MedForward.launches}, K2 {MedForward.bwd_launches}")
        k1, k2 = k1 + 1, k2 + 1
        with torch.no_grad():
            logits = model.logits(batch["left"], 300.0)
        worst_k2 = max(worst_k2, k2_on_logits(logits, batch, 2.0, 300.0, 0.2 * 2 / 512,
                                              f"FAL_net{v} model logits {tuple(logits.shape)} stage-1 cotangents"))
        del logits
        steps[f"FAL_net{v}"] = step
    got = in_turns(steps, reps=10)
    line(f"phase 16 stage-1 step {TRAIN_H}x{TRAIN_W} B={BATCH} (forward, backward, Adam; in turns "
         f"{', '.join([*steps, *reversed(steps)])}), FAL_netA and C at N={VARIANT_LEVELS}, FAL_netB at 49: "
         + "; ".join(f"{k} {a:.3f}, {b:.3f} ms, peak {gb:.2f} GB" for k, (a, b, gb) in got.items()) + f" [{card}]")
    del steps, model, opt, sched, batch, step

    # (d) bf16: the forward launches L1 (33 output channels); K1 inside it = the plain head on its fp32 logits
    frames = np.stack([normalize(synthetic_image(rng)) for _ in range(BATCH)]).transpose(0, 3, 1, 2).copy()
    x8 = torch.from_numpy(frames).to(dev)
    for v in verify_variants.VARIANTS:
        model32 = create_model(v, generator=torch.Generator().manual_seed(seed), device=dev).eval()
        model16 = model32.with_dtype("bfloat16")
        with torch.inference_mode():
            logits = model16.logits(x8, 300.0)
            if logits.dtype != torch.float32:
                raise AssertionError(f"bf16 FAL_net{v}'s logits are {logits.dtype}")
            for mode in ("disp", "disp+pan", "disp+pan+subocc"):
                got = med_outputs_fused(logits, x8, 2.0, 300.0, **MODES[mode])
                want = med_outputs(logits, x8, 2.0, 300.0, **MODES[mode])
                worst_k1 = max(worst_k1, compare(got, want, f"bf16 FAL_net{v} logits B={BATCH} {mode}"))
            del logits, got, want
            _build.reset_launch_counts()
            out = model16(x8, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
            torch.cuda.synchronize()
            launched = (MedForward.launches, L1_LAUNCHES["logits_conv"])
            if launched != (1, 1) or not all(torch.isfinite(t).all() for t in out):
                raise AssertionError(f"bf16 FAL_net{v} forward: K1, L1 launches {launched}, outputs finite "
                                     f"{[bool(torch.isfinite(t).all()) for t in out]}")
            k1, l1 = k1 + 1, l1 + 1
            del out
            got = in_turns({"fp32": lambda: model32(x8, 2.0, 300.0, ret_disp=True),
                            "bf16": lambda: model16(x8, 2.0, 300.0, ret_disp=True)}, reps=10)
        line(f"phase 16 bf16 FAL_net{v} N={VARIANT_LEVELS} {SERVE_H}x{SERVE_W} B={BATCH}: K1 = plain head on its fp32 "
             f"logits in every mode; the disp+pan+subocc forward K1 1, L1 1 launches, finite; disp forward in turns "
             f"fp32 {got['fp32'][0]:.3f}, {got['fp32'][1]:.3f} ms, peak {got['fp32'][2]:.2f} GB; bf16 "
             f"{got['bf16'][0]:.3f}, {got['bf16'][1]:.3f} ms, peak {got['bf16'][2]:.2f} GB [{card}]")
        del model32, model16
    del x8

    # (e) the entry points: cli.train --model A|C on a KITTI-raw tree as phase 7a's, cli.infer on each
    # checkpoint with the variant read from it, cli.test --maskr_quirk on A's with two of phase 10's frames
    root, frames = os.path.join(workdir, "kitti"), os.path.join(workdir, "frames")
    write_kitti_tree(rng, root)
    os.makedirs(frames)
    for i in range(2):
        Image.fromarray(smooth_frame(rng, KITTI_H, KITTI_W)).save(os.path.join(frames, f"f{i}.png"), compress_level=1)
    ckpts = {}
    for v in verify_variants.VARIANTS:
        result, trainer, _, k1_t, k2_t, secs = run_cli_train(["--stage", "1"], root, workdir, model=v,
                                                             levels=VARIANT_LEVELS)
        (epoch,) = result["history"]
        if (trainer.model.spec.name, trainer.model.num_levels, k1_t, k2_t) != (v, VARIANT_LEVELS, TRAIN_STEPS + 1,
                                                                               TRAIN_STEPS + 1):
            raise AssertionError(f"cli.train --model {v}: {trainer.model.spec.name} N={trainer.model.num_levels}, K1 "
                                 f"{k1_t}, K2 {k2_t} launches (want {TRAIN_STEPS} + 1 each)")
        del trainer
        k1, k2 = k1 + k1_t - 1, k2 + k2_t - 1  # the setup gate's comparison apart
        ckpts[v] = ckpt = os.path.join(result["save_path"], "checkpoint.pt")
        loaded = load_checkpoint(ckpt, device=dev)
        if (loaded.spec.name, loaded.num_levels) != (v, VARIANT_LEVELS):
            raise AssertionError(f"{ckpt} loads as FAL_net{loaded.spec.name} N={loaded.num_levels}")
        del loaded
        out_dir = os.path.join(workdir, f"infer_{v}")
        with k1_by_shape() as shapes:
            _build.reset_launch_counts()
            written = infer.main(["--pretrained", ckpt, "--images", frames, "--out_dir", out_dir,
                                  "--batch_size", "2"])
            torch.cuda.synchronize()
        disp = np.stack([np.asarray(Image.open(os.path.join(out_dir, f"f{i}_disp.png"))) for i in range(2)]) / 256
        if written != 2 or MedForward.launches != 1 or [s[1] for _, s in shapes] != [VARIANT_LEVELS] or \
                disp.shape != (2, KITTI_H, KITTI_W) or not np.isfinite(disp).all():
            raise AssertionError(f"cli.infer on FAL_net{v}'s checkpoint: {written} PNGs {disp.shape}, K1 "
                                 f"{MedForward.launches} launches at {shapes}")
        k1 += 1
        line(f"phase 16 cli.train --model {v} --no_levels {VARIANT_LEVELS} {TRAIN_H}x{TRAIN_W} B={BATCH}: "
             f"{TRAIN_STEPS} steps in {secs:.2f} s, epoch loss {epoch['loss']:.6f}; K1 {k1_t}, K2 {k2_t} launches; "
             f"cli.infer (no --model; FAL_net{v} N={VARIANT_LEVELS} read from the checkpoint) 2 frames, K1 at "
             f"{shapes}, PNG disparity in [{disp.min():.4f}, {disp.max():.4f}] px")
    out_dir = os.path.join(workdir, "eval_quirk")
    metrics, (ev,), disps, by_mode, secs = recorded_eval(lambda: cli_test.main([
        "--data_root", evaluation["root"], "--lists_dir", evaluation["save_lists"], "--pretrained", ckpts["A"],
        "--batch_size", str(BATCH), "--maskr_quirk", "--save", "--save_pan", "--save_path", out_dir]))
    check_eval_outputs(out_dir, metrics, "cli.test --maskr_quirk")
    want = {"disp+pan+subocc": 2, "disp": 2}  # the batch's forward and its 2/3 pass (ms-pp), and the gate's
    saved = all(os.path.isfile(os.path.join(out_dir, sub, f"{i:010d}.png")) for i in range(EVAL_SAVED)
                for sub in ("disp", "pan"))
    if by_mode != want or len(disps) != EVAL_SAVED or not ev.model.a_maskr_quirk or not saved or \
            (ev.model.spec.name, ev.model.num_levels) != ("A", VARIANT_LEVELS):
        raise AssertionError(f"cli.test --maskr_quirk: K1 {by_mode} (want {want}), {len(disps)} images, quirk "
                             f"{ev.model.a_maskr_quirk}, exports {saved}")
    k1 += sum(by_mode.values()) - len(ev.med_checked)  # the gate's comparisons apart
    line(f"phase 16 cli.test --maskr_quirk --save --save_pan FAL_netA N={VARIANT_LEVELS} ({EVAL_SAVED} frames at "
         f"{next(iter(EVAL_SHAPES.values()))}) in {secs:.2f} s: K1 {by_mode}; abs_rel {metrics['abs_rel']:.6f} a1 "
         f"{metrics['a1']:.6f}; disp and pan PNGs written [{card}]")
    line(f"phase 16 FAL_netA and FAL_netC: K1 {k1}, K2 {k2}, L1 {l1} launches on their paths; worst abs err K1 "
         f"{worst_k1:.3e}, K2 {worst_k2:.3e}")
    return {"k1": k1, "k2": k2, "l1": l1, "worst_k1": worst_k1, "worst_k2": worst_k2}


def phase_soak(card: str) -> dict:
    """Phase 17: the training soak in bf16 (see the module docstring).
    Returns the launches of its main path, the gates' apart."""
    from fal_net_torch.scripts import soak_train

    res = soak_train.soak()
    failed = [name for name, ok in res["checks"].items() if not ok]
    line(f"phase 17 soak_train FAL_netB N=49 192x640 B=8 bf16: phase 1 epochs {res['losses1']}, step "
         f"{res['step1']}, {res['seconds1']:.2f} s; phase 2 (a fresh Trainer resumed) {res['losses2']}, step "
         f"{res['step2']}, {res['seconds2']:.2f} s (host clock); median step {res['step_ms1']:.3f}, "
         f"{res['step_ms2']:.3f} ms (CUDA events); Data meter {res['data1']:.4f}, {res['data2']:.4f} s a step; "
         f"K1, K2, L1 launches {res['launches1']}, {res['launches2']} (gates included); "
         f"{'every check holds' if not failed else f'FAILED {failed}'} [{card}]")
    if failed:
        raise AssertionError(f"phase 17 soak_train: {failed}; launches {res['launches1']}, {res['launches2']} "
                             f"(want {res['want_launches']})")
    (k1a, k2a, l1a), (k1b, k2b, l1b) = res["launches1"], res["launches2"]
    return {"k1": k1a + k1b - 2, "k2": k2a + k2b - 2, "l1": l1a + l1b}  # a gate's K1 and K2 in each phase


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="DIR", help="also run phase 6, writing its tables to DIR")
    args = parser.parse_args()
    t_start = time.perf_counter()
    name, card = timed("1", phase_device)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    timed("2", phase_build)
    worst3 = timed("3", phase_kernel_vs_plain, rng, dev)
    worst3b = timed("3b", phase_bwd_vs_plain, rng, dev)
    with tempfile.TemporaryDirectory() as serve_dir, tempfile.TemporaryDirectory() as eval_dir:
        model, lefts, serve_launches, worst4 = timed("4", phase_slice, rng, dev, args.seed, serve_dir)
        times = timed("5", phase_times, model, lefts, card, dev, args.seed)
        if args.profile:
            timed("6", phase_profile, model, lefts, card, args.profile, dev, args.seed)
        del model, lefts
        with tempfile.TemporaryDirectory() as workdir:
            train = timed("7a-7c", phase_train, rng, dev, workdir)
            later = timed("7d-7e", phase_later_stages, dev, train["root"], train["ckpt"], workdir)
            default = timed("7f", phase_default_run, rng, dev, train["root"], workdir, card, args.seed)
            remat = timed("7g", phase_remat, dev, train["root"], workdir, card, args.seed)
            bf16_train = timed("12 cli.train", phase_bf16_train, train["root"], workdir)
        timed("8", lambda: phase_converge_stage2(dev, *phase_converge(dev)))
        evaluation = timed("10", phase_eval, rng, dev, args.seed, card, eval_dir)
        script_kernels = timed("9", phase_scripts, card)
        with tempfile.TemporaryDirectory() as workdir:
            artifact = timed("11", phase_artifact, dev, card, serve_dir, evaluation, workdir)
        with tempfile.TemporaryDirectory() as workdir:
            bf16 = timed("12", phase_bf16, rng, dev, card, args.seed, serve_dir, evaluation, workdir)
            multi = timed("13", phase_multi, dev, card, evaluation, workdir)
            spatial = timed("14", phase_spatial, dev, card, workdir)
        quick = timed("15", phase_quickstart)
        with tempfile.TemporaryDirectory() as workdir:  # phase 10's tree stays for phase 16's cli.test
            variants = timed("16", phase_variants, rng, dev, card, args.seed, evaluation, workdir)
    soak = timed("17", phase_soak, card)
    line(f"phase seconds (host clock): {PHASE_S}; {time.perf_counter() - t_start:.1f} s in all, the interpreter's "
         f"start and imports apart")
    k1_bound, k1_by = bound(times["disp"][2], OPS_PER_LOGIT["med_fwd"] * times["disp_logits"])
    k2_bound, k2_by = bound(times["k2_bytes"], OPS_PER_LOGIT["med_bwd"] * times["k2_logits"])
    print(json.dumps({"kernels": [
        {
            "name": "med_fwd",
            "route": "cuda",
            "source": "fal_net_torch/csrc/med_fwd.cu",
            "replaces": "fal_net_tpu/ops/med_pallas.py:116",
            # serving (phase 4), training (phase 7a-c, 7d stage 2, 7e stage 1 slow, 7f the default run with
            # validation, 7g remat), evaluation (phase 10), the serving artifacts (phase 11), bf16 (phase 12) and
            # the DDP ranks and evaluation replicas (phase 13), the ranks that split rows (phase 14), the quickstart
            # (phase 15), FAL_netA and C at N = 33 (phase 16) and the training soak (phase 17)
            "launches": serve_launches + train["k1"] + later["k1"] + default["k1"] + remat["k1"] + evaluation["k1"]
            + artifact["k1"] + bf16_train["k1"] + bf16["k1"] + multi["k1"] + spatial["k1"] + quick["k1"]
            + variants["k1"] + soak["k1"],
            "max_abs_err": max(worst3, worst4, default["worst"], evaluation["worst"], bf16["worst"],
                               variants["worst_k1"]),
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
            # training paths (phase 7a-c, 7d, 7e, 7f, 7g, the bf16 steps of phase 12, the DDP ranks of phase 13, the
            # ranks that split rows in phase 14, the quickstart's steps in phase 15, FAL_netA's and C's in phase 16,
            # the soak's 75 in phase 17)
            "launches": train["k2"] + later["k2"] + default["k2"] + remat["k2"] + bf16_train["k2"] + bf16["k2"]
            + multi["k2"] + spatial["k2"] + quick["k2"] + variants["k2"] + soak["k2"],
            "max_abs_err": max(worst3b, train["worst"], later["worst"], default["k2_worst"], variants["worst_k2"]),
            "ms": times["k2"][0],  # disp+pan cotangents, no g_img, at (8, 49, 192, 640)
            "plain_ms": times["k2"][1],
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
        {
            "name": "logits_conv",
            "route": "cuda",
            "source": "fal_net_torch/csrc/logits_conv.cu",
            "replaces": "fal_net_tpu/models/layers.py:67",  # _conv_accum, an XLA conv: no Pallas counterpart
            # the bf16 paths of phase 12: cli.train, the forward, the stage-1 and stage-2 steps, cli.test, the
            # artifact; FAL_netA's and C's bf16 forwards (33 output channels) in phase 16; the soak's 75 bf16
            # steps in phase 17
            "launches": bf16_train["l1"] + bf16["l1"] + variants["l1"] + soak["l1"],
            "max_abs_err": bf16["l1_kernel"]["max_abs_err"],  # every L1_SHAPES entry, Cout 33 included
            "ms": bf16["l1_kernel"]["ms"],  # (8, 96, 384, 1280) -> 49
            "plain_ms": bf16["l1_kernel"]["plain_ms"],
            "bound_ms": bf16["l1_kernel"]["bound_ms"],
            "bound_by": bf16["l1_kernel"]["bound_by"],
            "library_ms": bf16["l1_kernel"]["library_ms"],  # cuDNN bf16 conv2d, bf16 out: the nearest call
        },
        *script_kernels,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

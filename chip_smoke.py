#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fal_net_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Phases, each reported on its own line; any failure exits nonzero:
  1. device: name, power limit, TF32 settings (no GPU -> exit 1);
  2. build: compile the CUDA kernel(s) from fal_net_torch/csrc;
  3. kernel vs plain: the MED forward kernel against the plain PyTorch head
     on shared seeded inputs, every mode, at the TPU kernel tests' shapes, with
     per-sample bound tensors, and at the serving shape (8, 49, 384, 1280),
     with those tests' tolerances;
  4. the slice: FAL_netB N=49 with seeded random weights is saved to a .pt,
     19 synthetic 384x1280 PNGs go through ``fal_net_torch.cli.infer`` at
     batch 8, then the disp+pan forward runs at batch 1 and 8, and at batch 8
     with per-sample bound tensors; each run must launch the kernel, and the
     kernel and the plain head must agree on the model's own logits;
  5. times (CUDA events, median after warm-up): kernel vs plain head at
     (8, 49, 384, 1280), and the whole forward at batch 8 and batch 1;
  6. only with ``--profile DIR``: ``torch.profiler`` over the disp-only
     forward at batch 8 and 1 (device window, busy share, kernel time by
     kind; the per-kernel table goes to DIR), and the forward with TF32
     convolutions off.
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
from fal_net_torch.ops.med_kernel import MedForward, med_outputs_fused

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
    (2, 49, 16, 1280, 3, (2.0, 1.0), 300.0),  # per-sample min, shared 0-d max
    (8, 49, 384, 1280, 3, 2.0, 300.0),  # serving shape
]
SERVE_H, SERVE_W, N_IMAGES, BATCH = 384, 1280, 19, 8


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


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
            worst = max(worst, compare(got, want, f"{label} {mode}"))
    line(f"phase 3 kernel vs plain: {len(SHAPES)} shapes x {len(MODES)} modes agree, "
         f"worst abs err {worst:.3e}")
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

    MedForward.launches = 0
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
    if cli_launches != batches or launches != expect:
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


def phase_times(model, lefts, card: str):
    image = lefts[BATCH]
    with torch.inference_mode():
        logits = model.logits(image, 300.0)
        times = {}
        for mode in ("disp", "disp+pan", "disp+pan+subocc"):
            kw = MODES[mode]
            k = median_ms(lambda: med_outputs_fused(logits, image, 2.0, 300.0, **kw))
            p = median_ms(lambda: med_outputs(logits, image, 2.0, 300.0, **kw))
            times[mode] = (k, p)
            line(f"phase 5 MED head ({BATCH}, 49, {SERVE_H}, {SERVE_W}) {mode}: kernel {k:.4f} ms, "
                 f"plain {p:.4f} ms [{card}]")
        for mode in ("disp", "disp+pan"):
            for b in (BATCH, 1):
                ms = median_ms(lambda: model(lefts[b], 2.0, 300.0, **MODES[mode]))
                line(f"phase 5 forward FAL_netB N=49 {SERVE_H}x{SERVE_W} {mode} B={b}: {ms:.3f} ms, "
                     f"{1000 * b / ms:.2f} imgs/s [{card}]")
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
    ("layout transposes", "nchwtonhwc|nhwctonchw|transpose"),
    ("nearest upsample", "upsample"),
    ("ELU", "elu"),
    ("concat", "catarray|cat_"),
    ("convolutions", "conv|xmma|cudnn|implicit|gemm|cutlass|sm90|winograd|fft"),
    ("adds", "add"),
]


def phase_profile(model, lefts, card: str, out_dir: str, reps: int = 5) -> None:
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    for b in (BATCH, 1):
        fwd = lambda: model(lefts[b], 2.0, 300.0, ret_disp=True)
        with torch.inference_mode():
            for _ in range(3):
                fwd()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fwd()
                torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            raise AssertionError("torch.profiler recorded no device activity")
        spans = [(e.time_range.start, e.time_range.end) for e in kernels]
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        by_kind = {k: 0.0 for k, _ in KINDS} | {"other": 0.0}
        for name, us in by_name.items():
            kind = next((k for k, rx in KINDS if re.search(rx, name.lower())), "other")
            by_kind[kind] += us
        path = os.path.join(out_dir, f"profile_b{b}.txt")
        with open(path, "w") as f:
            f.write(f"FAL_netB N=49 {SERVE_H}x{SERVE_W} disp-only B={b}, {reps} forwards [{card}]\n")
            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
                kind = next((k for k, rx in KINDS if re.search(rx, name.lower())), "other")
                f.write(f"{us / reps / 1000:10.4f} ms/fwd  {kind:18s} {name}\n")
        line(f"phase 6 profile B={b} disp: device window {window / reps / 1000:.4f} ms/fwd, "
             f"busy share {_union_us(spans) / window:.4f}; ms/fwd by kind: "
             + ", ".join(f"{k} {us / reps / 1000:.4f}" for k, us in by_kind.items())
             + f"; table {path} [{card}]")
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for b in (BATCH, 1):
                ms = median_ms(lambda: model(lefts[b], 2.0, 300.0, ret_disp=True))
                line(f"phase 6 forward TF32 off FAL_netB N=49 {SERVE_H}x{SERVE_W} disp B={b}: "
                     f"{ms:.3f} ms [{card}]")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    line(f"phase 6 peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")


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
    with tempfile.TemporaryDirectory() as workdir:
        model, lefts, launches, worst4 = phase_slice(rng, dev, args.seed, workdir)
    times = phase_times(model, lefts, card)
    if args.profile:
        phase_profile(model, lefts, card, args.profile)
    print(json.dumps({"kernels": [{
        "name": "med_fwd",
        "route": "cuda",
        "source": "fal_net_torch/csrc/med_fwd.cu",
        "replaces": "fal_net_tpu/ops/med_pallas.py:116",
        "launches": launches,
        "max_abs_err": max(worst3, worst4),
        "ms": times["disp"][0],
        "plain_ms": times["disp"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

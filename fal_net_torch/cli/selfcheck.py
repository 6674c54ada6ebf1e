"""Deployment self-check: a health gate for an install on the card
(counterpart of fal_net_tpu/cli/selfcheck.py).

    python -m fal_net_torch.cli.selfcheck [--full] [--timeout 900] [--device cuda]

Phases, in order:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. forward: FAL_netB N=49 with seeded random weights at 192x640, disp, pan
   and masks: finite, disparities inside [min_disp, max_disp], masks in
   [0, 1] (on the card the MED head is K1);
3. kernels: K1 in each of its model modes and K2 against their plain
   versions at 96x256, N=49 (ops/med_selfcheck.py);
4. train step: one stage-1 step (forward, backward, Adam) of the tiny model
   on synthetic stereo: the loss finite, the parameters moved;
5. with ``--full``: FAL_netB's disp forward at 384x1280, batch 8, in
   images/s (CUDA events, median of 10), beside the card's name and power
   limit.

Each phase runs under a watchdog thread with ``--timeout`` seconds, so a
hung card gives a TIMEOUT line instead of a silent hang (the remaining
phases share the card and are skipped).  ``--device cpu`` runs the
phases that do not need a card and prints the kernel and throughput phases
as NOT RUN; without a card, the default ``--device cuda`` fails the gate.
The exit code is 0 only if every phase that ran passed.  JAX's
``utils/faults.py`` serves a TPU behind a relay and has no counterpart.
"""

from __future__ import annotations

import argparse
import subprocess
import threading
import time
from typing import Callable

import numpy as np
import torch

NOT_RUN = object()  # a phase's result when it does not apply to the device asked for


def bounded(fn: Callable[[], object], budget_s: float):
    """(ok, value or error, seconds) of ``fn()`` run on a daemon thread that
    is given ``budget_s`` seconds; a TimeoutError when it overruns."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # reported, not raised: the gate prints every phase
            box["error"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(budget_s)
    secs = time.perf_counter() - t0
    if thread.is_alive():
        return False, TimeoutError(f"no result after {budget_s:.0f} s"), secs
    if "error" in box:
        return False, box["error"], secs
    return True, box["value"], secs


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def check_device(device: torch.device):
    if device.type != "cuda":
        return f"{device} (no CUDA device requested)"
    from fal_net_torch.utils.device import resolve_device

    resolve_device(device)
    return (f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(device)}; nvidia-smi: {card_line()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")


def check_forward(device: torch.device):
    from fal_net_torch.models import create_model

    model = create_model("B", 49, generator=torch.Generator().manual_seed(0), device=device).eval()
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.standard_normal((1, 3, 192, 640), np.float32) * 0.3).to(device)
    with torch.no_grad():
        out = model(left, 2.0, 300.0, ret_disp=True, ret_pan=True, ret_subocc=True)
    disp = out.disp.cpu().numpy()
    assert np.isfinite(disp).all(), "disparities not finite"
    assert disp.min() >= 2.0 - 1e-3 and disp.max() <= 300.0 + 1e-2, (
        f"disp outside [min_disp, max_disp]: [{disp.min()}, {disp.max()}]")
    for name in ("maskL", "maskR"):
        m = getattr(out, name).cpu().numpy()
        assert np.isfinite(m).all() and m.min() >= -1e-5 and m.max() <= 1 + 1e-5, f"{name} outside [0, 1]"
    assert torch.isfinite(out.pan).all(), "pan not finite"
    return f"disp range [{disp.min():.2f}, {disp.max():.2f}] px"


def check_kernels(device: torch.device):
    if device.type != "cuda":
        return NOT_RUN
    from fal_net_torch.ops.med_selfcheck import MODES, med_selfcheck

    worst = med_selfcheck(96, 256, 49, [2.0], [300.0], device, modes=tuple(MODES), backward=True)
    return f"K1 ({', '.join(MODES)}) and K2 (disp+pan) agree with the plain versions: max abs err {worst:.1e}"


def check_train_step(device: torch.device):
    from fal_net_torch.models import create_model
    from fal_net_torch.train.stages import stage1_loss
    from fal_net_torch.train.state import create_optimizer

    model = create_model("tiny", 5, generator=torch.Generator().manual_seed(0), device=device)
    opt, _ = create_optimizer(model, lr=1e-4, beta1=0.5, beta2=0.999, milestones=(30, 40), lr_gamma=0.5,
                              steps_per_epoch=1)
    rng = np.random.default_rng(0)
    view = rng.random((4, 3, 64, 128 + 4), np.float32) - 0.5  # right = left shifted by 4 px
    batch = {"left": torch.from_numpy(view[..., :128].copy()).to(device),
             "right": torch.from_numpy(view[..., 4:].copy()).to(device)}
    before = [p.detach().clone() for p in model.parameters()]
    loss, _ = stage1_loss(model, batch, min_disp=2.0, max_disp=30.0, a_p=0.0, a_sm=0.2 * 2 / 512)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    assert torch.isfinite(loss), "train loss not finite"
    moved = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert moved, "parameters did not update"
    return f"loss {loss.item():.4f}, {moved} of {len(before)} parameter tensors updated"


def check_throughput(device: torch.device):
    if device.type != "cuda":
        return NOT_RUN
    from fal_net_torch.models import create_model
    from fal_net_torch.utils.timing import median_ms

    model = create_model("B", 49, generator=torch.Generator().manual_seed(0), device=device).eval()
    batch, h, w = 8, 384, 1280
    left = torch.from_numpy(np.random.default_rng(0).standard_normal((batch, 3, h, w), np.float32) * 0.3).to(device)
    with torch.no_grad():
        ms = median_ms(lambda: model(left, 2.0, 300.0, ret_disp=True), reps=10)
    return (f"{batch * 1000 / ms:.1f} images/s ({ms:.3f} ms a batch; {h}x{w} fp32, TF32 convs, B={batch}) "
            f"[{card_line()}]")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--full", action="store_true", help="also run the serving-shape throughput phase")
    p.add_argument("--timeout", type=float, default=900.0, help="per-phase watchdog in seconds")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def main(argv=None) -> None:
    """Prints a line per phase and SELFCHECK: PASS or FAIL; raises
    SystemExit with 0 only if every phase that ran passed."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    phases = [("device", check_device), ("forward", check_forward), ("kernels", check_kernels),
              ("train step", check_train_step)]
    if args.full:
        phases.append(("throughput", check_throughput))
    failed = False
    for name, fn in phases:
        ok, value, secs = bounded(lambda: fn(device), args.timeout)
        if ok and value is NOT_RUN:
            print(f"  NOT RUN {name:12s} (no CUDA device requested)", flush=True)
        elif ok:
            print(f"  OK   {name:12s} {value}  [{secs:.1f}s]", flush=True)
        else:
            failed = True
            kind = "TIMEOUT" if isinstance(value, TimeoutError) else "FAIL"
            print(f"  {kind} {name:12s} {value!r}  [{secs:.1f}s]", flush=True)
            if isinstance(value, TimeoutError):
                print("  (the device is unresponsive: skipping the remaining phases)", flush=True)
                break
    print("SELFCHECK:", "FAIL" if failed else "PASS", flush=True)
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()

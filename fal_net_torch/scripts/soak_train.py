"""The production ``Trainer`` on the card, with mid-run checkpoints and a
full-state resume, at the stage-1 shape: the counterpart of the JAX
package's scripts/soak_train_tpu.py.

    python -m fal_net_torch.scripts.soak_train [--fp32]

Unlike the convergence runs (``chip_smoke.py`` phases 8 and 16), which chain
raw steps, this drives ``Trainer.fit`` (the threaded loader, device
prefetch, Adam, the per-step MultiStepLR, ``.pt`` checkpoints) at FAL_netB
N=49, 192x640, batch 8, in bf16 (fp32 with ``--fp32``), on the synthetic
smooth stereo of the JAX script (:class:`SmoothStereo`):

  * phase 1: 2 epochs of 25 steps, a checkpoint every 10 steps and at each
    epoch's end;
  * phase 2: a fresh ``Trainer`` resumes from the last full-state checkpoint
    (weights, Adam's moments, the schedule, the step) and trains 1 more
    epoch.

JAX's asserts: the step counter at 50, then 75; exactly one resumed epoch;
every epoch loss finite; the resumed epoch's loss below 1.2 x the larger of
phase 1's (Adam's moments and the schedule survived the round trip;
convergence itself is the convergence runs' to show).  On top of them: on
the card K1 and K2 launch once a step and once in each ``Trainer``'s gate,
and in bf16 L1 once a step; and the mid-epoch checkpoint written at step
10, restored into a throwaway ``Trainer``, gives step 10 and the weights
and Adam state of that step exactly.

Prints each phase's host seconds, the median step by CUDA events, the
Trainer's Data meter (host seconds a step waiting for its batch) and the
card's name and power limit, then ``SOAK TRAIN VERIFY: PASS`` or ``FAIL``;
exits 1 on a failure.  ``main`` runs on the GPU and raises without one.
:func:`soak` takes the sizes, model, step counts and device as arguments,
the JAX script's values by default, so that a test can run it small on the
CPU (where the model's MED head is the plain one and nothing launches).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from fal_net_torch.ops import _build
from fal_net_torch.ops.logits_conv import LAUNCHES as L1_LAUNCHES
from fal_net_torch.ops.med_kernel import MedForward
from fal_net_torch.train import Stage1Config, Trainer
from fal_net_torch.utils.device import resolve_device


class SmoothStereo:
    """Synthetic smooth stereo at the stage-1 crop (192x640): right = left
    shifted DISP px, the arrays of the JAX script's class from the same
    seed (a cubic zoom of coarse noise, centred at 0; NHWC float32), cycled
    to ``length`` items."""

    DISP = 8

    def __init__(self, unique=8, length=400, h=192, w=640, seed=0):
        import scipy.ndimage as ndi

        rng = np.random.default_rng(seed)
        self.length = length
        self.samples = []
        for _ in range(unique):
            coarse = rng.random((h // 16 + 2, (w + self.DISP) // 16 + 2, 3)).astype(np.float32)
            wide = ndi.zoom(coarse, (16, 16, 1), order=3)[:h, : w + self.DISP]
            self.samples.append({"left": wide[:, :w] - 0.5, "right": wide[:, self.DISP:] - 0.5})

    def __len__(self):
        return self.length

    def get(self, i, rng=None):
        return self.samples[i % len(self.samples)]


class SoakTrainer(Trainer):
    """A ``Trainer`` that times each step by CUDA events (on the card) and,
    when it checkpoints at step ``keep_step``, keeps a copy of that file
    (``step<keep_step>.pt``) and of the weights and Adam state it holds."""

    def __init__(self, *args, keep_step: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.keep_step = keep_step
        self.events = []
        self.kept = None

    def train_step(self, batch):
        if self.device.type != "cuda":
            return super().train_step(batch)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = super().train_step(batch)
        end.record()
        self.events.append((start, end))
        return out

    def _save(self, save_path, meta, is_best=False):
        path = super()._save(save_path, meta, is_best=is_best)
        if path and self.step == self.keep_step and self.kept is None:
            kept = os.path.join(save_path, f"step{self.step}.pt")
            shutil.copyfile(path, kept)
            cpu = lambda d: {k: v.detach().cpu().clone() if torch.is_tensor(v) else v for k, v in d.items()}
            self.kept = {"path": kept, "step": self.step, "model": cpu(self.model.state_dict()),
                         "adam": {i: cpu(st) for i, st in self.optimizer.state_dict()["state"].items()}}
        return path

    def step_ms(self) -> list:
        torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) for a, b in self.events]


def _launches() -> tuple:
    return MedForward.launches, MedForward.bwd_launches, L1_LAUNCHES["logits_conv"]


def restores_exactly(cfg, kept: dict, dataset, device) -> bool:
    """A throwaway ``Trainer`` resumed from ``kept``'s checkpoint (its gate
    off) holds its step, weights and Adam state, tensor for tensor."""
    trainer = Trainer(dataclasses.replace(cfg, resume=kept["path"], med_selfcheck=False), "stage1", device=device,
                      train_dataset=dataset)
    trainer.setup()
    adam = trainer.optimizer.state_dict()["state"]
    same = lambda a, b: torch.equal(a.cpu(), b) if torch.is_tensor(b) else a == b
    model = trainer.model.state_dict()
    return (trainer.step == kept["step"] and adam.keys() == kept["adam"].keys()
            and all(same(model[k], v) for k, v in kept["model"].items())
            and all(same(adam[i][k], v) for i, st in kept["adam"].items() for k, v in st.items()))


def soak(device="cuda", dtype="bfloat16", model="B", num_levels=49, batch_size=8, crop=(192, 640), steps=25,
         save_every=10, keep_step=10, workers=2, unique=8, length=400, workdir=None) -> dict:
    """The two phases (see the module docstring) in ``workdir`` (a new
    temporary directory when None, removed after).  Returns {"ok", "checks":
    {name: bool}, "losses1", "losses2", "step1", "step2", "launches1",
    "launches2" ((K1, K2, L1) of each phase, its gate included),
    "want_launches", "seconds1", "seconds2", "step_ms1", "step_ms2"
    (medians by CUDA events, None on the CPU), "data1", "data2" (the Data
    meter's mean of each phase's last epoch, s)}."""
    dev = resolve_device(device)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="soak_") if own else workdir
    try:
        run_dir = os.path.join(workdir, "run")
        ds = SmoothStereo(unique=unique, length=length, h=crop[0], w=crop[1])
        common = dict(model=model, num_levels=num_levels, batch_size=batch_size, crop_size=tuple(crop),
                      epoch_size=steps, lr=1e-4, max_disp=300.0, min_disp=2.0, a_p=0.0, workers=workers,
                      compute_dtype=dtype, print_freq=10, save_every_steps=save_every)
        res = {}
        for phase, cfg in ((1, Stage1Config(**common, epochs=2)),
                           (2, Stage1Config(**common, epochs=3, resume=os.path.join(run_dir, "checkpoint.pt")))):
            if dev.type == "cuda":
                _build.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = SoakTrainer(cfg, "stage1", device=dev, train_dataset=ds, keep_step=keep_step if phase == 1 else 0)
            result = trainer.fit(save_path=run_dir)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            res[f"seconds{phase}"] = time.perf_counter() - t0
            res[f"losses{phase}"] = [h["loss"] for h in result["history"]]
            res[f"step{phase}"] = trainer.step
            res[f"launches{phase}"] = _launches() if dev.type == "cuda" else (0, 0, 0)
            res[f"step_ms{phase}"] = statistics.median(trainer.step_ms()) if dev.type == "cuda" else None
            res[f"data{phase}"] = trainer.data_time.avg
            print(f"phase{phase}{' (resumed)' if phase == 2 else ''}: epochs {res[f'losses{phase}']}, step "
                  f"{trainer.step}, {res[f'seconds{phase}']:.1f} s", flush=True)
            if phase == 1:
                kept = trainer.kept
            del trainer
        # K1 and K2 once a step and once in the gate, L1 once a bf16 step; nothing launches on the CPU
        k, l1 = (1, int(dtype == "bfloat16")) if dev.type == "cuda" else (0, 0)
        want = {p: (k * (n * steps + 1), k * (n * steps + 1), l1 * n * steps) for p, n in ((1, 2), (2, 1))}
        losses1, losses2 = res["losses1"], res["losses2"]
        checks = {
            "step 2 x steps after phase 1": res["step1"] == 2 * steps,
            "step 3 x steps after phase 2": res["step2"] == 3 * steps,
            "one resumed epoch": len(losses2) == 1,
            "losses finite": all(np.isfinite(v) for v in losses1 + losses2),
            "resumed loss below 1.2 x phase 1's": len(losses2) == 1 and losses2[0] < 1.2 * max(losses1),
            "launches": res["launches1"] == want[1] and res["launches2"] == want[2],
            f"step {keep_step} restored exactly": kept is not None and restores_exactly(
                Stage1Config(**common, epochs=2), kept, ds, dev),
        }
        return {"ok": all(checks.values()), "checks": checks, "want_launches": want, **res}
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fp32", action="store_true", help="train in fp32 (TF32 convolutions), not bf16")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("soak_train runs on the GPU; torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dtype = "float32" if args.fp32 else "bfloat16"
    res = soak(dtype=dtype)
    for name, ok in res["checks"].items():
        print(f"  {'OK ' if ok else 'FAIL'} {name}", flush=True)
    print(f"phase 1 {res['seconds1']:.1f} s, phase 2 {res['seconds2']:.1f} s (host clock); median step "
          f"{res['step_ms1']:.3f} ms, {res['step_ms2']:.3f} ms (CUDA events); Data {res['data1']:.4f}, "
          f"{res['data2']:.4f} s a step; K1, K2, L1 launches {res['launches1']}, {res['launches2']} [{card}]",
          flush=True)
    print(f"SOAK TRAIN VERIFY: {'PASS' if res['ok'] else 'FAIL'} ({dtype})", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""K5 on the card: the windowed roll (``csrc/roll_probe.cu``) swept over the
JAX probe's row lengths and shifts (scripts/probe_roll_bug.py), plus shifts
that wrap (wp - 1, -3, wp + 5).

    python -m fal_net_torch.scripts.probe_roll_bug

A zero row of wp columns holds x (8, 128) at [128, 256); the kernel rolls
it left by f, read from device memory, and reads the window back.  Each
(wp, f) must equal numpy's roll of the same row exactly, and so must the
plain version.  Prints one line per wp, the kernel's and the plain
version's times at wp = 640 (median of 20 calls), and ``ROLL PROBE: PASS``
or ``FAIL``; exits nonzero on FAIL.  x comes from seed 0.  Runs on the GPU
only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from fal_net_torch.ops.roll_probe import roll_window, roll_window_plain
from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.timing import median_ms

H, W, L = 8, 128, 128  # the window [L, L + W), as the MED kernel's pad
TILES = (3, 4, 5, 6, 8)  # wp = tiles * 128
SHIFTS = (0, 1, 5, 17, 127)
TIMED_WP = 640
SEED, REPS = 0, 20


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help only
    dev = resolve_device("cuda")
    xn = np.random.default_rng(SEED).standard_normal((H, W)).astype(np.float32)
    x = torch.from_numpy(xn).to(dev)
    calls, ok_all, worst = 0, True, 0.0
    for tiles in TILES:
        wp = tiles * 128
        bad = []
        for f in SHIFTS + (wp - 1, -3, wp + 5):
            ft = torch.tensor([f], dtype=torch.int32, device=dev)
            got = roll_window(x, ft, wp, L).cpu().numpy()
            calls += 1
            plain = roll_window_plain(x, ft, wp, L).cpu().numpy()
            buf = np.zeros((H, wp), np.float32)
            buf[:, L : L + W] = xn
            want = np.roll(buf, -f, axis=1)[:, L : L + W]
            err = float(np.abs(got - want).max())
            worst = max(worst, err)
            if not (np.array_equal(got, want) and np.array_equal(plain, want)):
                bad.append((f, err))
        ok_all &= not bad
        print(f"wp={wp} ({tiles}x128): " + ("ok" if not bad else f"FAIL {bad}"), flush=True)

    ft = torch.tensor([17], dtype=torch.int32, device=dev)

    def launch():
        nonlocal calls
        calls += 1
        return roll_window(x, ft, TIMED_WP, L)

    ms = median_ms(launch, reps=REPS)
    plain_ms = median_ms(lambda: roll_window_plain(x, ft, TIMED_WP, L), reps=REPS)
    print(f"wp={TIMED_WP} f=17 ({H}, {W}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"[{torch.cuda.get_device_name(dev)}]", flush=True)
    print("ROLL PROBE:", "PASS" if ok_all else "FAIL", flush=True)
    return {"ok": ok_all, "ms": ms, "plain_ms": plain_ms, "calls": calls, "max_abs_err": worst,
            "bytes": 4 * (2 * x.numel() + 1)}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)

"""What the two conv scripts share: for each (B, Cin, H, W, Cout) case, a
conv kernel against its plain version and against ``F.conv2d`` (cuDNN, the
yardstick; the port never calls it), and its time beside cuDNN's with TF32
off and on.  The inputs come from seed 0 and each time is the median of 20
calls, as in the JAX scripts."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.timing import median_ms, tf32

RTOL, ATOL = 1e-5, 1e-4  # fp32 sums of up to 9 * 96 terms in another order
SEED, REPS = 0, 20


def run_cases(label: str, kernel, plain, make_weights, cases) -> dict:
    """Run ``kernel(x, make_weights(w))`` on every case, compare and time it.

    Raises AssertionError on a disagreement beyond (RTOL, ATOL) with the
    plain version or with cuDNN in fp32.  Returns {"cases": [one dict per
    case], "calls": kernel calls made}."""
    dev = resolve_device("cuda")
    card = torch.cuda.get_device_name(dev)
    rng = np.random.default_rng(SEED)
    calls = 0
    results = []
    for case in cases:
        b, cin, h, w, cout = case
        x = torch.from_numpy(rng.standard_normal((b, cin, h, w), np.float32)).to(dev)
        w_oihw = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3), np.float32) * 0.05).to(dev)
        wk = make_weights(w_oihw)

        def launch():
            nonlocal calls
            calls += 1
            return kernel(x, wk)

        with tf32(False):
            got = launch()
            torch.cuda.synchronize()
            errs = {}
            for name, want in (("plain", plain(x, wk)), ("cudnn_fp32", F.conv2d(x, w_oihw, padding=1))):
                errs[name] = float((got - want).abs().max())
                if not (torch.isfinite(got).all() and torch.allclose(got, want, rtol=RTOL, atol=ATOL)):
                    raise AssertionError(
                        f"{label} {case}: kernel vs {name} max abs err {errs[name]:.3e} (rtol {RTOL}, atol {ATOL})"
                    )
            del got, want
            ms = median_ms(launch, reps=REPS)
            plain_ms = median_ms(lambda: plain(x, wk), reps=3, warmup=1)
            lib_ms = median_ms(lambda: F.conv2d(x, w_oihw, padding=1), reps=REPS)
        with tf32(True):
            lib_tf32_ms = median_ms(lambda: F.conv2d(x, w_oihw, padding=1), reps=REPS)
        flops = 2 * b * h * w * cin * cout * 9
        results.append(dict(
            case=case, ms=ms, plain_ms=plain_ms, cudnn_fp32_ms=lib_ms, cudnn_tf32_ms=lib_tf32_ms,
            err_plain=errs["plain"], err_cudnn_fp32=errs["cudnn_fp32"], flops=flops,
            bytes=4 * (x.numel() + wk.numel() + b * cout * h * w),
        ))
        print(
            f"{label} b{b} {cin:3d}->{cout:3d} @{h}x{w}: kernel {ms:.4f} ms ({flops / ms * 1e-9:.2f} TFLOP/s) | "
            f"plain {plain_ms:.3f} ms | cuDNN fp32 {lib_ms:.4f} ms, TF32 {lib_tf32_ms:.4f} ms | speedup vs "
            f"fp32 {lib_ms / ms:.2f}x, vs TF32 {lib_tf32_ms / ms:.2f}x | err vs plain {errs['plain']:.2e}, "
            f"vs cuDNN fp32 {errs['cudnn_fp32']:.2e} [{card}]",
            flush=True,
        )
        del x, wk, w_oihw
    return {"cases": results, "calls": calls}

"""What the two conv scripts share: for each (B, Cin, H, W, Cout) case, the
TF32 conv kernel against its plain versions, and its time beside cuDNN's
(``F.conv2d``, the yardstick; the port never calls it) with TF32 off and on.
The inputs come from seed 0 and each time is the median of 20 calls, as in
the JAX scripts."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fal_net_torch.ops.conv3x3 import tf32_round
from fal_net_torch.utils.device import resolve_device
from fal_net_torch.utils.timing import median_ms, tf32

# Against the plain version on TF32-truncated operands (for K3 that is
# conv3x3_tf32_plain): the same products, exact in fp32, summed in another order.
RTOL, ATOL = 1e-5, 1e-4
# Against the fp32 plain version: two truncations to TF32 bound each product's
# relative error by 2^-9, so |err| <= 2^-9 * (|x| conv |w|) + ATOL elementwise.
TF32_REL = 2.0**-9
SEED, REPS = 0, 20


def run_cases(label: str, kernel, plain, make_weights, cases) -> dict:
    """Run ``kernel(x, make_weights(w))`` on every case, compare and time it;
    ``plain`` is the kernel's fp32 plain version.

    Raises AssertionError on a disagreement beyond (RTOL, ATOL) with the plain
    version on TF32-truncated operands, or beyond the TF32 bound with the fp32
    plain version.  Returns {"cases": [one dict per case], "calls": kernel
    calls made}."""
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

        def plain_tf32():
            return plain(tf32_round(x), tf32_round(wk))

        with tf32(False):  # the plain versions' einsum in fp32
            got = launch()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} {case}: non-finite output")
            want_fp32, want_tf32 = plain(x, wk), plain_tf32()
            err_tf32 = float((got - want_tf32).abs().max())
            if not torch.allclose(got, want_tf32, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{label} {case}: kernel vs TF32 plain max abs err {err_tf32:.3e} "
                                     f"(rtol {RTOL}, atol {ATOL})")
            slack = TF32_REL * plain(x.abs(), wk.abs()) + ATOL
            err = (got - want_fp32).abs()
            err_fp32 = float(err.max())
            if not (err <= slack).all():
                raise AssertionError(f"{label} {case}: kernel vs fp32 plain max abs err {err_fp32:.3e} beyond "
                                     f"2^-9 (|x| conv |w|) + {ATOL}, worst ratio {float((err / slack).max()):.3f}")
            del got, err, slack, want_tf32
            ms = median_ms(launch, reps=REPS)
            plain_ms = median_ms(plain_tf32, reps=3, warmup=1)
            lib_ms = median_ms(lambda: F.conv2d(x, w_oihw, padding=1), reps=REPS)
        with tf32(True):
            err_cudnn = float((F.conv2d(x, w_oihw, padding=1) - want_fp32).abs().max())
            lib_tf32_ms = median_ms(lambda: F.conv2d(x, w_oihw, padding=1), reps=REPS)
        flops = 2 * b * h * w * cin * cout * 9
        results.append(dict(
            case=case, ms=ms, plain_ms=plain_ms, cudnn_fp32_ms=lib_ms, cudnn_tf32_ms=lib_tf32_ms,
            err_tf32_plain=err_tf32, err_fp32_plain=err_fp32, err_cudnn_tf32=err_cudnn, flops=flops,
            bytes=4 * (x.numel() + w_oihw.numel() + b * cout * h * w),
        ))
        print(
            f"{label} b{b} {cin:3d}->{cout:3d} @{h}x{w}: kernel {ms:.4f} ms ({flops / ms * 1e-9:.2f} TFLOP/s) | "
            f"TF32 plain {plain_ms:.3f} ms | cuDNN fp32 {lib_ms:.4f} ms, TF32 {lib_tf32_ms:.4f} ms | speedup vs "
            f"fp32 {lib_ms / ms:.2f}x, vs TF32 {lib_tf32_ms / ms:.2f}x | max abs err vs TF32 plain {err_tf32:.2e}, "
            f"vs fp32 plain {err_fp32:.2e} (cuDNN TF32 vs fp32 plain {err_cudnn:.2e}) [{card}]",
            flush=True,
        )
        del x, wk, w_oihw, want_fp32
    return {"cases": results, "calls": calls}

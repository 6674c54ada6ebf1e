"""K1 and K2 against their plain versions at logit magnitudes of 1e1 to
1e6, on the card.

    python -m fal_net_torch.scripts.med_scales [--scales 1e8 1e10 1e12]

A trained or saturating run drives the MED head's logits far from N(0, 1)
(FAL_netC's convergence run reaches a logit std of 2.1e6).  At each scale s
in ``SCALES``, two forms of logits are made from one seeded N(0, 1) draw z:
a spread, z * s, whose softmax saturates, and an offset, s + z, whose
softmax does not, so that any rounding at |l| shows undamped.  At each of
``SHAPES``, one on every staging path of the kernels (csrc/med_stage.cuh:
the whole row by bulk copies, cp.async, the ring, N = 33's whole row, and
each kernel's own direct path, ``PATHS``):

  * K1 (csrc/med_fwd.cu) in every mode against the plain head
    (ops/med.py) at ``TOL``;
  * K2 (csrc/med_bwd.cu) in every cotangent mode against
    :func:`exact_vjp` at ``GRAD_TOL``, the fp32 plain VJP's own error
    against it printed beside.  The fp32 plain VJP is no yardstick here:
    at a spread of 10 to 1e4 its disp term misses GRAD_TOL against its own
    float64 evaluation by up to ~10x (disp's fp32 rounding where
    d_n ~ disp), and a float64 evaluation of the whole VJP lerps the
    logits in double, which differs from the forward's fp32 lerp by up to
    an ulp of |l| (1e3x the tolerance in the offset form at 1e6).

Prints one line a (scale, form) with the worst error over tolerance of each
kernel (the largest |got - want| / (atol + rtol |want|); above 1 is a
miss) and where it is, then one JSON object; exits 1 on a miss.  It calls
only entry points that earlier versions of the package have too, so run as
a file with another checkout first on PYTHONPATH (``PYTHONPATH=OTHER python
fal_net_torch/scripts/med_scales.py``) it checks that version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from fal_net_torch.ops.med import med_outputs
from fal_net_torch.ops.med_kernel import describe_plan, med_outputs_fused, med_vjp_fused, plane_tables
from fal_net_torch.ops.med_vjp import med_vjp
from fal_net_torch.ops.shift import _lerp_gather

SCALES = (1e1, 1e2, 1e3, 1e4, 1e5, 1e6)
FORMS = ("spread", "offset")
# (B, N, H, W, C) by staging path, bounds 2..300 throughout
SHAPES = {
    "whole row": (1, 9, 16, 256, 3),
    "cp.async": (1, 9, 16, 187, 3),
    "ring": (2, 49, 16, 1280, 3),
    "N = 33 whole row": (2, 33, 16, 1280, 3),
    "K1 direct": (1, 49, 4, 11572, 3),
    "K2 direct": (1, 49, 4, 5000, 3),
}
# the paths each kernel is held on: the shared ones and its own direct path
PATHS = {"k1": [p for p in SHAPES if p != "K2 direct"], "k2": [p for p in SHAPES if p != "K1 direct"]}
MIN_DISP, MAX_DISP = 2.0, 300.0
# (rtol, atol) of the TPU kernel's own tests (tests/test_med_pallas.py)
TOL = {"disp": (1e-5, 1e-4), "pan": (1e-4, 1e-4), "maskL": (1e-4, 1e-4), "maskR": (1e-4, 1e-4)}
GRAD_TOL = (1e-4, 1e-5)
MODES = {
    "disp": dict(ret_disp=True),
    "pan": dict(ret_disp=False, ret_pan=True),
    "disp+pan": dict(ret_disp=True, ret_pan=True),
    "subocc": dict(ret_disp=False, ret_subocc=True),
    "disp+pan+subocc": dict(ret_disp=True, ret_pan=True, ret_subocc=True),
}
# (g_disp, g_pan, image_grad)
GRAD_MODES = {
    "disp": (True, False, False),
    "pan": (False, True, False),
    "disp+pan": (True, True, False),
    "pan+g_img": (False, True, True),
    "disp+pan+g_img": (True, True, True),
}


def scaled_inputs(shape, scale: float, form: str, device, seed: int = 0):
    """(logits, image, g_disp, g_pan) at (B, N, H, W, C) = ``shape``: the
    logits z * scale ("spread") or scale + z ("offset") in fp32 from one
    seeded N(0, 1) draw z, the rest N(0, 1)."""
    b, n, h, w, c = shape
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, n, h, w), np.float32)
    logits = z * np.float32(scale) if form == "spread" else z + np.float32(scale)
    rest = (rng.standard_normal((b, ch, h, w), np.float32) for ch in (c, 1, c))
    return tuple(torch.from_numpy(a).to(device) for a in (logits, *rest))


def over_tol(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 where
    ``torch.allclose(got, want, rtol, atol)`` holds; inf for a non-finite
    ``got``."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got.double() - want.double()).abs() / (atol + rtol * want.double().abs())).max())


def exact_vjp(logits, image, mn, mx, g_disp, g_pan, image_grad=True):
    """The VJP of the function the plain head computes, evaluated exactly:
    in float64 on the same inputs and fp32 plane tables, but for the
    shifted logits S_n l_n, which are the plain head's own fp32 values
    (ops/shift.py rounds 1 - t, each product and the sum in fp32).  The
    formulas of :func:`fal_net_torch.ops.med_vjp.med_vjp`; returns fp32
    (g_logits, g_image or None)."""
    b, n, h, w = logits.shape
    tabs = plane_tables(mn, mx, n, w, device=logits.device)
    s = tabs.shape[0]
    plane, img_plane = (s, n, 1, 1), (s, 1, n, 1, 1)
    lev = tabs[:, 0].double().view(plane)
    f, t = tabs[:, 1].long(), tabs[:, 2]
    g = torch.zeros_like(logits, dtype=torch.float64)
    g_image = None
    if g_disp is not None:
        sm0 = torch.softmax(logits.double(), dim=1)
        disp = (sm0 * lev).sum(dim=1, keepdim=True)
        g = g + sm0 * (lev - disp) * g_disp.double()
    if g_pan is not None:
        dprob = torch.softmax(_lerp_gather(logits, f.view(plane), t.view(plane)).double(), dim=1)
        t64 = t.double()
        img_s = _lerp_gather(image.double()[:, :, None], f.view(img_plane), t64.view(img_plane))
        gp = g_pan.double()
        q = dprob * (img_s * gp[:, :, None]).sum(dim=1)
        g_shift = q - dprob * q.sum(dim=1, keepdim=True)
        g = g + _lerp_gather(g_shift, (-f - 1).view(plane), (1 - t64).view(plane))
        if image_grad:
            g_image = _lerp_gather(dprob[:, None] * gp[:, :, None], (-f - 1).view(img_plane),
                                   (1 - t64).view(img_plane)).sum(dim=2).float()
    return g.float(), g_image


def k1_over_tol(logits, image, mode: str) -> dict:
    """K1 in ``mode`` against the plain head: {output: error over TOL}."""
    got = med_outputs_fused(logits, image, MIN_DISP, MAX_DISP, **MODES[mode])
    want = med_outputs(logits, image, MIN_DISP, MAX_DISP, **MODES[mode])
    return {name: over_tol(getattr(got, name), getattr(want, name), *TOL[name])
            for name in TOL if getattr(want, name) is not None}


def k2_over_tol(logits, image, g_disp, g_pan, mode: str) -> dict:
    """K2 in cotangent ``mode`` against :func:`exact_vjp`, and the fp32
    plain VJP against it: {"k2": worst error over GRAD_TOL of g_logits and
    g_image, "plain fp32": the same of the plain VJP}."""
    want_d, want_p, image_grad = GRAD_MODES[mode]
    gd, gp = (g_disp if want_d else None), (g_pan if want_p else None)
    exact = exact_vjp(logits, image, MIN_DISP, MAX_DISP, gd, gp, image_grad=image_grad)
    out = {}
    for name, got in (("k2", med_vjp_fused(logits, image, MIN_DISP, MAX_DISP, gd, gp, image_grad=image_grad)),
                      ("plain fp32", med_vjp(logits, image, MIN_DISP, MAX_DISP, gd, gp, image_grad=image_grad))):
        out[name] = max(over_tol(g, e, *GRAD_TOL) for g, e in zip(got, exact) if e is not None)
    return out


def check(scales=SCALES, kernels=("k1", "k2"), device="cuda", say=print) -> dict:
    """Each of ``kernels`` ("k1", "k2") at every shape, mode and form at
    each of ``scales``: returns {"k1": {"<scale> <form>": worst error over
    tolerance}, "k2": ..., "plain fp32": ... (with K2), "where": {...},
    "ok": bool} and says a line a (scale, form)."""
    dev = torch.device(device)
    names = [*kernels, *(("plain fp32",) if "k2" in kernels else ())]
    res = {name: {} for name in names}
    res["where"] = {}
    for scale in scales:
        for form in FORMS:
            key = f"{scale:g} {form}"
            worst = {name: (0.0, "") for name in names}
            for path, shape in SHAPES.items():
                if not any(path in PATHS[k] for k in kernels):
                    continue
                logits, image, g_disp, g_pan = scaled_inputs(shape, scale, form, dev)
                for mode in MODES if "k1" in kernels and path in PATHS["k1"] else ():
                    for name, err in k1_over_tol(logits, image, mode).items():
                        worst["k1"] = max(worst["k1"], (err, f"{path} {mode} {name}"))
                for mode in GRAD_MODES if "k2" in kernels and path in PATHS["k2"] else ():
                    for name, err in k2_over_tol(logits, image, g_disp, g_pan, mode).items():
                        worst[name] = max(worst[name], (err, f"{path} {mode}"))
                del logits, image, g_disp, g_pan
            for name, (err, where) in worst.items():
                res[name][key] = err
                res["where"][f"{name} {key}"] = where
            words = {"k1": "K1 worst {:.3f} of TOL ({})", "k2": "K2 worst {:.3f} of GRAD_TOL against the exact VJP ({})",
                     "plain fp32": "the fp32 plain VJP {:.3f} ({})"}
            say(f"  logits {key}: " + "; ".join(words[n].format(*worst[n]) for n in names))
    res["ok"] = all(v <= 1.0 for name in kernels for v in res[name].values())
    return res


def plans() -> dict:
    """Each path's staging plan, K1 with every output and K2 with every
    cotangent, in words."""
    say = {"k1": lambda n, c, w: describe_plan("med_fwd", n, c, w, disp=True, pan=True, subocc=True),
           "k2": lambda n, c, w: describe_plan("med_bwd", n, c, w, disp=True, pan=True, image_grad=True)}
    return {f"{k} {path}": say[k](SHAPES[path][1], SHAPES[path][4], SHAPES[path][3]) for k in PATHS for path in PATHS[k]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scales", type=float, nargs="+", default=list(SCALES))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("med_scales runs on the GPU; torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    import fal_net_torch

    print(f"{fal_net_torch.__file__} on {card}", flush=True)
    res = check(args.scales, say=lambda m: print(m, flush=True))
    print(json.dumps({"card": card, "plans": plans(), **res}), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

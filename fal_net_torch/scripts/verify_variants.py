"""FAL_netA and FAL_netC on the card: the counterpart of the JAX package's
scripts/verify_variants_tpu.py.

    python -m fal_net_torch.scripts.verify_variants [--no_train]

Per variant (A, then C), at its default plane count N = 33, from the
weights the JAX script draws (``PRNGKey(0)``; ``scripts/jax_init.py`` draws
them without JAX):

  * ``check_med_numerics``: K1 (csrc/med_fwd.cu) against the plain head at
    (1, N, 384, 1280), all four outputs of one disp+pan+subocc call, at the
    TPU kernel tests' tolerances; the staging plan printed;
  * ``check_variant``: ``create_model(v)``; the disp+pan+subocc forward at
    batch 1 must be finite with disp in [0, 300]; the disp+pan forward timed at batch 1 and 8 (CUDA events,
    median after warm-up); for A, a model with ``a_maskr_quirk=True`` on the
    same weights: maskR must differ from the default model's by more than
    1e-4, and disp, pan and maskL, which come from one K1 call in both, must
    be bit-identical; the quirk forward's time and peak device memory at
    batch 8 beside the default one's;
  * ``check_training`` (not with ``--no_train``): 400 stage-1 steps of the
    full-width variant at N = 33 on smooth synthetic stereo shifted by 6 px
    (64x128, batch 4, bounds 2..18, where 6.00 px is exactly level 16; Adam
    5e-4 with beta1 0.5, a_sm 0.2 x 2/512) through K1 and K2: the median
    disparity must land within half the local level spacing of 6.00 px, the
    loss must fall, and K1 must launch steps + 1 times and K2 steps times.
    The outcome depends on the weights drawn: at this learning rate
    FAL_netC's softmax saturates within about 50 steps and its disparity
    stays on the plane that leads then, which is 6.00 px from JAX's
    PRNGKey(0) but a neighbouring plane from most other draws.  From the
    same weights the port and JAX land on the same plane in four of five
    draws; from the fifth each of them, and JAX's two forms of the model,
    land on different planes: rounding alone can decide it
    (tests/convergence_draws.py, PERF.md §6).

Prints OK or FAIL for each check and ``VERIFY VARIANTS: PASS`` or ``FAIL``;
exits 1 on a failure.  ``main`` runs on the GPU and raises without one.  The
checks take their sizes and device as arguments, the JAX script's values by
default, so that a test can call them small (``check_training`` and
``check_variant`` without timing also on the CPU, where the model's MED head
is the plain one).
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from fal_net_torch.models import create_model
from fal_net_torch.scripts.jax_init import jax_init_state_dict
from fal_net_torch.ops import _build
from fal_net_torch.ops.med import disparity_levels, med_outputs
from fal_net_torch.ops.med_kernel import MedForward, describe_plan, med_outputs_fused
from fal_net_torch.ops.med_selfcheck import TOL as GATE_TOL
from fal_net_torch.utils.timing import median_ms

VARIANTS = ("A", "C")
MIN_DISP, MAX_DISP = 2.0, 300.0
ALL = dict(ret_disp=True, ret_pan=True, ret_subocc=True)
CHUNK = 50  # steps between the JAX script's loss readings
# (rtol, atol) of K1's outputs: the TPU kernel's own tests' (tests/test_med_pallas.py:34-37), as the gate's
TOL = {name: GATE_TOL[name] for name in ("disp", "pan", "maskL", "maskR")}


def _say(ok: bool, msg: str) -> None:
    print(f"  {'OK ' if ok else 'FAIL'} {msg}", flush=True)


_jax_init = functools.lru_cache(maxsize=2)(jax_init_state_dict)


def jax_seeded(variant: str, num_levels=None, device="cuda", **kw):
    """``create_model(variant, num_levels)`` with the weights JAX's model
    draws from ``PRNGKey(0)``, as the JAX script's ``model.init``."""
    model = create_model(variant, num_levels, device=device, **kw)
    sd = _jax_init(variant, model.num_levels, 0, str(device))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def check_med_numerics(n: int, b: int = 1, h: int = 384, w: int = 1280, device="cuda") -> dict:
    """K1 against the plain head at (b, n, h, w) on seeded inputs: disp,
    pan, maskL and maskR of one disp+pan+subocc call at TOL.  Returns
    {"ok", "errs": {output: max abs err}, "plan"}."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((b, n, h, w), np.float32)).to(dev)
    image = torch.from_numpy(rng.standard_normal((b, 3, h, w), np.float32)).to(dev)
    got = med_outputs_fused(logits, image, MIN_DISP, MAX_DISP, **ALL)
    want = med_outputs(logits, image, MIN_DISP, MAX_DISP, **ALL)
    plan = describe_plan("med_fwd", n, 3, w, disp=True, pan=True, subocc=True)
    print(f"  K1 plan at N={n}, W={w}, disp+pan+subocc: {plan}", flush=True)
    ok, errs = True, {}
    for name, (rtol, atol) in TOL.items():
        g, r = getattr(got, name), getattr(want, name)
        errs[name] = float((g - r).abs().max())
        good = bool(torch.allclose(g, r, rtol=rtol, atol=atol))
        ok &= good
        _say(good, f"N={n} {name:6s} maxdiff {errs[name]:.2e} (rtol {rtol:.0e}, atol {atol:.0e})")
    return {"ok": ok, "errs": errs, "plan": plan}


def _forward_ms(model, x, reps: int = 20) -> float:
    with torch.inference_mode():
        return median_ms(lambda: model(x, MIN_DISP, MAX_DISP, ret_disp=True, ret_pan=True), reps=reps)


def _peak(fn) -> tuple[float, float]:
    """(median ms of 5 calls, peak device GB of one call) of ``fn``."""
    ms = median_ms(fn, reps=5, warmup=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return ms, torch.cuda.max_memory_allocated() / 1e9


def check_quirk(model, x1, x8, timed: bool = True) -> dict:
    """FAL_netA's ``a_maskr_quirk`` against the default model on its
    weights: the disp+pan+subocc forward at batch 1 (``x1``); maskR differs
    by more than 1e-4, disp, pan and maskL bit-identical.  With ``timed``,
    both forwards at batch 8 (``x8``): ms and peak device GB."""
    quirk = create_model("A", model.num_levels, device=x1.device, a_maskr_quirk=True).eval()
    quirk.load_state_dict(model.state_dict())
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            base = model(x1, MIN_DISP, MAX_DISP, **ALL)
            k1 = MedForward.mode_launches.get("disp+pan+subocc", 0)
            got = quirk(x1, MIN_DISP, MAX_DISP, **ALL)
            if x1.is_cuda:
                torch.cuda.synchronize()
            k1 = MedForward.mode_launches.get("disp+pan+subocc", 0) - k1
    finally:
        torch.backends.cudnn.deterministic = saved
    mask_diff = float((got.maskR - base.maskR).abs().max())
    same = {f: bool(torch.equal(getattr(got, f), getattr(base, f))) for f in ("disp", "pan", "maskL")}
    ok = bool(torch.isfinite(got.maskR).all()) and mask_diff > 1e-4 and all(same.values())
    ok &= k1 == (1 if x1.is_cuda else 0)
    _say(ok, f"a_maskr_quirk: maskR differs (max {mask_diff:.3f}); bit-identical {same}; K1 launches {k1}")
    res = {"ok": ok, "mask_diff": mask_diff, "k1": k1}
    if timed:
        with torch.inference_mode():
            for name, m in (("default", model), ("quirk", quirk)):
                res[name] = _peak(lambda: m(x8, MIN_DISP, MAX_DISP, **ALL))
        print(f"  disp+pan+subocc forward B={x8.shape[0]} {x8.shape[2]}x{x8.shape[3]}: default "
              f"{res['default'][0]:.3f} ms, peak {res['default'][1]:.2f} GB; quirk {res['quirk'][0]:.3f} ms, "
              f"peak {res['quirk'][1]:.2f} GB", flush=True)
    return res


def check_variant(variant: str, h: int = 384, w: int = 1280, batches=(1, 8), device="cuda",
                  timed: bool = True) -> dict:
    """The variant at its default N with JAX's weights of ``PRNGKey(0)``:
    the disp+pan+subocc forward at batch 1 finite, disp in [0, 300]; with
    ``timed`` the disp+pan forward at each of ``batches`` (CUDA events); for
    A the quirk check (:func:`check_quirk`) at batch 1 and, timed, the
    largest batch."""
    dev = torch.device(device)
    model = jax_seeded(variant, device=dev).eval()
    rng = np.random.default_rng(1)
    xs = {b: torch.from_numpy(rng.standard_normal((b, 3, h, w), np.float32) * 0.2).to(dev) for b in batches}
    with torch.inference_mode():
        out = model(xs[1], MIN_DISP, MAX_DISP, **ALL)
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    in_range = bool((out.disp >= 0).all() and (out.disp <= MAX_DISP + 1e-3).all())
    ok = finite and in_range
    _say(ok, f"FAL_net{variant} N={model.num_levels} forward finite + disp in range (disp mean "
         f"{float(out.disp.mean()):.2f})")
    res = {"ok": ok, "num_levels": model.num_levels, "ms": {}}
    if timed:
        for b, x in xs.items():
            res["ms"][b] = _forward_ms(model, x)
            print(f"  fwd {h}x{w} b{b} {res['ms'][b]:7.3f} ms  ({1000 * b / res['ms'][b]:6.1f} imgs/s)", flush=True)
    if variant == "A":
        res["quirk"] = check_quirk(model, xs[1], xs[max(batches)], timed=timed)
        res["ok"] &= res["quirk"]["ok"]
    return res


def synthetic_stereo(disp_px: int = 6, h: int = 64, w: int = 128, b: int = 4):
    """The JAX scripts' smooth seeded stereo: a cubic zoom of coarse noise,
    left and right ``disp_px`` columns apart, centred at 0; NCHW numpy."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(0)
    coarse = rng.random((b, h // 8 + 2, (w + disp_px) // 8 + 2, 3)).astype(np.float32)
    wide = np.stack([ndi.zoom(c, (8, 8, 1), order=3)[:h, : w + disp_px] for c in coarse]) - 0.5
    nchw = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))
    return nchw(wide[:, :, :w]), nchw(wide[:, :, disp_px:])


def check_training(variant: str, steps: int = 400, h: int = 64, w: int = 128, b: int = 4, n: int = 33,
                   device="cuda", model=None) -> dict:
    """Stage-1 convergence through the full-width variant's forward and
    backward at N = ``n`` (see the module docstring), from JAX's weights of
    ``PRNGKey(0)`` unless ``model`` (the variant at N = ``n`` on ``device``)
    is given.  The first loss is the one at the end of the first CHUNK
    steps, as the JAX script reads it.  Returns {"ok", "first", "last",
    "median", "spacing", "launches", "seconds", "model"}."""
    from fal_net_torch.train.stages import stage1_loss

    dev = torch.device(device)
    disp_px, mn, mx = 6, 2.0, 18.0
    left, right = (torch.from_numpy(a).to(dev) for a in synthetic_stereo(disp_px, h, w, b))
    batch = {"left": left, "right": right}
    model = jax_seeded(variant, n, device=dev) if model is None else model
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.5, 0.999))
    _build.reset_launch_counts()
    first = None
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        opt.zero_grad(set_to_none=True)
        loss, _ = stage1_loss(model, batch, min_disp=mn, max_disp=mx, a_p=0.0, a_sm=0.2 * 2 / 512)
        loss.backward()
        opt.step()
        if step % CHUNK == 0 or step == steps:
            last = loss.item()
            first = last if first is None else first
            print(f"  step {step}: loss {last:.4f}", flush=True)
    with torch.no_grad():
        med = float(model(left, mn, mx).disp.median())
    secs = time.perf_counter() - t0
    levels = disparity_levels(mn, mx, n).numpy()
    target = int(np.argmin(np.abs(levels - disp_px)))
    spacing = float(levels[target + 1] - levels[target])  # the local spacing at the target
    launches = (MedForward.launches, MedForward.bwd_launches)
    want = (steps + 1, steps) if dev.type == "cuda" else (0, 0)
    ok = abs(med - disp_px) < spacing / 2 and last < first and launches == want
    _say(ok, f"train FAL_net{variant} N={n}: median disp {med:.3f} (target {disp_px}, level {target}, spacing "
         f"{spacing:.3f}), loss {first:.4f} -> {last:.4f}, K1 {launches[0]} K2 {launches[1]} launches (want "
         f"{want[0]}, {want[1]}), {secs:.1f} s")
    return {"ok": ok, "first": first, "last": last, "median": med, "spacing": spacing, "launches": launches,
            "seconds": secs, "model": model}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no_train", action="store_true", help="skip the convergence runs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("verify_variants runs on the GPU; torch.cuda.is_available() is False")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    ok = True
    for variant in VARIANTS:
        print(f"--- FAL_net{variant} ---", flush=True)
        res = check_variant(variant)
        med = check_med_numerics(res["num_levels"])
        ok &= res["ok"] and med["ok"]
        if not args.no_train:
            ok &= check_training(variant)["ok"]
    print("VERIFY VARIANTS:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

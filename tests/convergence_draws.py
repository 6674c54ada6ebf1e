"""FAL_netC's convergence run from several initial draws: whether the plane
it lands on follows the draw or the framework.

    python tests/convergence_draws.py                  # JAX and the port, on the CPU
    python tests/convergence_draws.py --draw "port seed 0"    # one draw
    python tests/convergence_draws.py --device cuda    # the port alone, more draws

The run is ``verify_variants``' ``check_training``: 400 stage-1 steps at
N = 33 on the JAX scripts' smooth 6 px stereo (64x128, batch 4, bounds
2..18, where 6.00 px is level 16; Adam 5e-4 with beta1 0.5, a_sm 0.2 x
2/512).  The draws are JAX's init from ``PRNGKey(k)`` (k = 0 is
scripts/verify_variants_tpu.py's) and the port's seeded Kaiming draw
(``create_model`` with a ``torch.Generator`` seeded s).

On the CPU (k = 0, 1, 2; s = 0, 1) each draw runs in both frameworks from
the same weights, JAX's draws made by JAX's own init: in JAX the training of
scripts/verify_variants_tpu.py's ``check_training`` (its loss and optax's
Adam, one jitted step at a time, on the JAX model in plain form: the same
function, twice as fast on the CPU), in the port
``fal_net_torch.scripts.verify_variants.check_training``; the weights cross
by ``models/jax_import.py::state_dict_from_jax`` and
``fal_net_tpu.models.torch_import.convert_state_dict``.  Where the two land
on different planes, JAX runs once more on the JAX script's own model
(``create_model(variant, n)`` with its TPU layout rewrites: the same
function rounded otherwise), to show how far rounding alone moves the
outcome.  On 8 cores a draw takes 3 to 14 minutes in the port, about 8 in
JAX's plain form and 15 in its script's form.  With ``--device cuda``
the port alone runs k = 0..9 and s = 0..9 on the card, JAX's draws made by
``scripts/jax_init.py`` (no JAX; about 6 s a draw).

Prints per run the median disparity, its nearest level, the losses at step
50 and at the end, the logits' standard deviation on the batch before and
after and the mean largest softmax probability after (1 is a saturated
softmax, whose disparity no longer moves), then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from fal_net_torch.models import create_model  # noqa: E402
from fal_net_torch.models.jax_import import state_dict_from_jax  # noqa: E402
from fal_net_torch.ops.med import disparity_levels  # noqa: E402
from fal_net_torch.scripts.jax_init import jax_init_state_dict  # noqa: E402
from fal_net_torch.scripts.verify_variants import CHUNK, check_training, synthetic_stereo  # noqa: E402
from fal_net_torch.utils.device import resolve_device  # noqa: E402

VARIANT, N, DISP_PX, MIN_D, MAX_D, STEPS = "C", 33, 6, 2.0, 18.0, 400
LEVELS = disparity_levels(MIN_D, MAX_D, N).numpy()


def nhwc(a: np.ndarray):
    import jax.numpy as jnp

    return jnp.asarray(a.transpose(0, 2, 3, 1))


def jax_model(plain: bool = True):
    """The JAX model in plain form (no TPU layout rewrites, the MED head
    plain), or with ``plain=False`` the JAX script's own: the same
    function, rounded otherwise."""
    from fal_net_tpu.models import create_model as jax_create_model

    if not plain:
        return jax_create_model(VARIANT, N)
    return jax_create_model(VARIANT, N, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
                            stem_flow_analytic=False, fuse_logits=False, phase_deconv=False)


def jax_run(state_dict, steps: int, plain: bool = True) -> dict:
    """scripts/verify_variants_tpu.py's training from ``state_dict``: the
    same loss, optimizer and steps, one jitted step at a time (a scan of 50
    steps runs many times slower on the CPU)."""
    import jax
    import jax.numpy as jnp
    import optax

    from fal_net_tpu.models.torch_import import convert_state_dict
    from fal_net_tpu.train.stages import stage1_loss

    left, right = (nhwc(a) for a in synthetic_stereo(DISP_PX))
    model = jax_model(plain)
    params = {"params": convert_state_dict(state_dict)}
    tx = optax.adam(5e-4, b1=0.5)
    opt_state = tx.init(params)

    @jax.jit
    def one_step(params, opt_state):
        def loss_fn(p):
            return stage1_loss(p, {"left": left, "right": right}, model.apply, min_disp=MIN_D, max_disp=MAX_D,
                               a_p=0.0, a_sm=0.2 * 2 / 512, vgg_fn=None)

        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    t0 = time.perf_counter()
    losses = []
    for step in range(1, steps + 1):
        params, opt_state, loss = one_step(params, opt_state)
        if step % CHUNK == 0 or step == steps:
            losses.append(float(loss))
    disp = model.apply(params, left, MIN_D, MAX_D, ret_disp=True).disp
    return {"median": float(jnp.median(disp)), "first": losses[0], "last": losses[-1],
            "seconds": time.perf_counter() - t0, "state_dict": state_dict_from_jax(params["params"], VARIANT)}


def jax_own_init(key: int) -> dict:
    """JAX's init of the plain-form model from ``PRNGKey(key)``, as the
    port's state_dict."""
    import jax

    variables = jax_model().init(jax.random.PRNGKey(key), nhwc(synthetic_stereo(DISP_PX)[0]), MIN_D, MAX_D,
                                       ret_disp=True)
    return state_dict_from_jax(variables["params"], VARIANT)


def port_model(state_dict, device):
    model = create_model(VARIANT, N, device=device)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()})
    return model


def logits_stats(model, left) -> tuple[float, float]:
    """(std of the logits, mean largest softmax probability) on ``left``."""
    with torch.no_grad():
        logits = model.logits(left, MAX_D)
    return float(logits.std()), float(torch.softmax(logits, dim=1).amax(dim=1).mean())


def summary(res: dict, std0: float, after) -> dict:
    std1, pmax = after
    return {"median_px": res["median"], "level": int(np.argmin(np.abs(LEVELS - res["median"]))),
            "loss_50": res["first"], "loss_last": res["last"], "logits_std": [std0, std1], "max_prob_after": pmax,
            "seconds": res["seconds"]}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu", help="cpu: JAX and the port; cuda: the port alone")
    parser.add_argument("--draw", action="append", help="run only this draw (by its printed name); repeatable")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    with_jax = dev.type == "cpu"
    keys, seeds = (range(3), range(2)) if with_jax else (range(10), range(10))
    left = torch.from_numpy(synthetic_stereo(DISP_PX)[0]).to(dev)
    draws = {}
    for key in keys:
        draws[f"jax PRNGKey({key})"] = jax_own_init(key) if with_jax else jax_init_state_dict(VARIANT, N, key)
    for seed in seeds:
        model = create_model(VARIANT, N, generator=torch.Generator().manual_seed(seed), device="cpu")
        draws[f"port seed {seed}"] = {k: v.numpy() for k, v in model.state_dict().items()}
    name_dev = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"device": name_dev, "variant": VARIANT, "steps": STEPS, "runs": {}}
    for name, sd in draws.items():
        if args.draw and name not in args.draw:
            continue
        model = port_model(sd, dev)
        std0, _ = logits_stats(model, left)
        res = check_training(VARIANT, steps=STEPS, device=dev, model=model)
        runs = {"port": summary(res, std0, logits_stats(model, left))}
        if with_jax:
            res = jax_run(sd, STEPS)
            runs["jax"] = summary(res, std0, logits_stats(port_model(res["state_dict"], dev), left))
            if runs["jax"]["level"] != runs["port"]["level"]:
                res = jax_run(sd, STEPS, plain=False)
                runs["jax script form"] = summary(res, std0, logits_stats(port_model(res["state_dict"], dev), left))
        result["runs"][name] = runs
        print(f"{name}: " + "; ".join(f"{fw} {r['median_px']:.4f} px (level {r['level']}), loss {r['loss_50']:.4f} "
                                      f"-> {r['loss_last']:.4f}" for fw, r in runs.items()), flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

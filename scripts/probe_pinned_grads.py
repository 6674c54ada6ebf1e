"""Probe: the backbone's activation pins (models/backbone.py::_constrain)
against the same stage-1 step without them, on data x spatial meshes of
virtual CPU devices.

    python scripts/probe_pinned_grads.py            # meshes 1x2 2x1 2x2 1x4 4x2
    python scripts/probe_pinned_grads.py --mesh 2x2

For each mesh: the tiny model (N=5) from one seeded init, a seeded batch of
4 stereo pairs at 32x64 placed as the Trainer places it (batch over
'data', rows over 'spatial'), and ``jax.value_and_grad`` of
train/stages.py::stage1_loss (a_p 0) jitted twice: through the model as the
Trainer builds it on that mesh (``med_mesh=mesh``, so ``_constrain`` pins
every stage boundary and the MED head runs per device under shard_map) and
through the same model with ``med_mesh=None`` (no pins; XLA's partitioner
places every activation itself), both with the plain MED head
(``med_impl='reference'``) so that only the pins differ; and once more with
no mesh at all.  Printed per mesh: the three losses and, for each pair of
the three, the parameter whose gradient differs most, by its largest
difference in units of that gradient's largest magnitude.  The three are
the same sums up to fp32 reassociation, so every reading should be ~1e-5 or
below; a reading near 1 is a gradient of another value.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fal_net_tpu.models import create_model  # noqa: E402
from fal_net_tpu.parallel.spatial import image_sharding, make_2d_mesh, replicated  # noqa: E402
from fal_net_tpu.train.stages import stage1_loss  # noqa: E402

N, B, H, W = 5, 4, 32, 64
MN, MX = 2.0, 30.0


def _batch(seed: int = 0):
    g = np.random.default_rng(seed)
    left = (g.standard_normal((B, H, W, 3)) * 0.3).astype(np.float32)
    right = (np.roll(left, -4, axis=2) + g.standard_normal(left.shape) * 0.05).astype(np.float32)
    return {"left": left, "right": right}


def _grads(model, params, batch):
    loss = lambda p, b: stage1_loss(p, b, model.apply, min_disp=MN, max_disp=MX, a_p=0.0, a_sm=1.0)
    (value, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch)
    return float(value), jax.tree_util.tree_map(np.asarray, jax.device_get(grads))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _units(got, want):
    """Each gradient's largest difference over its largest magnitude."""
    g, w = _flat(got), _flat(want)
    return {k: float(np.abs(g[k] - w[k]).max() / (np.abs(w[k]).max() + 1e-30)) for k in w}


def probe(data: int, spatial: int, params, host_batch) -> dict:
    mesh = make_2d_mesh(data, spatial)
    batch = jax.device_put({k: jnp.asarray(v) for k, v in host_batch.items()}, image_sharding(mesh))
    placed = jax.device_put(params, replicated(mesh))
    pinned = create_model("tiny", N, med_impl="reference", med_mesh=mesh,
                          med_spatial_axis="spatial" if spatial > 1 else None)
    free = create_model("tiny", N, med_impl="reference")
    loss_p, g_p = _grads(pinned, placed, batch)
    loss_f, g_f = _grads(free, placed, batch)
    loss_1, g_1 = _grads(free, params, {k: jnp.asarray(v) for k, v in host_batch.items()})
    return {"loss": (loss_p, loss_f, loss_1), "pinned vs unpinned": _units(g_p, g_f),
            "unpinned vs one device": _units(g_f, g_1), "pinned vs one device": _units(g_p, g_1)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", nargs="*", default=["1x2", "2x1", "2x2", "1x4", "4x2"], help="data x spatial")
    args = p.parse_args(argv)
    model = create_model("tiny", N, med_impl="reference")
    params = jax.jit(lambda k, x: model.init(k, x, MN, MX, ret_disp=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
    host_batch = _batch()
    out = {}
    for m in args.mesh:
        d, s = (int(v) for v in m.split("x"))
        r = out[m] = probe(d, s, params, host_batch)
        worst = {pair: max(u.items(), key=lambda kv: kv[1]) for pair, u in r.items() if pair != "loss"}
        print(f"mesh {m}: loss pinned {r['loss'][0]:.7f} unpinned {r['loss'][1]:.7f} one device "
              f"{r['loss'][2]:.7f}; worst gradient |diff| / max|g|: "
              + "; ".join(f"{pair} {v:.3e} ({k})" for pair, (k, v) in worst.items()), flush=True)
    return out


if __name__ == "__main__":
    main()

"""The JAX package's initial weights of a FAL-net variant, drawn without JAX:
what ``fal_net_tpu.models.create_model(variant, n).init(PRNGKey(seed), ...)``
draws, as the port's state_dict.

flax gives each parameter the key ``fold_in(PRNGKey(seed), h)``, ``h`` the
first four bytes (big-endian) of the SHA-1 of the parameter's module path
and its count among that module's parameters (flax.core.scope's
``_fold_in_static``).  A conv kernel (HWIO) is ``normal(key) * sqrt(2 /
fan_in)`` (``variance_scaling(2.0, "fan_in", "normal")``, the reference's
Kaiming init; fan_in = kh * kw * in), a bias zeros.  ``normal`` is JAX's
with partitionable threefry bits (``jax_threefry_partitionable``, JAX's
default): threefry2x32 of the key over a 64-bit iota, the two words xored,
the top 23 bits a float in [1, 2), scaled to (-1, 1), then sqrt(2) erfinv.
The erfinv here is torch's in float64, so values agree with JAX's to a few
ulps.

It lets a run on the card start from the very weights that a JAX script
starts from (``fal_net_torch/scripts/verify_variants.py::check_training``)
without JAX.  The 32-bit words live in int64 tensors (torch has no
wrapping uint32 arithmetic), masked after each add and shift.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

from fal_net_torch.models.backbone import VARIANTS
from fal_net_torch.models.jax_import import state_dict_from_jax

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as jax.random's:
    ``key`` a pair of 32-bit ints, ``x0`` and ``x1`` int64 tensors of
    32-bit words."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: int):
    """jax.random.fold_in on a raw threefry key."""
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64), torch.tensor([data], dtype=torch.int64))
    return int(y0), int(y1)


def normal(key, shape, device="cpu") -> np.ndarray:
    """jax.random.normal(key, shape) in float32, drawn on ``device``."""
    size = int(np.prod(shape))  # below 2^32, so the iota's upper words are 0
    iota = torch.arange(size, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, torch.zeros_like(iota), iota)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000  # below 2^31: an int32 holds it
    lo = torch.tensor(np.nextafter(np.float32(-1), np.float32(0)), device=device)
    u = torch.maximum(lo, (bits.to(torch.int32).view(torch.float32) - 1) * (1 - lo) + lo)
    return (np.sqrt(2) * torch.erfinv(u.double())).float().reshape(shape).cpu().numpy()


def _path_key(root, path) -> tuple:
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def jax_init_state_dict(variant: str, num_levels: int, seed: int = 0, device="cpu") -> Dict[str, np.ndarray]:
    """The port's state_dict (numpy) of the weights JAX's model of
    ``variant`` at ``num_levels`` planes draws from ``PRNGKey(seed)``,
    the random words made on ``device``."""
    spec = VARIANTS[variant]
    root = (seed >> 32, seed & _M32)

    def kernel(path, count, shape):
        fan_in = int(np.prod(shape[:-1]))
        return normal(_path_key(root, (*path, count)), shape, device) * np.float32(np.sqrt(2.0 / fan_in))

    def conv(path, kh, kw, cin, cout, bias=True):
        leaf = {"kernel": kernel(path, 1, (kh, kw, cin, cout))}
        if bias:
            leaf["bias"] = np.zeros(cout, np.float32)
        return leaf

    bb = {"conv0": {"conv": conv(("backbone", "conv0", "conv"), 3, 3, 3, 32)}}
    (kh, kw), (kh2, kw2) = ((3, 1), (1, 3)) if spec.separable_residual else ((3, 3), (3, 3))

    def residual(name, ch):
        bb[name] = {"conv1": conv(("backbone", name, "conv1"), kh, kw, ch, ch, bias=False),
                    "conv2": conv(("backbone", name, "conv2"), kh2, kw2, ch, ch, bias=False)}

    residual("rb0", 32)
    cin = 33
    for i, ch in enumerate(spec.enc, start=1):
        bb[f"conv{i}"] = {"conv": conv(("backbone", f"conv{i}", "conv"), 3, 3, cin, ch)}
        residual(f"rb{i}", ch)
        cin = ch
    skips = (32,) + spec.enc  # x0..x6
    y = spec.enc[5]
    for j, (dch, ich) in enumerate(zip(spec.deconv, spec.iconv + (None,))):
        level = 6 - j
        bb[f"deconv{level}"] = {"conv": conv(("backbone", f"deconv{level}", "conv"), 3, 3, y, dch, bias=False)}
        if ich is None:
            break
        bb[f"iconv{level}"] = {"conv": conv(("backbone", f"iconv{level}", "conv"), 3, 3, dch + skips[level - 1], ich)}
        y = ich
    bb["iconv1"] = conv(("backbone", "iconv1"), 3, 3, spec.deconv[5] + 32, num_levels, bias=False)
    if spec.has_amask:  # parameters of the backbone module itself: counts 1, 2 (the bias) and 3
        c = spec.deconv[5] + 32
        bb["amask_conv1_kernel"] = kernel(("backbone",), 1, (3, 3, c, c // 2))
        bb["amask_conv1_bias"] = np.zeros(c // 2, np.float32)
        bb["amask_conv2_kernel"] = kernel(("backbone",), 3, (3, 3, c // 2, 1))
    params = {"backbone": bb, "logits_1x1": conv(("logits_1x1",), 1, 1, num_levels, num_levels)}
    return state_dict_from_jax(params, variant)

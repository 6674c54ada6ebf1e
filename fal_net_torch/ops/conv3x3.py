"""The K-packed 3x3 convolutions K3 and K4, their weight layouts and their
plain versions.  Both launch one kernel, ``csrc/conv3x3_wgmma.cu``: TF32
``wgmma`` on NCHW fp32.

K3 replaces scripts/proto_conv_kernel.py::_kernel and K4
scripts/proto_conv_kernel_v2.py::_kernel: a 3x3, stride-1, zero-padded
("same") convolution without bias on NCHW fp32,

    out[b, co, y, x] = sum_k W2[co, k] * patch[b, k, y, x],
    patch[b, (dy, dx, ci), y, x] = in[b, ci, y + dy - 1, x + dx - 1]   (0 outside),

K3 from the packed weights ``repack_weights(w)`` (Cout, 9*Cin) and K4 from
the phase-permuted ``permuted_weights(w)`` (3, Cout, 9*Cin), where output
row r uses variant r mod 3.  Variant 0 maps slot s to dy = s, so
``permuted_weights(w)[0] == repack_weights(w)`` and K4 hands the kernel
``w3[0]``.  Both layouts are made from the torch OIHW weight (Cout, Cin, 3,
3); the JAX scripts make them from HWIO.  Any H and W are taken (the TPU
kernels' H % 8 == 0 is a TPU tiling rule).

The kernel truncates both operands to TF32 and sums in fp32:
``conv3x3_tf32_plain`` is that function, ``tf32_round`` its rounding.  The
fp32 plain versions (``conv3x3_packed_plain``, ``conv3x3_v2_plain``) build
the patch tensor step by step, as the TPU kernels do.  The wrappers take
CUDA fp32 contiguous tensors and raise on anything else, the CPU included;
both launch through the op ``fal_net_torch::conv3x3`` (CUDA impl in
csrc/torch_ops.cpp), whose C entry owns the size limits; the op raises when
it refuses.  ``LAUNCHES`` reads the op's launch count (K3's and K4's
together: one kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fal_net_torch.ops._build import LaunchCounts, load_library

LAUNCHES = LaunchCounts(("conv3x3",))


def repack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> (Cout, 9*Cin) with K order (dy, dx, ci)."""
    co, ci, kh, kw = w.shape
    return w.permute(0, 2, 3, 1).reshape(co, kh * kw * ci).contiguous()


def permuted_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> (3, Cout, 9*Cin): variant p maps K row-group
    slot s to dy = (s - p) mod 3, inner order (dx, ci)."""
    co, ci = w.shape[:2]
    w2 = repack_weights(w).reshape(co, 3, 3 * ci)
    return torch.stack([
        torch.cat([w2[:, (s - p) % 3] for s in range(3)], dim=1) for p in range(3)
    ]).contiguous()


def _row_taps(x: torch.Tensor) -> torch.Tensor:
    """(B, 3*Cin, H+2, W): for each padded input row, its three dx-shifted
    copies, order (dx, ci)."""
    w = x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.cat([xp[..., dx : dx + w] for dx in range(3)], dim=1)


def conv3x3_packed_plain(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K3's function: the (B, 9*Cin, H, W) patch tensor, K order (dy, dx, ci),
    contracted with ``w2`` (Cout, 9*Cin)."""
    h = x.shape[2]
    taps = _row_taps(x)
    patches = torch.cat([taps[:, :, dy : dy + h] for dy in range(3)], dim=1)
    return torch.einsum("ok,bkhw->bohw", w2, patches)


def conv3x3_v2_plain(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """K4's function: row-group slot s holds padded input row g with
    g mod 3 == s, and output row r contracts the three slots with
    ``w3[r mod 3]``."""
    b, _, h, w = x.shape
    taps = _row_taps(x)
    r = torch.arange(h, device=x.device)
    slots = torch.cat([taps[:, :, r + (s - r) % 3] for s in range(3)], dim=1)
    out = x.new_empty((b, w3.shape[1], h, w))
    for p in range(3):
        out[:, :, p::3] = torch.einsum("ok,bkhw->bohw", w3[p], slots[:, :, p::3])
    return out


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` truncated to TF32 as the tensor cores read it: the low 13
    mantissa bits cleared (toward zero; inf stays inf)."""
    return (t.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def conv3x3_tf32_plain(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """What the kernel computes: K3's conv on TF32-truncated operands, summed
    in fp32.  The products are exact in fp32, so only the order of the sums
    differs from the kernel's.  Call it with TF32 matmuls off."""
    return conv3x3_packed_plain(tf32_round(x), tf32_round(w2))


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take; return (B, Cin, H, W, Cout).
    ``name`` is "w2" (Cout, 9*Cin) or "w3" (3, Cout, 9*Cin)."""
    for label, t in (("x", x), (name, w)):
        if not t.is_cuda:
            raise ValueError(f"the conv kernels need CUDA tensors; {label} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the conv kernels take float32; {label} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but {name} on {w.device}")
    if x.ndim != 4 or w.ndim != (2 if name == "w2" else 3):
        raise ValueError(f"x must be NCHW and {name} {2 if name == 'w2' else 3}-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, cin, h, wd = x.shape
    cout = w.shape[-2]
    want = (cout, 9 * cin) if name == "w2" else (3, cout, 9 * cin)
    if tuple(w.shape) != want:
        raise ValueError(f"{name} must have shape {want} for x {tuple(x.shape)}, got {tuple(w.shape)}")
    return b, cin, h, wd, cout


def _run(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w, "w2" if name == "conv3x3_packed" else "w3")
    w2 = w if w.ndim == 2 else w[0]  # variant 0 of permuted_weights is repack_weights
    load_library()
    return torch.ops.fal_net_torch.conv3x3.default(x, w2)


def conv3x3_packed(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K3: the 3x3 same conv of NCHW ``x`` with ``repack_weights`` output
    ``w2``, in TF32.  Launches on the current stream and does not synchronize."""
    return _run("conv3x3_packed", x, w2)


def conv3x3_v2(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """K4: the same conv from ``permuted_weights`` output ``w3``; the kernel
    reads its variant 0."""
    return _run("conv3x3_v2", x, w3)

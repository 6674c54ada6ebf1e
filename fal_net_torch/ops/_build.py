"""Build the port's CUDA sources with nvcc and load them with ctypes.

At first use, each ``fal_net_torch/csrc/*.cu`` is compiled for sm_90a by
its own nvcc, all started together, and the objects are linked into one
shared library with a plain C interface, under ``fal_net_torch/_build/``
(git-ignored; ``$FAL_NET_TORCH_BUILD_DIR`` overrides it, for an installed
package whose directory is read-only), named by a hash of the sources,
their headers (``*.cuh``) and the flags, so that a changed source rebuilds
and an unchanged one loads at once.  A missing ``nvcc`` or a failed build
raises :class:`BuildError` with the compiler's output; no caller falls back
to a plain version instead.  :func:`launch` calls a C entry on the current
stream.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")  # unless $FAL_NET_TORCH_BUILD_DIR names another
BUILD_DIR_ENV = "FAL_NET_TORCH_BUILD_DIR"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """nvcc is missing or the CUDA sources did not compile."""


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        DEFAULT_NVCC,
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildError(
        "nvcc not found (looked at $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of fal_net_torch are built "
        "from source at first use and need the CUDA toolkit"
    )


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build_dir() -> str:
    return os.environ.get(BUILD_DIR_ENV) or BUILD_DIR


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):  # sources and headers
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"fal_net_torch_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    return log


def build() -> tuple[str, str]:
    """Compile the sources unless the hashed library exists.

    Returns (library path, compiler output; empty if nothing was compiled).
    """
    out = library_path()
    if os.path.isfile(out):
        return out, ""
    nvcc = find_nvcc()
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(_sources(), objs)]
    try:
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        logs.append(_run([nvcc, "-shared", "-o", f"{tmp}.tmp", *objs]))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    log = "".join(logs)
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.tmp", out)  # atomic: a concurrent build never loads a partial file
    return out, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry's signature."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.med_fwd, lib.med_bwd):
        fn.argtypes = [p] * 7 + [i] * 10 + [p]
    lib.conv3x3_wgmma.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.roll_window.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.med_fwd_plan.argtypes = [i] * 7 + [p]
    lib.med_bwd_plan.argtypes = [i] * 7 + [p]
    for fn in (lib.med_fwd, lib.med_bwd, lib.conv3x3_wgmma, lib.roll_window, lib.med_fwd_plan, lib.med_bwd_plan):
        fn.restype = i
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry ``name`` with ``args`` and the current stream of
    ``device``, on that device; raise if it returns a CUDA error.  Every C
    entry returns cudaErrorInvalidValue (1), launching nothing, for sizes
    its kernel does not take."""
    with torch.cuda.device(device):  # the runtime launches on the current device
        err = getattr(load_library(), name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == 1:
        raise ValueError(f"{name}: sizes beyond the kernel's limits (cudaErrorInvalidValue)")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")

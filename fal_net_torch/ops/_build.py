"""Build the port's CUDA sources with nvcc and load them with ctypes.

At first use, ``fal_net_torch/csrc/*.cu`` is compiled for sm_90a into one
shared library with a plain C interface, under ``fal_net_torch/_build/``
(git-ignored), named by a hash of the sources and flags so that a changed
source rebuilds and an unchanged one loads at once.  A missing ``nvcc`` or
a failed build raises :class:`BuildError` with the compiler's output; no
caller falls back to a plain version instead.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"fal_net_torch_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the sources unless the hashed library exists.

    Returns (library path, compiler output; empty if nothing was compiled).
    """
    out = library_path()
    if os.path.isfile(out):
        return out, ""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry's signature."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.med_fwd.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.med_fwd.restype = i
    return lib

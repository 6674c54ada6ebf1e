"""Build the port's CUDA kernels and their PyTorch bindings, and load them.

At first use, each ``fal_net_torch/csrc/*.cu`` is compiled for sm_90a by
its own nvcc and the ops' binding, ``csrc/torch_ops.cpp``, by the host
compiler against PyTorch's headers, all started together; the objects are
linked into one shared library under ``fal_net_torch/_build/``
(git-ignored; ``$FAL_NET_TORCH_BUILD_DIR`` overrides it, for an installed
package whose directory is read-only), named by a hash of the sources,
their headers (``*.cuh``), the flags and the PyTorch version, so that a
changed source or another PyTorch rebuilds and an unchanged tree loads at
once.  A missing compiler or a failed build raises :class:`BuildError`
with the compiler's output; no caller falls back to a plain version
instead.

:func:`load_library` loads the library into PyTorch
(``torch.ops.load_library``), which registers the CUDA impls of the ops
that :mod:`fal_net_torch.ops.library` defines: every kernel launches
through the dispatcher.  The same library answers, through ctypes, the
host-only queries: the MED kernels' staging plans and the launch counts.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Mapping
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
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}")
TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
TORCH_LIBS = ("c10", "c10_cuda", "torch", "torch_cpu", "torch_cuda")
# the launch counters of csrc/torch_ops.cpp, in its order: K1 by mode
# (disp | pan << 1 | subocc << 2, minus one), K2, the conv (K3, K4), the roll (K5)
K1_MODES = ("disp", "pan", "disp+pan", "subocc", "disp+subocc", "pan+subocc", "disp+pan+subocc")
COUNTERS = (*(f"med_fwd:{m}" for m in K1_MODES), "med_bwd", "conv3x3", "roll_window")


class BuildError(RuntimeError):
    """A compiler is missing or the sources did not compile."""


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


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildError("no host C++ compiler ($CXX, g++ or c++) for the ops' binding csrc/torch_ops.cpp")


def _sources(ext: str) -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, f"*.{ext}")))
    if not srcs:
        raise BuildError(f"no *.{ext} sources under {CSRC_DIR}")
    return srcs


def build_dir() -> str:
    return os.environ.get(BUILD_DIR_ENV) or BUILD_DIR


def library_path() -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *CXX_FLAGS, torch.__version__)).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.c*"))):  # .cu, .cuh and .cpp
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"fal_net_torch_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> tuple[str, float]:
    """(compiler output, seconds); raises BuildError on failure."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise BuildError(f"{os.path.basename(cmd[0])} failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    return log, time.perf_counter() - t0


def build() -> tuple[str, str, dict]:
    """Compile the sources unless the hashed library exists.

    Returns (library path, compiler output, seconds per source and for the
    link); the output is empty and the seconds {} if nothing was compiled.
    """
    out = library_path()
    if os.path.isfile(out):
        return out, "", {}
    nvcc = find_nvcc()
    cxx = find_cxx()
    cuda_include = os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(nvcc))), "include")
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    srcs = _sources("cu") + _sources("cpp")
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    cmds = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] if src.endswith(".cu")
        else [cxx, *CXX_FLAGS, "-I", os.path.join(TORCH_DIR, "include"), "-I", cuda_include, "-c", "-o", obj, src]
        for src, obj in zip(srcs, objs)
    ]
    lib_dir = os.path.join(TORCH_DIR, "lib")
    link = [nvcc, "-shared", "-o", f"{tmp}.tmp", *objs, "-L", lib_dir, *(f"-l{name}" for name in TORCH_LIBS),
            "-Xlinker", "-rpath", "-Xlinker", lib_dir]
    try:
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            done = list(pool.map(_run, cmds))
        done.append(_run(link))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    log = "".join(text for text, _ in done)
    seconds = {os.path.basename(src): secs for src, (_, secs) in zip(srcs, done)}
    seconds["link"] = done[-1][1]
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.tmp", out)  # atomic: a concurrent build never loads a partial file
    return out, log, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, register the ops' CUDA impls with PyTorch, and return
    the library for the host-only queries, their signatures declared."""
    path, _, _ = build()
    import fal_net_torch.ops.library  # noqa: F401  the schemas the impls attach to

    torch.ops.load_library(path)
    lib = ctypes.CDLL(path)
    i = ctypes.c_int
    for fn in (lib.med_fwd_plan, lib.med_bwd_plan):
        fn.argtypes = [i] * 7 + [ctypes.c_void_p]
        fn.restype = i
    lib.fal_net_torch_launches.argtypes = [i]
    lib.fal_net_torch_launches.restype = ctypes.c_longlong
    lib.fal_net_torch_reset_launches.restype = None
    return lib


def ensure_loaded(device) -> None:
    """Load the kernels before the first dispatch to a CUDA ``device``."""
    if torch.device(device).type == "cuda":
        load_library()


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`,
    by :data:`COUNTERS`' names; all 0 while the library is not loaded (no
    kernel has launched)."""
    if not load_library.cache_info().currsize:
        return dict.fromkeys(COUNTERS, 0)
    lib = load_library()
    return {name: int(lib.fal_net_torch_launches(i)) for i, name in enumerate(COUNTERS)}


def reset_launch_counts() -> None:
    if load_library.cache_info().currsize:
        load_library().fal_net_torch_reset_launches()


class LaunchCounts(Mapping):
    """A read-only view of some of :func:`launch_counts`, by name."""

    def __init__(self, names):
        self.names = tuple(names)

    def __getitem__(self, name) -> int:
        if name not in self.names:
            raise KeyError(name)
        return launch_counts()[name]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

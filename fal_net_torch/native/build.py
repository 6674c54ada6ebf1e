"""Build the native image IO library (g++ with the system's libjpeg, libpng
and zlib) into the port's build directory.

    python -m fal_net_torch.native.build

The library goes to ``fal_net_torch/_build/`` (``$FAL_NET_TORCH_BUILD_DIR``
overrides it, as for the CUDA kernels), named by a hash of
``io_native.cpp`` and the compiler flags, so that an edited source rebuilds
and an unchanged one loads at once.  The ABI is plain C, bound with ctypes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

from fal_net_torch.ops._build import build_dir

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "io_native.cpp")
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lz", "-pthread")


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir(), f"io_native_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile io_native.cpp unless the hashed library exists; returns its
    path.  Compiles to a temporary file and renames it, so that concurrent
    builds (test workers, loader threads) never load a partial library.
    Raises RuntimeError with g++'s output if the build fails."""
    out = lib_path()
    if os.path.isfile(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp, *LIBS], capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"native IO build failed:\n{proc.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if verbose:
        print(f"built {out}")
    return out


if __name__ == "__main__":
    build(verbose=True)

"""ctypes binding of the port's native image IO core (io_native.cpp).

Public surface:

  * :func:`available` — True when the shared library built/loaded.
  * :func:`decode` / :func:`imread` — one encoded image -> numpy array.
  * :func:`decode_batch` — N images decoded on a C++ thread pool with the
    GIL released for the whole batch (one python call, all host cores).
  * :func:`encode_png16` / :func:`imwrite_png16` — 16-bit PNG writer for
    the KITTI ground-truth container formats (disparity*256 grayscale,
    optical-flow RGB).

Array conventions match ``imageio.v2.imread``: single-channel images come
back as (H, W), multi-channel as (H, W, C); 16-bit PNGs keep uint16,
including 16-bit *RGB*, which PIL and imageio downcast to uint8 (so the KITTI
flow loader needs this decoder).

Where the library cannot be built (no g++, libpng or libjpeg headers),
:func:`available` is False after one warning: the callers read images with
PIL, 16-bit PNGs are encoded (and the flow loader decodes 16-bit RGB) by
:mod:`fal_net_torch.native.png16` in numpy, and :func:`decoder` says so.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import List, Optional, Sequence, Union

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            from fal_net_torch.native import build as _build

            path = _build.build()
            lib = ctypes.CDLL(path)
        except Exception as e:  # no g++/headers in this env -> PIL fallback
            _load_failed = True
            warnings.warn(f"native IO unavailable ({e}); falling back to PIL")
            return None

        lib.fn_probe.restype = ctypes.c_int
        lib.fn_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.fn_decode.restype = ctypes.c_int
        lib.fn_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.fn_decode_batch.restype = ctypes.c_int
        lib.fn_decode_batch.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.fn_encode_png16.restype = ctypes.c_int
        lib.fn_encode_png16.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.fn_free.restype = None
        lib.fn_free.argtypes = [ctypes.c_void_p]
        lib.fn_error.restype = ctypes.c_char_p
        lib.fn_error.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """Which decoder serves image reads: "native", or without the library
    "PIL" (16-bit RGB PNGs: numpy)."""
    return "native" if available() else "PIL (16-bit RGB PNGs: numpy)"


def _err(lib: ctypes.CDLL, code: int, what: str) -> ValueError:
    return ValueError(f"{what}: {lib.fn_error(code).decode()}")


def _probe(lib: ctypes.CDLL, buf: bytes):
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    depth = ctypes.c_int()
    code = lib.fn_probe(buf, len(buf), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c), ctypes.byref(depth))
    if code != 0:
        raise _err(lib, code, "probe failed")
    return h.value, w.value, c.value, depth.value


def _alloc(h: int, w: int, c: int, depth: int) -> np.ndarray:
    dtype = np.uint16 if depth == 16 else np.uint8
    shape = (h, w) if c == 1 else (h, w, c)
    return np.empty(shape, dtype)


def decode(buf: bytes) -> np.ndarray:
    """Decode one PNG/JPEG byte string to a numpy array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO not available")
    h, w, c, depth = _probe(lib, buf)
    out = _alloc(h, w, c, depth)
    code = lib.fn_decode(buf, len(buf), out.ctypes.data_as(ctypes.c_void_p))
    if code != 0:
        raise _err(lib, code, "decode failed")
    return out


def imread(path: Union[str, os.PathLike]) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def decode_batch(bufs: Sequence[bytes], nthreads: int = 0) -> List[np.ndarray]:
    """Decode N images in parallel on the C++ thread pool (one GIL release).

    ``nthreads <= 0`` uses every host core.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO not available")
    n = len(bufs)
    if n == 0:
        return []
    outs = [_alloc(*_probe(lib, b)) for b in bufs]
    c_bufs = (ctypes.c_char_p * n)(*bufs)
    c_lens = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
    c_outs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    c_status = (ctypes.c_int * n)()
    code = lib.fn_decode_batch(n, c_bufs, c_lens, c_outs, c_status, nthreads)
    if code != 0:
        bad = [i for i in range(n) if c_status[i] != 0]
        raise _err(lib, code, f"batch decode failed at indices {bad}")
    return outs


def imread_batch(paths: Sequence[Union[str, os.PathLike]],
                 nthreads: int = 0) -> List[np.ndarray]:
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    return decode_batch(bufs, nthreads=nthreads)


def encode_png16(arr: np.ndarray) -> bytes:
    """uint16 (H, W) or (H, W, {1,3}) -> 16-bit PNG bytes (KITTI GT format);
    without the library, :func:`fal_net_torch.native.png16.encode` (the
    same pixels, other row filters)."""
    lib = _load()
    if lib is None:
        from fal_net_torch.native import png16

        return png16.encode(arr)
    a = np.asarray(arr)
    if a.dtype != np.uint16:
        raise ValueError(f"encode_png16 needs uint16, got {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        h, w, c = a.shape[0], a.shape[1], 1
    elif a.ndim == 3 and a.shape[-1] == 3:
        h, w, c = a.shape
    else:
        raise ValueError(f"encode_png16 needs (H,W), (H,W,1) or (H,W,3); got {a.shape}")
    a = np.ascontiguousarray(a)
    out = ctypes.POINTER(ctypes.c_uint8)()
    outlen = ctypes.c_size_t()
    code = lib.fn_encode_png16(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), h, w, c,
        ctypes.byref(out), ctypes.byref(outlen))
    if code != 0:
        raise _err(lib, code, "encode failed")
    try:
        return ctypes.string_at(out, outlen.value)
    finally:
        lib.fn_free(out)


def imwrite_png16(path: Union[str, os.PathLike], arr: np.ndarray) -> None:
    data = encode_png16(arr)
    with open(path, "wb") as f:
        f.write(data)

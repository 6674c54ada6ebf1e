"""16-bit PNG encode and decode in numpy and zlib, for hosts where the
native library does not build (no libpng or libjpeg headers).

PIL reads 16-bit RGB PNGs (the KITTI optical-flow encoding) as 8 bits, so
without the native decoder the flow loader reads them here.  ``encode``
writes filter-0 rows at zlib level 6; ``decode`` takes non-interlaced
16-bit PNGs of every colour type without a palette (gray, gray+alpha, RGB,
RGBA) and all five row filters, and returns the arrays the native decoder
returns: uint16 (H, W) for one channel, else (H, W, C).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode(arr: np.ndarray) -> bytes:
    """uint16 (H, W), (H, W, 1) or (H, W, 3) -> 16-bit PNG bytes."""
    a = np.asarray(arr)
    if a.dtype != np.uint16:
        raise ValueError(f"encode_png16 needs uint16, got {a.dtype}")
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[-1] == 3)):
        raise ValueError(f"encode_png16 needs (H,W), (H,W,1) or (H,W,3); got {a.shape}")
    h, w = a.shape[:2]
    rows = a.astype(">u2").reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0 per row
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0 if a.ndim == 2 else 2, 0, 0, 0)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode(buf: bytes) -> np.ndarray:
    """A 16-bit PNG -> uint16 array; ValueError for anything else (an
    8-bit or palette PNG, interlacing, a corrupt stream)."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 16 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"not a non-interlaced 16-bit PNG (bit depth {depth}, colour type {ctype})")
    c = _CHANNELS[ctype]
    bpp, stride = 2 * c, 2 * c * w
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    if raw.size != h * (stride + 1):
        raise ValueError("PNG data does not match its size")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = row
        elif f == 1:  # Sub: running sums over pixels, per byte of a pixel
            cur = np.cumsum(row.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif f == 2:  # Up
            cur = (row + prev) & 0xFF
        elif f in (3, 4):  # Average, Paeth: sequential over pixels
            cur = row.reshape(w, bpp).copy()
            up = prev.reshape(w, bpp)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(w):
                pred = (left + up[x]) >> 1 if f == 3 else _paeth(left, up[x], upleft)
                cur[x] = (cur[x] + pred) & 0xFF
                left, upleft = cur[x], up[x]
            cur = cur.reshape(-1)
        else:
            raise ValueError(f"unknown PNG row filter {f}")
        out[y] = cur
        prev = cur
    img = out.view(">u2").astype(np.uint16).reshape(h, w, c)
    return img[..., 0] if c == 1 else img

"""A numpy-only decoder of the msgpack that ``flax.serialization.to_bytes``
writes (the JAX package's ``checkpoint.msgpack`` and ``model_best.msgpack``),
so that the port reads JAX-trained weights without the ``msgpack`` or
``flax`` packages.

It covers what flax writes: maps, arrays, str, bin, ints, floats, nil and
bool, and flax's ext types (flax/serialization.py ``_MsgpackExtType``):
  * 1, ndarray: a nested msgpack array ``[shape, dtype name, C-order
    bytes]``; ``bfloat16`` (which numpy lacks) widens to float32 exactly;
  * 2, native complex: a nested ``[real, imag]``;
  * 3, numpy scalar: an ndarray of shape () returned as its scalar;
and flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape",
"chunks"}``) reassembled.  Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width formats by type byte: (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# lengths of str, bin, array, map and ext: type byte -> (kind, length format)
_SIZED = {
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if t in _FIXED:
            return self.unpack(_FIXED[t][0])
        if t in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(_FIXEXT[t])))
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self.unpack(fmt)
            if kind == "str":
                return self._str(n)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x} at offset {self.pos - 1}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if isinstance(k, (dict, list)):
                raise ValueError(f"unhashable msgpack map key {type(k).__name__}")
            out[k] = self.value()
        return out


def _dtype(name) -> Tuple[np.dtype, bool]:
    """(numpy dtype of the stored bytes, whether they are bfloat16)."""
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        return np.dtype(name), False
    except TypeError as e:
        raise ValueError(f"unsupported ndarray dtype {name!r} in msgpack") from e


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    dtype, bf16 = _dtype(name)
    arr = np.frombuffer(buf, dtype=dtype).reshape(tuple(shape))
    if bf16:  # the high half of a float32, exactly
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(node: Any) -> Any:
    """flax's chunked arrays back into arrays, everywhere in the tree."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data``, which it must fill exactly."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after a msgpack value")
    return out


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns: dicts of
    numpy arrays (bfloat16 widened to float32), scalars and strings."""
    return _unchunk(unpackb(data))

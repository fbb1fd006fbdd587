"""A msgpack decoder for the files that ``flax.serialization.msgpack_serialize``
writes, with no third-party package.

The subset: nil, bool, integers, float32/64, str, bin, array, map, and flax's
ext types 1 (ndarray: a packed ``(shape, dtype name, C-order bytes)``), 2
(complex: a packed ``(real, imag)``) and 3 (numpy scalar, packed as a 0-d
ndarray). Arrays decode to lists, maps to dicts, str to str and bin to bytes,
as ``msgpack.unpackb(raw=False)`` gives them; flax's chunked form of arrays
over 1 GiB is joined back, as ``msgpack_restore`` does. Truncated input,
trailing bytes, an unknown type byte or ext code, and a dtype numpy does not
know (flax's ``bfloat16`` included) raise ``ValueError``.

``load_flax_msgpack`` reads a variables file such as the JAX package's
``assets/bench_det_fp16.msgpack`` (``scripts/export_bench_det.py``).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

#: fixed-width items: type byte -> (struct format, kind)
_FIXED = {
    0xCA: (">f", "float"), 0xCB: (">d", "float"),
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"), 0xCF: (">Q", "int"),
    0xD0: (">b", "int"), 0xD1: (">h", "int"), 0xD2: (">i", "int"), 0xD3: (">q", "int"),
}
#: length-prefixed items: type byte -> (length format, kind)
_SIZED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
#: fixext type byte -> payload length
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def item(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, _ = _FIXED[b]
            return self.unpack(fmt)
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.item() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.item()
            out[k] = self.item()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(payload)
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext code {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray encoding: a packed (shape, dtype name, C-order bytes)."""
    shape, name, buf = unpackb(payload)
    name = name.decode("ascii") if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"ndarray of dtype {name!r}: not a numpy dtype") from e
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buf):
        raise ValueError(f"ndarray {name}{tuple(shape)}: {len(buf)} bytes of data")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data``; bytes left after it raise."""
    reader = _Reader(data)
    out = reader.item()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns for ``data``."""
    return _unchunk(unpackb(data))


def _widen(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree


def load_flax_msgpack(path: str) -> Tuple[Dict, int]:
    """A ``{"step", "variables"}`` file as ``scripts/export_bench_det.py``
    writes it -> (the variables as nested dicts of numpy arrays with float16
    widened to float32, as ``bench.py`` widens them; the step)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict) or set(tree) != {"step", "variables"}:
        raise ValueError(f"{path}: not a {{'step', 'variables'}} map")
    return _widen(tree["variables"]), int(tree["step"])

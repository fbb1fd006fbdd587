"""A msgpack decoder for the files that ``flax.serialization.msgpack_serialize``
writes, and an encoder that writes them, with no third-party package.

The subset: nil, bool, integers, float32/64, str, bin, array, map, and flax's
ext types 1 (ndarray: a packed ``(shape, dtype name, C-order bytes)``), 2
(complex: a packed ``(real, imag)``) and 3 (numpy scalar, packed as a 0-d
ndarray). Arrays decode to lists, maps to dicts, str to str and bin to bytes,
as ``msgpack.unpackb(raw=False)`` gives them; flax's chunked form of arrays
over 1 GiB is joined back, as ``msgpack_restore`` does. Truncated input,
trailing bytes, an unknown type byte or ext code, and a dtype numpy does not
know (flax's ``bfloat16`` included) raise ``ValueError``.

``msgpack_serialize`` gives the bytes flax's function of that name gives
for the same tree (dicts of str keys, lists, None, bool, int, float, str,
bytes, numpy arrays and scalars): its keys in sorted order (flax copies the
tree through ``jax.tree_util``, which sorts them), each item in msgpack's
shortest form, Python floats as float64, arrays and numpy
scalars as ext types 1 and 3. An array over flax's 1 GiB chunk size raises.

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


_MAX_CHUNK = 2 ** 30  # flax's MAX_CHUNK_SIZE


def _head(out: bytearray, n: int, fix: int, fix_max: int, wide: Tuple[int, ...]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-bit (if
    any), 16-bit and 32-bit forms, whose type bytes ``wide`` lists."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(wide, (">B", ">H", ">I")[3 - len(wide):],
                                (1 << 8, 1 << 16, 1 << 32)[3 - len(wide):]):
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} over 2^32")


def _pack_int(out: bytearray, v: int) -> None:
    if -32 <= v < 128:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} over msgpack's 64 bits")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} over msgpack's 64 bits")


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(payload))
    if fixed is not None:
        out.append(fixed)
    else:
        _head(out, len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif type(v) is str:
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif type(v) is bytes:
        _head(out, len(v), 0, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) is list:
        _head(out, len(v), 0x90, 16, (0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif type(v) is dict:
        _head(out, len(v), 0x80, 16, (0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        if v.size * v.dtype.itemsize > _MAX_CHUNK:
            raise ValueError(f"an array of {v.nbytes} bytes: flax would chunk it")
        _ext(out, _EXT_NDARRAY, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
    elif type(v) is complex:
        inner = bytearray()
        _pack(inner, [v.real, v.imag])
        _ext(out, _EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def _sorted(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(x) for x in tree]
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` (see the module's docstring)."""
    out = bytearray()
    _pack(out, _sorted(tree))
    return bytes(out)


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

"""PNG in numpy and the standard library's ``zlib``, bit-equal to
``cv2.imread``/``cv2.imdecode`` with ``IMREAD_COLOR`` then
``cv2.cvtColor(BGR2RGB)``, and an 8-bit PNG writer.

cv2 reads PNG through libpng with these transforms, which ``decode_png``
copies:

* every colour type and bit depth of the standard: grey at 1, 2, 4, 8 or 16
  bits, RGB at 8 or 16, palette at 1, 2, 4 or 8, grey and RGB with alpha at
  8 or 16; Adam7 interlace through its seven passes, each pass with its own
  row filters;
* 16-bit samples truncated to their high byte (``png_set_strip_16``: 383
  reads 1); grey of 1, 2 or 4 bits scaled by 255 / (2^n - 1); a palette
  expanded (indices past its end read black); grey repeated into the three
  channels; alpha and ``tRNS`` dropped, not composited;
* ancillary chunks (``gAMA``, ``sBIT``, ``cHRM``, ``iCCP``, text) ignored,
  but for an ``eXIf`` chunk before or after the image data: its EXIF
  Orientation is applied as cv2 applies it (``jpeg.apply_orientation``);
  an ancillary chunk with a bad CRC dropped, and data past the image's
  last row ignored, as libpng drops and ignores them.

A file the standard does not allow (a bad bit depth for its colour type, a
palette file without ``PLTE``, a bad CRC in a critical chunk, truncated
data) raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

from .jpeg import apply_orientation, tiff_orientation

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> (samples a pixel, allowed bit depths)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
#: Adam7's passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) == struct.unpack(">I", crc)[0]:
            yield kind, body
        elif kind[0] < 97:  # critical (upper case); libpng drops an ancillary chunk
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the row filters: (h, stride) uint8 samples."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {len(raw)} bytes, not {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = f.copy()
        elif kind == 1:  # Sub: a running sum along each sample of a pixel
            cur = (f.reshape(-1, bpp).astype(np.int64).cumsum(0) % 256).astype(np.uint8)
            cur = cur.reshape(stride)
        elif kind == 2:  # Up
            cur = f + prev
        elif kind in (3, 4):  # Average, Paeth: a recurrence along the row
            cur = bytearray(f.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> (h, w, ch) samples, 16-bit ones cut to
    their high byte, those of fewer than 8 bits unpacked (not yet scaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, w, ch, 2)[..., 0]
    if depth == 8:
        return rows.reshape(h, w, ch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(h, -1)[:, :w, None]


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB as cv2 decodes them (see the
    module's docstring); ``path`` names the source in errors."""
    header, palette, idat, orientation = None, None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and orientation is None and body[:2] in (b"II", b"MM"):
            orientation = tiff_orientation(body) or 1  # libpng keeps the first valid one
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _TYPES or depth not in _TYPES[colour][1]:
        raise ValueError(f"{path}: PNG of bit depth {depth} and colour type {colour}")
    if compression != 0 or filtering != 0 or interlace > 1 or not w or not h:
        raise ValueError(f"{path}: bad PNG header (compression {compression}, filter method "
                         f"{filtering}, interlace {interlace}, {w}x{h})")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _TYPES[colour][0]
    bpp = max(1, ch * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: bad PNG image data ({e})") from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    px = np.zeros((h, w, ch), np.uint8)
    pos = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        part = raw[pos:pos + ph * (stride + 1)]
        pos += len(part)
        px[y0::dy, x0::dx] = _samples(_unfilter(part, ph, stride, bpp, path), pw, ch, depth)
    # (data past the image is ignored, as libpng ignores it)
    if colour == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        img = lut[px[..., 0]]
    elif ch <= 2:  # grey (+ alpha): the grey level in all three channels
        grey = px[..., 0] * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else px[..., 0]
        img = np.repeat(grey[..., None], 3, axis=2)
    else:
        img = np.ascontiguousarray(px[..., :3])
    return apply_orientation(img, orientation)


def _filter_rows(kind: int, cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Rows (n, L) filtered by ``kind`` against the rows above them (n, L)."""
    c = cur.astype(np.int64)
    b = prev.astype(np.int64)
    pad = np.zeros(c.shape[:-1] + (bpp,), np.int64)
    a = np.concatenate([pad, c[..., :-bpp]], -1)
    if kind == 0:
        pred = np.zeros_like(c)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        cc = np.concatenate([pad, b[..., :-bpp]], -1)
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    else:
        raise ValueError(f"unknown PNG row filter {kind}")
    return ((c - pred) % 256).astype(np.uint8)


def encode_png(image: np.ndarray, filters: Sequence[int] = (1,)) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> the bytes of an
    8-bit PNG; row y takes the filter ``filters[y % len(filters)]`` (0 None,
    1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"a PNG takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, ch = image.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if colour is None:
        raise ValueError(f"a PNG takes 1-4 channels, got {ch}")
    rows = image.reshape(h, w * ch)
    above = np.concatenate([np.zeros((1, w * ch), np.uint8), rows[:-1]])
    kinds = np.array([filters[y % len(filters)] for y in range(h)], np.int64)
    out = np.empty((h, 1 + w * ch), np.uint8)
    out[:, 0] = kinds
    for kind in np.unique(kinds).tolist():
        sel = kinds == kind
        out[sel, 1:] = _filter_rows(kind, rows[sel], above[sel], ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, filters: Sequence[int] = (1,)) -> None:
    """Write ``encode_png(image, filters)`` to ``path``."""
    data = encode_png(image, filters)
    with open(path, "wb") as f:
        f.write(data)

"""BMP and PNM (PBM, PGM, PPM) in numpy, bit-equal to ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_COLOR`` then ``cv2.cvtColor(BGR2RGB)``.

cv2 reads both with decoders of its own (``grfmt_bmp.cpp``,
``grfmt_pxm.cpp``), whose rules these copy, as probed on cv2 5.0.0:

* **BMP** (``decode_bmp``): the OS/2 header of 12 bytes and the Windows
  headers of 40 bytes and more; bottom-up rows or top-down (a negative
  height); palettes of 1, 4 and 8 bits (an index past the palette's entries
  reads black); 16 bits as 5-5-5 (``BI_RGB``), or 5-6-5 or 5-5-5 by
  ``BI_BITFIELDS`` masks, which cv2 reads from the 12 bytes after the
  header, whatever the header's size; each 5- or 6-bit field shifted up,
  not scaled; 24 bits; 32 bits with the fourth byte dropped, channels by
  the header's byte masks where a header of 108 bytes or more gives
  ``BI_BITFIELDS``; ``BI_RLE8`` and ``BI_RLE4`` as cv2 decodes them
  (``_rle``): the pixels a jump, end of line or end of bitmap passes over
  take palette entry 0; an RLE8 run that fills its row moves to the next
  one, an RLE4 run does not, and in RLE4 an end of bitmap ends the row
  only and a jump moves right only.
* **PNM** (``decode_pnm``): P1-P6. Header numbers and ASCII samples are read
  as cv2's ``ReadNumber`` reads them: whitespace and ``#`` comments skipped
  before a number, one byte after it consumed. ASCII samples are clamped to
  maxval and, when maxval is below 256, scaled to ``v * 255 // maxval``;
  binary samples of one byte are taken as they are, neither clamped nor
  scaled; samples of two bytes (maxval above 255) are read big-endian and
  cut to their high byte (1000 reads 3). PBM's 1 is black.

A file cv2 refuses (a short file, a run past its row, a maxval of 0 or
above 65535, an RLE stream without its end) raises ``ValueError``; BMP
layouts cv2 reads that these do not (another 32-bit mask) raise
``NotImplementedError``.
"""

from __future__ import annotations

import re
import struct
from typing import List, Tuple

import numpy as np

_BMP_NAMES = {1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS"}
_BYTE_MASKS = {0xFF << (8 * k): k for k in range(4)}


def _bmp_palette(data: bytes, at: int, count: int, entry: int, path: str) -> np.ndarray:
    """256 RGB entries from ``count`` BGR(A) entries of ``entry`` bytes at
    ``at``; entries past ``count`` are black."""
    raw = data[at:at + count * entry]
    if len(raw) != count * entry:
        raise ValueError(f"{path}: BMP palette cut short")
    lut = np.zeros((256, 3), np.uint8)
    lut[:count] = np.frombuffer(raw, np.uint8).reshape(count, entry)[:, 2::-1]
    return lut


def _fill(img: np.ndarray, pos: List[int], count: int, colour: int) -> None:
    """cv2's ``FillUniColor``: ``count`` pixels of ``colour`` from (y, x) =
    ``pos`` along the rows, moving to the next row at a row's end (even for
    no pixels), stopping past the last row."""
    h, w = img.shape
    y, x = pos
    while True:
        end = min(x + count, w)
        img[y, x:end] = colour
        count -= end - x
        x = end
        if x >= w:
            x, y = 0, y + 1
            if y >= h:
                break
        if count <= 0:
            break
    pos[:] = [y, x]


def _rle(data: bytes, at: int, h: int, w: int, four: bool, path: str) -> np.ndarray:
    """Palette indices (h, w), rows in file order, from an RLE8 or RLE4
    stream at ``at``, as cv2's decoder walks it."""
    img = np.zeros((h, w), np.uint8)
    pos = [0, 0]  # row, column
    row_done = False  # RLE8: the last run ended its row (an end of line then does nothing)
    n = len(data)

    def bad(what: str):
        return ValueError(f"{path}: BMP {'RLE4' if four else 'RLE8'} stream {what}")

    while True:
        if at + 2 > n:
            raise bad("ends before its end-of-bitmap code")
        count, code = data[at], data[at + 1]
        at += 2
        y, x = pos
        if count:  # a run
            if x + count > w:
                raise bad("has a run past the end of its row")
            if four:
                img[y, x:x + count] = np.resize([code >> 4, code & 15], count)
                pos[1] = x + count
                continue
            _fill(img, pos, count, code)
            row_done = pos[0] > y
            if pos[0] >= h:
                break
        elif code > 2:  # absolute: ``code`` literal pixels, padded to a whole word
            if x + code > w:
                raise bad("has literal pixels past the end of its row")
            size = ((code + 1) // 2 + 1) & ~1 if four else (code + 1) & ~1
            raw = data[at:at + size]
            if len(raw) != size:
                raise bad("ends inside its literal pixels")
            at += size
            v = np.frombuffer(raw, np.uint8)
            if four:
                v = np.stack([v >> 4, v & 15], 1).reshape(-1)
            img[y, x:x + code] = v[:code]
            pos[1] = x + code
            row_done = False
        else:  # 0: end of line, 1: end of bitmap, 2: a jump right and down
            if four or code or not row_done or x > 0:
                # RLE4 as cv2 walks it: an end of bitmap ends the row only,
                # a jump moves right only
                skip = w - x + ((h - y) * w if code == 1 and not four else 0)
                if code == 2:
                    if at + 2 > n:
                        raise bad("ends inside a jump")
                    skip = data[at] + (0 if four else data[at + 1] * w)
                    at += 2
                _fill(img, pos, skip, 0)
            row_done = False
            if pos[0] >= h:
                break
    return img


def decode_bmp(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB as cv2 decodes them (see the
    module's docstring)."""
    if len(data) < 18:
        raise ValueError(f"{path}: truncated BMP header")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        compression, used, entry = 0, 0, 3
        if bpp not in (1, 4, 8, 24):
            raise NotImplementedError(f"{path}: an OS/2 BMP of {bpp} bits a pixel")
    elif size >= 36:
        if len(data) < 14 + 36:
            raise ValueError(f"{path}: truncated BMP header")
        w, h, _, bpp, compression = struct.unpack("<iiHHI", data[18:34])
        (used,) = struct.unpack("<I", data[46:50])
        entry = 4
    else:
        raise ValueError(f"{path}: BMP header of {size} bytes")
    ok = {0: (1, 4, 8, 16, 24, 32), 1: (8,), 2: (4,), 3: (16, 32)}
    if w <= 0 or h == 0 or bpp not in ok.get(compression, ()):
        raise NotImplementedError(f"{path}: a BMP of {bpp} bits a pixel, compression "
                                  f"{_BMP_NAMES.get(compression, compression)}, {w}x{h}")
    top_down = h < 0
    h = abs(h)
    masks = None
    if bpp <= 8:
        count = used or 1 << bpp
        if count > 256:
            raise ValueError(f"{path}: BMP palette of {count} entries")
        lut = _bmp_palette(data, 14 + size, count, entry, path)
    elif compression == 3:
        if bpp == 16:  # cv2 reads the masks after the header, whatever its size
            masks = struct.unpack("<III", data[14 + size:26 + size].ljust(12, b"\0"))
            if masks not in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
                raise ValueError(f"{path}: 16-bit BMP masks {[hex(m) for m in masks]} (after "
                                 "its header) are neither 5-6-5 nor 5-5-5")
        elif size >= 108:
            masks = struct.unpack("<III", data[54:66])
            if not all(m in _BYTE_MASKS for m in masks) or len(set(masks)) != 3:
                raise NotImplementedError(f"{path}: 32-bit BMP masks {[hex(m) for m in masks]}")
        elif size != 40:
            raise NotImplementedError(f"{path}: a 32-bit BI_BITFIELDS BMP with a header of "
                                      f"{size} bytes")
    if compression in (1, 2):
        idx = _rle(data, offset, h, w, compression == 2, path)
        img = lut[idx]
    else:
        stride = (w * bpp + 31) // 32 * 4
        raw = data[offset:offset + stride * h]
        if len(raw) != stride * h:
            raise ValueError(f"{path}: BMP pixel data cut short")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
        if bpp <= 8:
            if bpp == 8:
                idx = rows[:, :w]
            else:
                shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
                idx = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(h, -1)[:, :w]
            img = lut[idx]
        elif bpp == 16:
            v = rows[:, :2 * w].view("<u2").astype(np.int64)
            g6 = masks is not None and masks[1] == 0x7E0
            r = ((v >> (11 if g6 else 10)) & 31) << 3
            g = ((v >> 5) & 63) << 2 if g6 else ((v >> 5) & 31) << 3
            img = np.stack([r, g, (v & 31) << 3], -1).astype(np.uint8)
        else:
            px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
            pick = [_BYTE_MASKS[m] for m in masks] if masks else [2, 1, 0]
            img = px[..., pick]
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)


# ----------------------------------------------------------------------- PNM
_SPACE = b" \t\n\v\f\r"
_PLAIN = re.compile(rb"[0-9 \t\n\v\f\r]*")


def _read_number(data: bytes, pos: int, path: str, max_digits: int = 0) -> Tuple[int, int]:
    """cv2's ``ReadNumber`` from ``pos``: (value, position after it and the
    byte that ended it). Whitespace and comments (``#`` to the end of the
    line) are skipped before the digits; the end of the data is an error."""
    n = len(data)

    def byte(i):
        if i >= n:
            raise ValueError(f"{path}: PNM data ends inside a number")
        return data[i]

    c = byte(pos)
    while not 48 <= c <= 57:
        if c == 35:  # '#': a comment to the end of its line
            pos += 1
            while byte(pos) not in (10, 13):
                pos += 1
        elif c not in _SPACE:
            raise ValueError(f"{path}: PNM byte {c:#04x} where a number was expected")
        pos += 1
        c = byte(pos)
    value, digits = 0, 0
    while True:
        value = value * 10 + c - 48
        digits += 1
        if value > 0x7FFFFFFF:
            raise ValueError(f"{path}: PNM number too large")
        pos += 1
        if max_digits and digits >= max_digits:
            return value, pos
        c = byte(pos)
        if not 48 <= c <= 57:
            return value, pos + 1


def _ascii_samples(data: bytes, pos: int, count: int, path: str, bits: bool) -> np.ndarray:
    """``count`` ASCII numbers from ``pos`` (single digits for P1), read as
    ``_read_number`` reads them."""
    tail = data[pos:]
    if _PLAIN.fullmatch(tail):  # digits and whitespace only: one split
        if bits:
            digits = tail.translate(None, _SPACE)
            if len(digits) < count:
                raise ValueError(f"{path}: PBM data holds {len(digits)} of {count} pixels")
            return np.frombuffer(digits[:count], np.uint8).astype(np.int64) - 48
        tokens = tail.split(None, count)
        if len(tokens) < count or (len(tokens) == count and not tail[-1:].isspace()):
            raise ValueError(f"{path}: PNM data ends inside its samples")
        if any(len(t) > 10 for t in tokens[:count]):
            raise ValueError(f"{path}: PNM number too large")
        values = np.array(tokens[:count], np.int64)
        if (values > 0x7FFFFFFF).any():
            raise ValueError(f"{path}: PNM number too large")
        return values
    out = np.empty(count, np.int64)
    for i in range(count):
        out[i], pos = _read_number(data, pos, path, 1 if bits else 0)
    return out


def decode_pnm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PBM, PGM or PPM bytes (P1-P6) -> (H, W, 3) uint8 RGB as cv2 decodes
    them (see the module's docstring)."""
    kind = data[1] - 48
    w, pos = _read_number(data, 2, path)
    h, pos = _read_number(data, pos, path)
    bits = kind in (1, 4)
    maxval = 1
    if not bits:
        maxval, pos = _read_number(data, pos, path)
        if not 0 < maxval <= 65535:
            raise ValueError(f"{path}: PNM maxval {maxval}")
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: PNM of {w}x{h}")
    ch = 3 if kind in (3, 6) else 1
    n = w * h * ch
    if kind == 4:
        stride = (w + 7) // 8
        raw = data[pos:pos + stride * h]
        if len(raw) != stride * h:
            raise ValueError(f"{path}: PBM data cut short")
        v = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride), axis=1)[:, :w]
        px = np.where(v.astype(bool), 0, 255).astype(np.uint8)
    elif kind in (5, 6):
        size = 2 if maxval > 255 else 1
        raw = data[pos:pos + n * size]
        if len(raw) != n * size:
            raise ValueError(f"{path}: PNM data cut short")
        px = np.frombuffer(raw, np.uint8)[::size]  # a 16-bit sample's high byte
    else:
        v = _ascii_samples(data, pos, n, path, bits)
        if bits:
            px = np.where(v > 0, 0, 255)
        else:
            v = np.minimum(v, maxval)
            px = v >> 8 if maxval > 255 else v * 255 // maxval
        px = px.astype(np.uint8)
    px = px.reshape(h, w, ch)
    return np.ascontiguousarray(px if ch == 3 else np.repeat(px, 3, axis=2))

"""BMP, PNM (PBM, PGM, PPM), PFM and Sun raster in numpy, bit-equal to
``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR`` then
``cv2.cvtColor(BGR2RGB)``.

cv2 reads these with decoders of its own (``grfmt_bmp.cpp``,
``grfmt_pxm.cpp``, ``grfmt_pfm.cpp``, ``grfmt_sunras.cpp``), whose rules
these copy, as probed on cv2 5.0.0 (``decode_pfm`` and ``decode_sunras``
say theirs):

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


# ----------------------------------------------------------------------- PFM
_PFM_INT = re.compile(rb"[+-]?[0-9]+")
_PFM_FLOATS = (re.compile(rb"[+-]?0[xX]([0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
                          rb"([pP][+-]?[0-9]+)?"),
               re.compile(rb"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?"),
               re.compile(rb"[+-]?(infinity|inf|nan)", re.IGNORECASE))


def is_pfm(data: bytes) -> bool:
    return len(data) > 2 and data[0] == 80 and data[1] in b"Ff" and data[2] in _SPACE


def _pfm_token(data: bytes, pos: int, path: str) -> Tuple[bytes, int]:
    """cv2's PFM ``read_number`` token: up to 2048 bytes before one
    whitespace byte, which it consumes (so two in a row end an empty
    token); -> (token, position after it)."""
    for end in range(pos, pos + 2048):
        if end >= len(data) or data[end] >= 128:
            raise ValueError(f"{path}: PFM header cut short or not ASCII")
        if data[end] in _SPACE:
            return data[pos:end], end + 1
    return data[pos:pos + 2048], pos + 2048


def _pfm_float(token: bytes) -> float:
    """C's ``strtod`` of the token's longest leading number (0 if none)."""
    hexa, dec, special = (p.match(token) for p in _PFM_FLOATS)
    if hexa:
        return float.fromhex(hexa.group(0).decode())
    if dec:
        return float(dec.group(0))
    return float(special.group(0)) if special else 0.0


def decode_pfm(data: bytes, path: str = "<bytes>", from_file: bool = True) -> np.ndarray:
    """PFM bytes (``PF`` colour, ``Pf`` grey) -> (H, W, 3) uint8 RGB as cv2
    5 reads them: header numbers as C's ``atoi`` and ``strtod`` read the
    tokens ``_pfm_token`` cuts; float32 rows bottom to top, little-endian
    where the scale is negative; each sample times float32(1 / |scale|) in
    float32, rounded half to even, clipped to 0..255, and 0 where it is not
    finite or from 2^31 up (no x255). ``cv2.imread`` refuses a grey PFM
    (``from_file``); ``cv2.imdecode`` reads it, and ``BGR2RGB`` puts the
    grey in all three channels."""
    if not is_pfm(data) or data[2] != 10:
        raise ValueError(f"{path}: PFM header not 'PF' or 'Pf' and a line break")
    ch = 3 if data[1] == 70 else 1
    if ch == 1 and from_file:
        raise ValueError(f"{path}: grey PFM (cv2.imread refuses it; cv2.imdecode reads it)")
    pos, dims = 3, []
    for _ in range(2):
        token, pos = _pfm_token(data, pos, path)
        m = _PFM_INT.match(token)
        dims.append(int(m.group(0)) if m else 0)
    w, h = dims
    token, pos = _pfm_token(data, pos, path)
    scale = _pfm_float(token)
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20):
        raise ValueError(f"{path}: PFM of {w}x{h}")
    if not abs(scale) > 0:
        raise ValueError(f"{path}: PFM scale {token!r} (cv2 refuses it)")
    n = w * h * ch
    raw = data[pos:pos + 4 * n]
    if len(raw) != 4 * n:
        raise ValueError(f"{path}: PFM data cut short")
    x = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w, ch)[::-1]
    with np.errstate(over="ignore", invalid="ignore"):
        v = x.astype(np.float32) * np.array(1.0 / abs(scale)).astype(np.float32)
        ok = np.isfinite(v) & (v < 2.0 ** 31)
        px = np.where(ok, np.clip(np.rint(np.where(ok, v, 0)), 0, 255), 0).astype(np.uint8)
    return np.ascontiguousarray(np.repeat(px, 3, 2) if ch == 1 else px)


# ---------------------------------------------------------------- Sun raster
SUNRAS_SIGNATURE = b"\x59\xa6\x6a\x95"


def decode_sunras(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Sun raster bytes -> (H, W, 3) uint8 RGB as cv2 5 reads them: types 0
    (old) and 1 (standard) only (cv2's header test compares the image type
    where it means the encoding, which refuses byte-encoded (2) and RGB (3)
    files); 1 and 8 bits through an RGB colour map (an index past it reads
    black) or, without one, grey (1 bit: 0 black, 1 white); 24 bits as B,
    G, R and 32 as X, B, G, R; rows padded to 16 bits, all of them present;
    the header's length field ignored."""
    if len(data) < 32 or not data.startswith(SUNRAS_SIGNATURE):
        raise ValueError(f"{path}: not a Sun raster, or its header cut short")
    _, w, h, bpp, _, kind, maptype, maplen = struct.unpack(">8I", data[:32])
    palsize = 3 << bpp if bpp <= 8 else 0
    if not (0 < w < 1 << 31 and 0 < h < 1 << 31 and bpp in (1, 8, 24, 32) and kind in (0, 1)
            and ((maptype == 0 and maplen == 0)
                 or (maptype == 1 and 0 < maplen <= palsize))):
        raise ValueError(f"{path}: Sun raster of {bpp} bits, type {kind}, colour map type "
                         f"{maptype} of {maplen} bytes (cv2 refuses it)")
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    at = 32 + maplen
    raw = data[at:at + h * pitch]
    if len(data) < at or len(raw) != h * pitch:
        raise ValueError(f"{path}: Sun raster data cut short")
    rows = np.frombuffer(raw, np.uint8).reshape(h, pitch)
    if bpp > 8:
        step = bpp // 8
        return rows[:, :w * step].reshape(h, w, step)[..., [step - 1, step - 2, step - 3]]
    palette = np.zeros((256, 3), np.uint8)
    if maplen:
        n = maplen // 3
        palette[:n] = np.frombuffer(data[32:32 + 3 * n], np.uint8).reshape(3, n).T
    else:
        palette[:1 << bpp] = (np.arange(1 << bpp) * 255 // ((1 << bpp) - 1))[:, None]
    idx = np.unpackbits(rows, axis=1)[:, :w] if bpp == 1 else rows[:, :w]
    return palette[idx]

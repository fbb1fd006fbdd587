"""Radiance RGBE (``.hdr``) in numpy, bit-equal to ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_COLOR`` then ``cv2.cvtColor(BGR2RGB)``.

cv2 reads these with Bruce Walter's ``rgbe.c`` (``grfmt_hdr.cpp``), whose
rules ``decode_hdr`` copies, as probed on cv2 5.0.0:

* the signature ``#?RGBE`` or ``#?RADIANCE``; then header lines, each read
  as C's ``fgets`` into 128 bytes reads it (a longer line comes in pieces),
  up to the first that is a lone ``\\n``; one of them must be exactly
  ``FORMAT=32-bit_rle_rgbe\\n`` as a C string (up to a NUL byte;
  ``32-bit_rle_xyze``, CRLF lines or no FORMAT line are refused); others
  (``EXPOSURE=``, ``GAMMA=``, comments) are skipped and change nothing;
* the resolution line as ``sscanf("-Y %d +X %d")`` takes it: only the
  top-down, left-to-right orientation is read;
* scanlines of 8 to 32767 pixels in new-style run-length form (``2 2 hi
  lo``, then each of the four channels on its own: a count above 128 a run
  of the next byte, else that many bytes); a scanline that does not start
  with ``2 2`` (and a byte below 128) makes the rest of the image flat RGBE
  quadruples, as does any width under 8 or above 32767; old-style runs are
  read as plain pixels;
* each pixel ``m * 2^(e - 136)`` (zero where ``e`` is 0) as float32, then
  cv2's ``convertTo(CV_8U, 255)``: ``m * 255 * 2^(e - 136)`` rounded half to
  even, clipped to 0..255, and 0 from 2^31 up (cv2's float-to-int rounding
  gives INT_MIN there, which saturates to 0).

A file cv2 refuses (no FORMAT line, another orientation, data cut short, a
run past its scanline, a scanline of another width) raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")

_RESOLUTION = re.compile(rb"-Y\s*([+-]?[0-9]+)\s*\+X\s*([+-]?[0-9]+)")


def is_hdr(data: bytes) -> bool:
    return data.startswith(SIGNATURES)


def _fgets(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """C's ``fgets`` into a 128-byte buffer: (the bytes read, or None at the
    end of the data; the position after them)."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def _header(data: bytes, path: str) -> Tuple[int, int, int]:
    """(width, height, position of the pixels). A line is compared as the C
    string it holds (up to a NUL byte)."""
    has_format = False
    line, pos = _fgets(data, 0)
    while line != b"\n":
        has_format |= line.split(b"\0")[0] == b"FORMAT=32-bit_rle_rgbe\n"
        line, pos = _fgets(data, pos)
        if line is None:
            raise ValueError(f"{path}: Radiance header cut short")
    if not has_format:
        raise ValueError(f"{path}: Radiance header without FORMAT=32-bit_rle_rgbe (cv2 refuses "
                         "it)")
    line, pos = _fgets(data, pos)
    m = _RESOLUTION.match((line or b"").split(b"\0")[0])
    if m is None:
        raise ValueError(f"{path}: Radiance resolution line {line!r} is not '-Y h +X w' (cv2 "
                         "refuses it)")
    h, w = int(m.group(1)), int(m.group(2))
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20):
        raise ValueError(f"{path}: Radiance image of {w}x{h}")
    return w, h, pos


def _flat(data: bytes, pos: int, n: int, path: str) -> np.ndarray:
    raw = data[pos:pos + 4 * n]
    if len(raw) != 4 * n:
        raise ValueError(f"{path}: Radiance pixels cut short")
    return np.frombuffer(raw, np.uint8).reshape(n, 4)


def _scanline(data: bytes, pos: int, w: int, path: str) -> Tuple[bytearray, int]:
    """One new-style run-length scanline after its ``2 2 hi lo`` -> (its four
    channels one after another, the position after it)."""
    line = bytearray(4 * w)
    at = 0
    for end in range(w, 4 * w + 1, w):
        while at < end:
            if pos + 2 > len(data):
                raise ValueError(f"{path}: Radiance scanline cut short")
            count, value = data[pos], data[pos + 1]
            pos += 2
            if count > 128:
                count -= 128
                if count > end - at:
                    raise ValueError(f"{path}: Radiance run past its scanline")
                line[at:at + count] = bytes([value]) * count
            else:
                if count == 0 or count > end - at:
                    raise ValueError(f"{path}: Radiance run past its scanline")
                line[at] = value
                rest = data[pos:pos + count - 1]
                if len(rest) != count - 1:
                    raise ValueError(f"{path}: Radiance scanline cut short")
                line[at + 1:at + count] = rest
                pos += count - 1
            at += count
    return line, pos


def _rgbe(data: bytes, pos: int, w: int, h: int, path: str) -> np.ndarray:
    """Every pixel's (r, g, b, e) bytes -> (h, w, 4) uint8."""
    if w < 8 or w > 0x7FFF:
        return _flat(data, pos, w * h, path).reshape(h, w, 4)
    out = np.empty((h * w, 4), np.uint8)
    for y in range(h):
        head = data[pos:pos + 4]
        if len(head) != 4:
            raise ValueError(f"{path}: Radiance pixels cut short")
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:  # the rest is flat
            out[y * w:] = _flat(data, pos, (h - y) * w, path)
            break
        if head[2] << 8 | head[3] != w:
            raise ValueError(f"{path}: Radiance scanline of {head[2] << 8 | head[3]} pixels in "
                             f"an image {w} wide")
        line, pos = _scanline(data, pos + 4, w, path)
        out[y * w:(y + 1) * w] = np.frombuffer(bytes(line), np.uint8).reshape(4, w).T
    return out.reshape(h, w, 4)


def decode_hdr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Radiance RGBE bytes -> (H, W, 3) uint8 RGB as cv2 decodes them (see
    the module's docstring)."""
    if not is_hdr(data):
        raise ValueError(f"{path}: not a Radiance RGBE file")
    w, h, pos = _header(data, path)
    px = _rgbe(data, pos, w, h, path)
    e = px[..., 3:].astype(np.float64)
    v = np.where(e > 0, px[..., :3] * np.exp2(e - 136) * 255, 0.0)  # exact in float64
    return np.where(v >= 2.0 ** 31, 0, np.clip(np.rint(v), 0, 255)).astype(np.uint8)

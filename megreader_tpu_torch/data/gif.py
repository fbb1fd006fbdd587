"""GIF in numpy, bit-equal to ``cv2.imread`` / ``cv2.imdecode`` with
``IMREAD_COLOR`` then ``cv2.cvtColor(BGR2RGB)``.

cv2 5 reads GIF with a decoder of its own (``grfmt_gif.cpp``), whose rules
these copy, as probed on cv2 5.0.0:

* the first image of the file only, on a canvas of the logical screen's
  size. The canvas starts as the background colour (global table entry
  ``bg``; black without a global table); the image's pixels are placed at
  its offset, and those of the transparent index (of the last graphic
  control extension before the image) keep the background colour;
* the colours: the global table, overlaid from entry 0 by the image's local
  table; an index up to the larger table's size reads the overlaid table,
  one past it makes cv2 fail. Without either table index i reads grey i,
  but index 1 white;
* LZW with minimum code sizes 2-8: clear and end codes, codes one bit wider
  each time the next free entry reaches a power of two, up to 12 bits, and
  no new entries once 4096 are defined (a clear code may come later, or
  never). cv2 reads codes from the data sub-blocks as the bytes come; an
  end code pauses it until the next byte, so data after the end code is
  read as more codes. It fails on a code that starts past the image's last
  pixel and on data that ends before that pixel (a string that runs past it
  is cut there);
* interlaced rows (every 8th from 0, every 8th from 4, every 4th from 2,
  every 2nd from 1).

cv2 walks every block of the file up to its trailer first: a file cut short
anywhere, a block of unknown type, an image that does not fit the screen, a
minimum code size outside 2-8 or a background index past the global table
makes it fail. Where cv2 fails the port raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

SIGNATURES = (b"GIF87a", b"GIF89a")


def _sub_blocks(data: bytes, pos: int, path: str) -> Tuple[bytes, int]:
    """The data of the sub-blocks from ``pos`` up to their terminator, and
    the offset after it."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: GIF cut short inside its data sub-blocks")
        n = data[pos]
        pos += 1
        if not n:
            return b"".join(out), pos
        if pos + n > len(data):
            raise ValueError(f"{path}: GIF cut short inside its data sub-blocks")
        out.append(data[pos:pos + n])
        pos += n


def _table(data: bytes, pos: int, flags: int, path: str) -> Tuple[Optional[np.ndarray], int]:
    """A colour table after a descriptor whose ``flags`` announce it (bit 7,
    size 2^(bits 0-2 + 1)): ((entries, 3) uint8 or None, offset after it)."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    raw = data[pos:pos + 3 * n]
    if len(raw) != 3 * n:
        raise ValueError(f"{path}: GIF cut short inside a colour table")
    return np.frombuffer(raw, np.uint8).reshape(n, 3), pos + 3 * n


def lzw_decode(data: bytes, min_size: int, total: int, path: str = "<bytes>") -> bytes:
    """GIF LZW codes, least significant bit first, -> ``total`` indices as
    cv2's decoder reads them (see the module's docstring)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    table: List[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    width, prev = min_size + 1, None
    out = bytearray()
    src = left = 0
    for byte in data:
        src |= byte << left
        left += 8
        while left >= width:
            code = src & ((1 << width) - 1)
            src >>= width
            left -= width
            if code == clear:
                del table[clear + 2:]
                width, prev = min_size + 1, None
                continue
            if code == end:
                break
            if len(out) >= total:
                raise ValueError(f"{path}: GIF data goes on past the image's last pixel")
            if prev is None:
                if code >= clear:
                    raise ValueError(f"{path}: GIF code {code} names no string")
                s = table[code]
            else:
                if code < len(table):
                    s = table[code]
                    entry = table[prev] + s[:1]
                elif code == len(table):
                    entry = s = table[prev] + table[prev][:1]
                else:
                    raise ValueError(f"{path}: GIF code {code} names no string")
                if len(table) < 4096:
                    table.append(entry)
                    if len(table) == 1 << width and width < 12:
                        width += 1
            out += s
            prev = code
    if len(out) < total:
        raise ValueError(f"{path}: GIF data ends before the image's last pixel")
    return bytes(out[:total])


def _interlaced_rows(h: int) -> np.ndarray:
    """The image row each coded row of an interlaced image goes to."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def decode_gif(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A GIF -> (H, W, 3) uint8 RGB of its first image, equal to cv2's
    decode (see the module's docstring)."""
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ValueError(f"{path}: not a GIF")
    w, h, flags, bg = struct.unpack("<HHBB", data[6:12])
    gct, pos = _table(data, 13, flags, path)
    if gct is not None and bg >= len(gct):
        raise ValueError(f"{path}: GIF background index {bg} past its {len(gct)}-entry table")
    image, transparent = None, None
    while True:  # every block up to the trailer, as cv2 walks them
        if pos >= len(data):
            raise ValueError(f"{path}: GIF without its trailer")
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ValueError(f"{path}: GIF cut short inside an extension")
            body, end = _sub_blocks(data, pos + 2, path)
            if image is None and data[pos + 1] == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            pos = end
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise ValueError(f"{path}: GIF cut short inside an image descriptor")
            left, top, fw, fh, fflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            lct, pos = _table(data, pos + 10, fflags, path)
            if pos >= len(data):
                raise ValueError(f"{path}: GIF cut short before its image data")
            min_size = data[pos]
            lzw, pos = _sub_blocks(data, pos + 1, path)
            if image is None:
                image = (left, top, fw, fh, fflags, lct, min_size, lzw, transparent)
        else:
            raise ValueError(f"{path}: GIF block of unknown type {kind:#04x}")
    if image is None:
        raise ValueError(f"{path}: GIF without an image")
    left, top, fw, fh, fflags, lct, min_size, lzw, transparent = image
    if not fw or not fh or left + fw > w or top + fh > h:
        raise ValueError(f"{path}: GIF image {fw}x{fh} at ({left}, {top}) outside its "
                         f"{w}x{h} screen")
    if not 2 <= min_size <= 8:
        raise ValueError(f"{path}: GIF LZW minimum code size {min_size} (cv2 reads 2-8)")
    if gct is None and lct is None:
        colours = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        colours[1] = 255
    else:
        colours = np.zeros((256, 3), np.uint8)
        for t in (gct, lct):
            if t is not None:
                colours[:len(t)] = t
        colours = colours[:max(len(t) for t in (gct, lct) if t is not None)]
    idx = np.frombuffer(lzw_decode(lzw, min_size, fw * fh, path), np.uint8).reshape(fh, fw)
    if int(idx.max()) >= len(colours):
        raise ValueError(f"{path}: GIF index {int(idx.max())} past its {len(colours)}-entry "
                         "colour table")
    if fflags & 0x40:
        rows = np.empty_like(idx)
        rows[_interlaced_rows(fh)] = idx
        idx = rows
    background = gct[bg] if gct is not None else np.zeros(3, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    out[:] = background
    frame = colours[idx]
    if transparent is not None:
        frame[idx == transparent] = background
    out[top:top + fh, left:left + fw] = frame
    return out

"""Page images without cv2: PNG and JPEG in, PNG out, and cv2's bilinear
resize.

The reference reads pages with ``cv2.imread(path, cv2.IMREAD_COLOR)``,
LMDB crops with ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``, and resizes with
``cv2.resize`` (``INTER_LINEAR``); the card's machine has no cv2, so the
port does all three here, with the standard library's ``zlib`` and numpy:

* ``decode_image`` (bytes) and ``read_image`` (a path) dispatch on the
  file's signature. PNG: 8-bit, non-interlaced, colour type grey, grey with
  alpha, RGB or RGBA, any of the five row filters. JPEG: baseline,
  extended sequential and progressive Huffman (``data/jpeg.py``). Either -> (H, W, 3) uint8
  RGB, bit-equal to ``cv2.imread``/``cv2.imdecode`` then
  ``cv2.cvtColor(BGR2RGB)`` (grey repeated into the three channels, alpha
  dropped, a JPEG's EXIF orientation applied). Any other file raises
  ``NotImplementedError``; a damaged one ``ValueError``.
* ``encode_png`` / ``write_png``: (H, W) grey, (H, W, 3) RGB or (H, W, 4)
  RGBA uint8 -> PNG bytes / a PNG file, each row with a filter from
  ``filters`` in turn.
* ``resize_linear``: cv2's ``INTER_LINEAR`` geometry (half-pixel centres,
  edge clamping, no antialiasing when shrinking), bit-equal to cv2 on uint8
  (its 11-bit fixed-point passes) and on float32 (cv2's own steps: rows
  first, then columns, each ``a + f * (b - a)`` with one rounding and f the
  float64 weight rounded to float32; a one-row source through cv2's
  separate route).
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

from .jpeg import decode_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
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


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file as (H, W, 3) uint8 RGB (see the module's docstring)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def decode_image(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Encoded PNG or JPEG bytes -> (H, W, 3) uint8 RGB, the counterpart of
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` then ``cvtColor(BGR2RGB)``;
    ``path`` names the source in errors."""
    data = bytes(data)
    if data.startswith(b"\xff\xd8"):
        return decode_jpeg(data, path)
    if not data.startswith(_SIGNATURE):
        raise NotImplementedError(f"{path}: neither PNG nor JPEG (only those are read)")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, interlace {interlace}: "
            "only 8-bit, non-interlaced grey, grey+alpha, RGB and RGBA are read")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unknown PNG compression {compression} or filter "
                         f"method {filtering}")
    ch = _CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch, path).reshape(h, w, ch)
    if ch <= 2:  # grey (+ alpha): the grey level in all three channels
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


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

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, filters: Sequence[int] = (1,)) -> None:
    """Write ``encode_png(image, filters)`` to ``path``."""
    data = encode_png(image, filters)
    with open(path, "wb") as f:
        f.write(data)


def _taps(n_out: int, n_in: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's INTER_LINEAR source taps along one axis: (i0, i1, weight of i1)."""
    scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = np.where(i0 >= n_in - 1, 0.0, frac)
    return i0, i1, frac


def _fracs(n_out: int, n_in: int, zero_edges: bool) -> Tuple[np.ndarray, ...]:
    """cv2's INTER_LINEAR taps along one axis in its float32 arithmetic:
    (i0, i1, weight of i1). Along x a tap past either edge is clamped and
    takes all the weight on one pixel; along y (``zero_edges=False``) only
    the row indices are clamped, so the weight stays split between two
    copies of one row."""
    scale = n_in / n_out
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if zero_edges:
        f = np.where((i0 < 0) | (i0 >= n_in - 1), np.float32(0), f)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), f


def _taps_fixed(n_out: int, n_in: int, zero_edges: bool) -> Tuple[np.ndarray, ...]:
    """``_fracs`` with the weights in cv2's 11-bit fixed point, each rounded
    on its own: (i0, i1, w0, w1)."""
    i0, i1, f = _fracs(n_out, n_in, zero_edges)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return i0, i1, w0, w1


def _resize_one_row(image: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """cv2's float32 route for a one-row source: float32 taps, a product
    and a sum each rounded to float32 along x, and along y the row weighed
    twice, as ``S * b0 + S * b1``."""
    x0, x1, fx = _fracs(w_out, image.shape[1], zero_edges=True)
    _, _, fy = _fracs(h_out, 1, zero_edges=False)
    row = image[0, x0] * (np.float32(1) - fx)[:, None] + image[0, x1] * fx[:, None]
    return row[None] * (np.float32(1) - fy)[:, None, None] + row[None] * fy[:, None, None]


def _lerp32(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """float32 ``a + f * (b - a)`` rounded once (a fused multiply-add: the
    float64 product of two float32 values is exact)."""
    return (f.astype(np.float32).astype(np.float64) * (b - a) + a).astype(np.float32)


def resize_linear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 or float32 -> (size[1], size[0], C) or
    (size[1], size[0]) of the same type,
    ``size`` = (width, height) as ``cv2.resize`` takes it, with cv2's
    INTER_LINEAR geometry and arithmetic (on uint8 its fixed-point passes)."""
    if image.ndim == 2:
        return resize_linear(image[..., None], size)[..., 0]
    w_out, h_out = size
    h, w = image.shape[:2]
    if (h_out, w_out) == (h, w):  # every tap lands on its own pixel: cv2 copies
        return image.copy()
    if image.dtype == np.float32 and h == 1:
        return _resize_one_row(image, w_out, h_out)
    if image.dtype == np.float32:
        y0, y1, fy = _taps(h_out, h)
        x0, x1, fx = _taps(w_out, w)
        cols = _lerp32(image[:, x0], image[:, x1], fx[None, :, None])
        return _lerp32(cols[y0], cols[y1], fy[:, None, None])
    if image.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 or float32 images, got {image.dtype}")
    x0, x1, a0, a1 = _taps_fixed(w_out, w, zero_edges=True)
    y0, y1, b0, b1 = _taps_fixed(h_out, h, zero_edges=False)
    img = image.astype(np.int64)
    rows = np.unique(np.concatenate([y0, y1]))  # the horizontal pass, on used rows only
    s = np.zeros((h, w_out, image.shape[2]), np.int64)
    s[rows] = img[rows][:, x0] * a0[:, None] + img[rows][:, x1] * a1[:, None]
    # the vertical pass rounds as cv2's SIMD path does: each product's top
    # 16 bits of (weight * (S >> 4)), then (sum + 2) >> 2
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((b0 * (s[y0] >> 4)) >> 16) + ((b1 * (s[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)

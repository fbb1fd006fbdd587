"""Page images without cv2: PNG, JPEG, JPEG 2000, BMP, PNM, PFM, Sun raster,
Radiance HDR, GIF, TIFF and WebP in, PNG out, and cv2's resizes.

The reference reads pages with ``cv2.imread(path, cv2.IMREAD_COLOR)``,
LMDB crops with ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``, and resizes with
``cv2.resize``; the card's machine has no cv2, so the port does these here,
with the standard library's ``zlib`` and numpy:

* ``decode_image`` (bytes) and ``read_image`` (a path) dispatch on the
  file's signature, as cv2 does: PNG (``data/png.py``: every bit depth,
  colour type and interlace, an ``eXIf`` orientation), JPEG
  (``data/jpeg.py``: baseline, extended sequential in one scan or several,
  progressive Huffman; grey, YCbCr, RGB, CMYK and YCCK; markers after the
  last scan; block smoothing of unrefined progressive scans; an EXIF
  orientation), JPEG 2000 (``data/jp2.py``: JP2 files and raw codestreams
  as OpenJPEG decodes them, ``data/j2k.py``, ``data/ebcot.py``,
  ``data/dwt.py``; then cv2's step to 8 bits), BMP, PNM, PFM and Sun
  raster (``data/bitmap.py``), Radiance
  HDR (``data/radiance.py``: run-length or flat RGBE, scaled by 255 as cv2
  converts it), GIF (``data/gif.py``: the first image), TIFF
  (``data/tiff.py``: the first image, uncompressed, CCITT fax
  (``data/fax.py``), LZW (old-style too), Deflate, PackBits or JPEG;
  YCbCr and CIE L*a*b* (``data/cielab.py``) as libtiff converts them,
  signed samples as unsigned) and WebP (``data/webp.py``: lossless ``data/vp8l.py`` and
  lossy ``data/vp8.py`` bitstreams, simple or VP8X containers with ALPH and
  EXIF, the first frame of an animation; any data whose first 32 bytes
  libwebp takes for WebP, as cv2 tells it by them).
  Each -> (H, W, 3) uint8 RGB, bit-equal to ``cv2.imread``/``cv2.imdecode``
  then ``cv2.cvtColor(BGR2RGB)``. The two differ on a JPEG that runs to the
  end of the file without EOI, whole or cut inside its data: ``read_image``
  reads it, as ``cv2.imread`` does (libjpeg's grey rest), and
  ``decode_image`` only where ``cv2.imdecode`` does (``jpeg.decode_jpeg``);
  on a TIFF of uncompressed tiles, which ``cv2.imdecode`` refuses unless a
  tile holds a multiple of 1024 bytes; and on a grey PFM, which only
  ``cv2.imdecode`` reads. Any other format raises ``NotImplementedError``;
  a damaged file, or one that cv2 refuses, ``ValueError``.
* ``encode_png`` / ``write_png`` (``data/png.py``): (H, W) grey,
  (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes / a PNG file, each
  row with a filter from ``filters`` in turn.
* ``resize_linear``: cv2's ``INTER_LINEAR`` geometry (half-pixel centres,
  edge clamping, no antialiasing when shrinking), bit-equal to cv2 on uint8
  (its 11-bit fixed-point passes) and on float32 (cv2's own steps: rows
  first, then columns, each ``a + f * (b - a)`` with one rounding and f the
  float64 weight rounded to float32; a one-row source through cv2's
  separate route); ``resize_cubic`` and ``resize_area`` below.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .bitmap import SUNRAS_SIGNATURE, decode_bmp, decode_pfm, decode_pnm, decode_sunras, is_pfm
from .gif import SIGNATURES as _GIF, decode_gif
from .jp2 import decode_jpeg2000, is_jpeg2000
from .jpeg import decode_jpeg
from .png import SIGNATURE as _PNG, decode_png, encode_png, write_png
from .radiance import decode_hdr, is_hdr
from .tiff import SIGNATURES as _TIFF, decode_tiff
from .webp import decode_webp, is_webp

__all__ = ["decode_image", "read_image", "encode_png", "write_png", "resize_linear",
           "resize_cubic", "resize_area"]


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, as ``cv2.imread(path,
    IMREAD_COLOR)`` then ``BGR2RGB`` reads it (see the module's docstring)."""
    with open(path, "rb") as f:
        return _decode(f.read(), path, True)


def decode_image(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, the counterpart of
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` then ``cvtColor(BGR2RGB)``;
    ``path`` names the source in errors."""
    return _decode(bytes(data), path, False)


def _decode(data: bytes, path: str, from_file: bool) -> np.ndarray:
    if data.startswith(b"\xff\xd8"):
        return decode_jpeg(data, path, from_file)
    if is_jpeg2000(data):
        return decode_jpeg2000(data, path)
    if data.startswith(_PNG):
        return decode_png(data, path)
    if data.startswith(b"BM"):
        return decode_bmp(data, path)
    if is_hdr(data):
        return decode_hdr(data, path)
    if is_webp(data):  # cv2 asks libwebp before its PNM, TIFF, PNG and GIF readers
        return decode_webp(data, path)
    if data.startswith(SUNRAS_SIGNATURE):
        return decode_sunras(data, path)
    if len(data) > 2 and data[0] == 80 and 49 <= data[1] <= 54 and data[2] in b" \t\n\v\f\r":
        return decode_pnm(data, path)
    if is_pfm(data):
        return decode_pfm(data, path, from_file)
    if data[:6] in _GIF:
        return decode_gif(data, path)
    if data[:4] in _TIFF:
        return decode_tiff(data, path, from_file)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data, path)  # refused: fewer than 32 bytes, or a broken header
    raise NotImplementedError(f"{path}: not PNG, JPEG, JPEG 2000, BMP, PNM, PFM, Sun raster, "
                              "Radiance HDR, GIF, TIFF or WebP (only those are read)")


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



# ------------------------------------------------------------------ cubic
_F32 = np.float32
_A = -0.75  # cv2's cubic: Keys' kernel with a = -0.75


def _keys(x: np.ndarray) -> np.ndarray:
    """The four cubic weights at fraction ``x``, in float64: (n, 4)."""
    x = np.asarray(x, np.float64)
    return np.stack([_A * x ** 3 - 2 * _A * x ** 2 + _A * x,
                     (_A + 2) * x ** 3 - (_A + 3) * x ** 2 + 1,
                     -(_A + 2) * x ** 3 + (2 * _A + 3) * x ** 2 - _A * x,
                     -_A * x ** 3 + _A * x ** 2], -1)


def _ipp_taps(n_out: int, n_in: int):
    """IPP's cubic taps along one axis: (n_out, 4) clamped source indices,
    (n_out, 4) float32 weights and whether the taps leave the source. The
    source point is float64, its fraction rounded to float32 and then to the
    grid of ``1 + fraction`` in float32 (2^-23); the weights are the float64
    kernel there, rounded to float32."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(pos).astype(np.int64)
    x = (_F32(1) + _F32(pos - s)).astype(_F32) - _F32(1)
    idx = s[:, None] + np.arange(-1, 3)
    edge = (idx.min(1) < 0) | (idx.max(1) > n_in - 1)
    return np.clip(idx, 0, n_in - 1), _keys(x).astype(_F32), edge


def _cv_taps(n_out: int, n_in: int):
    """cv2's own cubic taps (``interpolateCubic`` in float32): (n_out, 4)
    clamped source indices and float32 weights."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(_F32)).astype(_F32)
    one, a = _F32(1), _F32(_A)
    x1, omx = x + one, one - x
    c0 = ((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1 - _F32(4) * a
    c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + one
    c2 = ((a + _F32(2)) * omx - (a + _F32(3))) * omx * omx + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(_F32)


def resize_cubic(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, size, interpolation=INTER_CUBIC)`` of an (H, W, 3)
    float32 image, ``size`` = (width, height), bit for bit. cv2 5 hands a
    source of 4 or more rows and columns to IPP (``_resize_cubic_ipp``) and
    resizes a smaller one itself (``_resize_cubic_cv``); edges replicate."""
    if image.dtype != np.float32 or image.ndim != 3 or image.shape[2] != 3:
        raise TypeError(f"resize_cubic takes (H, W, 3) float32 images, got {image.dtype} "
                        f"{image.shape}")
    w_out, h_out = (int(v) for v in size)
    h, w = image.shape[:2]
    if (h, w) == (h_out, w_out):
        return image.copy()
    if h < 4 or w < 4:
        return _resize_cubic_cv(image, w_out, h_out)
    return _resize_cubic_ipp(image, w_out, h_out)


def _resize_cubic_cv(image: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """cv2's ``resizeGeneric_``: along each row the four products summed left
    to right; down the columns ``b0 S0 + (b1 S1 + (b2 S2 + b3 S3))`` over the
    row's first floats in groups of 4, left to right over the last
    ``3 w_out % 4``."""
    h = image.shape[0]
    xi, xc = _cv_taps(w_out, image.shape[1])
    yi, yc = _cv_taps(h_out, h)
    S = image[:, xi]  # (h, w_out, 4, 3)
    p = [S[:, :, k] * xc[None, :, k, None] for k in range(4)]
    rows = ((p[0] + p[1]) + p[2]) + p[3]
    R = rows[yi]  # (h_out, 4, w_out, 3)
    q = [R[:, k] * yc[:, k, None, None] for k in range(4)]
    vec = q[0] + (q[1] + (q[2] + q[3]))
    tail = ((q[0] + q[1]) + q[2]) + q[3]
    n = w_out * 3
    head = (np.arange(n) < n - n % 4).reshape(w_out, 3)
    return np.where(head[None], vec, tail)


def _resize_cubic_ipp(image: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """IPP's cubic resize of a 3-channel float32 image, as found on probes of
    cv2 5.0.0: the taps of ``_ipp_taps``; a row pass over each source row,
    then a column pass, in float32 with fused multiply-adds (``fma32``).
    Output pixels whose taps all lie inside the source (both axes) take the
    inner code: rows ``fma(S1, c1, S2 c2) + fma(S0, c0, S3 c3)``, columns
    ``fma(R0, b0, R1 b1) + fma(R2, b2, R3 b3)``, but the last ``n % 4`` of
    the n inner floats of a row ``fma(R1, b1, R0 b0) + fma(R2, b2, R3 b3)``.
    The others take the border code: source rows 0 and 3 of the four
    ``fma(S3, c3, fma(S2, c2, fma(S1, c1, S0 c0)))``, rows 1 and 2
    ``fma(S3, c3, fma(S2, c2, fma(S0, c0, S1 c1)))``, then
    ``(R0 b0 + R2 b2) + (R1 b1 + R3 b3)``."""
    from .raster import fma32  # raster imports the visualizer, which imports this module

    xi, xc, xe = _ipp_taps(w_out, image.shape[1])
    yi, yc, ye = _ipp_taps(h_out, image.shape[0])
    S = image[:, xi]  # (h, w_out, 4, 3)
    c = xc[None, :, :, None]
    S0, S1, S2, S3 = (S[:, :, k] for k in range(4))
    c0, c1, c2, c3 = (c[:, :, k] for k in range(4))
    p0, p1, p2, p3 = S0 * c0, S1 * c1, S2 * c2, S3 * c3
    row_inner = fma32(S1, c1, p2) + fma32(S0, c0, p3)
    row_a = fma32(S3, c3, fma32(S2, c2, fma32(S1, c1, p0)))
    row_b = fma32(S3, c3, fma32(S2, c2, fma32(S0, c0, p1)))
    out = np.empty((len(yi), len(xi), 3), _F32)
    rows_in, cols_in = np.flatnonzero(~ye), np.flatnonzero(~xe)  # each one run
    if len(rows_in) and len(cols_in):
        r, c = slice(rows_in[0], rows_in[-1] + 1), slice(cols_in[0], cols_in[-1] + 1)
        R = [row_inner[yi[r, k]][:, c] for k in range(4)]
        b = [yc[r, k, None, None] for k in range(4)]
        q1, q3 = R[1] * b[1], R[3] * b[3]
        block = fma32(R[0], b[0], q1) + fma32(R[2], b[2], q3)
        n = 3 * len(cols_in)
        if n % 4:  # the last floats, at most the last two pixels
            tail = fma32(R[1][:, -2:], b[1], R[0][:, -2:] * b[0]) + fma32(R[2][:, -2:], b[2],
                                                                        q3[:, -2:])
            e = np.arange(n).reshape(-1, 3)[-2:] >= n - n % 4
            block[:, -2:] = np.where(e, tail, block[:, -2:])
        out[r, c] = block

    def border(rows, cols):
        R = [(row_a, row_b, row_b, row_a)[k][yi[rows, k]][:, cols] for k in range(4)]
        q = [R[k] * yc[rows, k, None, None] for k in range(4)]
        out[np.ix_(rows, cols)] = (q[0] + q[2]) + (q[1] + q[3])

    every = np.arange(len(xi))
    border(np.flatnonzero(ye), every)
    border(rows_in, np.flatnonzero(xe))
    return out


# ------------------------------------------------------------------- area
def _area_table(n_in: int, n_out: int, scale: float):
    """cv2's ``computeResizeAreaTab``: (destination, source, float32 weight)
    for each overlap, in cv2's order."""
    tab = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, (s1 - f1) / cell))
        for si in range(s1, s2):
            tab.append((d, si, 1.0 / cell))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, min(min(f2 - s2, 1.0), cell) / cell))
    d, si, wt = (np.array(v) for v in zip(*tab))
    return d, si, wt.astype(_F32)


def _area_sums(values: np.ndarray, d: np.ndarray, si: np.ndarray, wt: np.ndarray,
               n_out: int) -> np.ndarray:
    """sum over the table's entries for each destination of
    ``values[si] * wt`` along axis 0, in float32, each destination's terms
    added in table order (the k-th term of every destination at once)."""
    first = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
    rank = np.arange(len(d)) - np.repeat(first, np.diff(np.r_[first, len(d)]))
    out = np.zeros((n_out,) + values.shape[1:], _F32)
    for k in range(int(rank.max()) + 1):
        m = rank == k
        w = wt[m].reshape((-1,) + (1,) * (values.ndim - 1))
        out[d[m]] = out[d[m]] + values[si[m]] * w
    return out


def resize_area(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, size, interpolation=INTER_AREA)`` shrinking an
    (H, W, C) or (H, W) uint8 image, ``size`` = (width, height), bit for
    bit. Both factors exactly 2: ``(a + b + c + d + 2) >> 2`` of each 2x2.
    Otherwise cv2's ``resizeArea_``: each source row summed into a float32
    row by the x table, each destination row the sum of those rows times
    the y table's float32 weights, in table order, rounded half to even."""
    if image.ndim == 2:
        return resize_area(image[..., None], size)[..., 0]
    if image.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8 images, got {image.dtype}")
    w_out, h_out = (int(v) for v in size)
    h, w = image.shape[:2]
    if w_out > w or h_out > h:
        raise ValueError(f"resize_area shrinks: {w}x{h} -> {w_out}x{h_out}")
    if (h, w) == (h_out, w_out):
        return image.copy()
    sx, sy = 1.0 / (w_out / w), 1.0 / (h_out / h)
    if sx == 2 and sy == 2:
        x = image.astype(np.int64)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xd, xs, xw = _area_table(w, w_out, sx)
    yd, ys, yw = _area_table(h, h_out, sy)
    rows = _area_sums(image.astype(_F32)[ys].transpose(1, 0, 2), xd, xs, xw, w_out)
    out = _area_sums(rows.transpose(1, 0, 2), yd, np.arange(len(yd)), yw, h_out)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)

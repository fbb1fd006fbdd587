"""TIFF in numpy and the standard library's ``zlib``, bit-equal to
``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR`` then
``cv2.cvtColor(BGR2RGB)``.

cv2 reads TIFF through libtiff and, for an 8-bit result, through libtiff's
RGBA interface (``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), whose rules
``decode_tiff`` copies, as probed on cv2 5.0.0 (libtiff 4.7):

* the first IFD of a classic (``II*\\0``, ``MM\\0*``) or BigTIFF (``II+\\0``,
  ``MM\\0+``) file; strips or tiles, PlanarConfiguration 1 (contiguous) or
  2 (one plane a sample); FillOrder 2 (bits reversed in each byte);
* compressions 1 (none), 2, 3 and 4 (CCITT modified Huffman, T.4 and
  T.6 of 1-bit samples, decoded by ``data/fax.py`` as libtiff decodes them,
  damaged data included), 5 (LZW, codes most significant bit first, one
  bit wider one code early), 8 and 32946 (Deflate) and 32773 (PackBits);
  Predictor 2 (horizontal differencing of 8- or 16-bit samples) undone
  after LZW and Deflate only, as libtiff ignores it with the others;
* compression 7 (JPEG): each strip or tile a JPEG stream read after the
  ``JPEGTables`` tag, decoded by ``data/jpeg.py``; photometric YCbCr to RGB
  by libjpeg (libtiff's ``JPEGCOLORMODE_RGB``), grey and RGB as coded; the
  first component's sampling that of YCbCrSubsampling (or, without the tag,
  of the first strip) and 1x1 for the others, as libtiff checks;
* photometric 0 and 1 (grey, min-is-white inverted) at 1, 8 and 16 bits,
  16 bits by their high byte, with any extra samples ignored; 2 (RGB) at
  8 or 16 bits, 16 bits rounded to 8 (``(v + 128) // 257``); 3 (palette)
  at 1, 4 or 8 bits, a colormap whose entries are all below 256 taken as
  8-bit, else by its high bytes; 5 (CMYK, InkSet 1) at 8 bits, each of
  red, green and blue ``(255 - k) * (255 - ink) // 255``. Planar grey with
  alpha is read as libtiff reads a separate plane (neither inverted nor by
  its high byte). An RGB alpha sample (ExtraSamples: unassociated 2, or
  associated 1, or unspecified with four samples or more, or none at all
  with exactly four) is dropped, unassociated alpha after premultiplying
  each colour ``(c * a + 127) // 255``; 6 (YCbCr, not JPEG-compressed)
  at 8 bits, three samples, by libtiff's ``TIFFYCbCrToRGB`` tables
  (YCbCrCoefficients and ReferenceBlackWhite in float32, chroma weights in
  16-bit fixed point), its units read as ``_ycbcr_samples`` says;
* the Orientation tag applied as cv2 applies an EXIF orientation.

Depths, photometric interpretations, sample formats and predictors that
cv2 refuses (2-bit samples, 4-bit grey, 16-bit palette or CMYK, ICC and
ITU L*a*b*, floating-point samples, the floating-point Predictor 3, ...)
and damaged files raise ``ValueError``; compressions, photometric
interpretations and sample formats that cv2 reads and these do not
(old-style JPEG, CIE L*a*b*, signed samples, Predictor 2 on subsampled
YCbCr, ...) raise ``NotImplementedError`` naming what was met.
``cv2.imdecode`` alone also refuses uncompressed tiles whose pixel count
is not a multiple of 1024 (``decode_tiff(from_file=False)``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from . import fax
from .jpeg import apply_orientation, decode_tiff_strip

SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")

#: field type -> (struct code, bytes) of the integer types; others are kept raw
_INTEGER_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
                  9: ("i", 4), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_TYPE_SIZES = {2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8}

_COMPRESSIONS = {6: "old-style JPEG", 32766: "NeXT RLE",
                 32771: "CCITT RLEW", 32809: "ThunderScan RLE", 34676: "SGI LogL",
                 34677: "SGI LogLuv", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                 50000: "Zstandard", 50001: "WebP", 50002: "JPEG XL"}
_PHOTOMETRICS = {4: "transparency mask", 8: "CIE L*a*b*", 32803: "colour filter array",
                 32844: "SGI LogL", 32845: "SGI LogLuv", 34892: "linear raw"}
_SAMPLE_FORMATS = {2: "signed integer", 4: "untyped", 5: "complex signed integer",
                   6: "complex floating point"}
# what cv2 refuses (its libtiff RGBA reader does): ValueError
_REFUSED_PHOTOMETRICS = {9: "ICC L*a*b*", 10: "ITU L*a*b*"}
_REFUSED_SAMPLE_FORMATS = {3: "IEEE floating point"}
_YCBCR_SAMPLINGS = ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2))
_REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _ifd(data: bytes, path: str) -> Tuple[Dict[int, list], str]:
    """The first IFD's tags -> (tag -> values, byte order)."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    try:
        if big:
            offset_size, _, first = struct.unpack(order + "HHQ", data[4:16])
            if offset_size != 8:
                raise ValueError(f"{path}: BigTIFF offsets of {offset_size} bytes")
            (n,) = struct.unpack(order + "Q", data[first:first + 8])
            at, entry, inline = first + 8, 20, 8
        else:
            (first,) = struct.unpack(order + "I", data[4:8])
            (n,) = struct.unpack(order + "H", data[first:first + 2])
            at, entry, inline = first + 2, 12, 4
        if at + entry * n > len(data):  # libtiff reads the entries in one piece
            raise ValueError(f"{path}: TIFF cut short inside its first IFD")
        tags: Dict[int, list] = {}
        for i in range(n):
            e = data[at + entry * i:at + entry * (i + 1)]
            if big:
                tag, kind, count = struct.unpack(order + "HHQ", e[:12])
            else:
                tag, kind, count = struct.unpack(order + "HHI", e[:8])
            value = e[entry - inline:]
            code, size = _INTEGER_TYPES.get(kind, (None, _TYPE_SIZES.get(kind, 1)))
            if count * size > inline:
                (off,) = struct.unpack(order + ("Q" if big else "I"), value)
                value = data[off:off + count * size]
                if len(value) != count * size:
                    raise ValueError(f"{path}: TIFF tag {tag} points past the file's end")
            if code:
                tags[tag] = list(struct.unpack(order + code * count, value[:count * size]))
            elif kind == 7:  # UNDEFINED bytes (JPEGTables)
                tags[tag] = list(value[:count])
            elif kind == 5:  # RATIONAL, as libtiff reads a float field (x / 0 reads 0)
                pairs = struct.unpack(order + "II" * count, value[:8 * count])
                tags[tag] = [float(np.float32(a) / np.float32(b)) if b else 0.0
                             for a, b in zip(pairs[::2], pairs[1::2])]
    except struct.error:
        raise ValueError(f"{path}: TIFF cut short inside its first IFD") from None
    return tags, order


def _lzw(data: bytes, size: int, path: str) -> bytes:
    """TIFF LZW (libtiff's ``LZWDecode``) -> at least ``size`` bytes: codes
    most significant bit first, 9 to 12 bits, one bit wider when the next
    free entry reaches 2^bits - 1; a clear code first and after every reset."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise NotImplementedError(f"{path}: old-style (LSB-first) TIFF LZW")
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev = 9, -1  # -1: before the first clear code
    out = bytearray()
    acc = left = 0
    for byte in data:
        acc = (acc << 8) | byte
        left += 8
        while left >= width:
            left -= width
            code = acc >> left
            acc &= (1 << left) - 1
            if code == 256:
                del table[258:]
                width, prev = 9, None
                continue
            if code == 257:
                return _enough(out, size, path)
            if prev is None:
                if code > 256:
                    raise ValueError(f"{path}: corrupted TIFF LZW data")
                out += table[code]
            else:
                if prev < 0 or len(table) >= 4096:
                    raise ValueError(f"{path}: corrupted TIFF LZW data")
                if code < len(table):
                    s = table[code]
                    table.append(table[prev] + s[:1])
                elif code == len(table):
                    s = table[prev] + table[prev][:1]
                    table.append(s)
                else:
                    raise ValueError(f"{path}: corrupted TIFF LZW data")
                if len(table) == (1 << width) - 1 and width < 12:
                    width += 1
                out += s
            prev = code
            if len(out) >= size:
                return bytes(out[:size])
    return _enough(out, size, path)


def _enough(out: bytearray, size: int, path: str) -> bytes:
    if len(out) < size:
        raise ValueError(f"{path}: TIFF strip or tile data ends early")
    return bytes(out[:size])


def _packbits(data: bytes, size: int, path: str) -> bytes:
    out = bytearray()
    i = 0
    while len(out) < size:
        if i >= len(data):
            raise ValueError(f"{path}: TIFF PackBits data ends early")
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            if i >= len(data):
                raise ValueError(f"{path}: TIFF PackBits data ends early")
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out[:size])


def _inflate(data: bytes, size: int, path: str) -> bytes:
    try:
        out = zlib.decompressobj().decompress(data, size)
    except zlib.error:
        raise ValueError(f"{path}: TIFF Deflate data is damaged") from None
    return _enough(bytearray(out), size, path)


_DECODERS = {1: lambda d, n, p: _enough(bytearray(d[:n]), n, p), 5: _lzw, 8: _inflate,
             32946: _inflate, 32773: _packbits}


def _layout(tags: Dict[int, list], h: int, w: int, planes: int, path: str):
    """(tiled, chunk width, chunk length, offsets, byte counts) of the
    strips or tiles, checked to cover the image ``planes`` times."""
    tiled = 322 in tags
    if tiled:
        tw, tl = tags[322][0], tags.get(323, [0])[0]
        offsets, counts = tags.get(324, []), tags.get(325, [])
    else:
        tw, tl = w, min(tags.get(278, [h])[0], h)
        offsets, counts = tags.get(273, []), tags.get(279, [])
    if not tw or not tl:
        raise ValueError(f"{path}: TIFF strips or tiles of no size")
    if len(offsets) < -(-w // tw) * -(-h // tl) * planes or len(counts) < len(offsets):
        raise ValueError(f"{path}: TIFF lacks strip or tile offsets")
    return tiled, tw, tl, offsets, counts


def _jpeg_samples(data: bytes, tags: Dict[int, list], h: int, w: int, spp: int, ycc: bool,
                  path: str) -> np.ndarray:
    """Every strip or tile of a JPEG-compressed TIFF (compression 7,
    contiguous samples) -> (h, w, 3 or spp) int64: each an abbreviated or
    whole JPEG stream read after the ``JPEGTables`` tag (347), decoded by
    ``jpeg.decode_tiff_strip``. libtiff's checks: the first component's
    sampling factors are YCbCrSubsampling's (tag 530, or, without it, the
    first strip's own) for YCbCr and 1x1 otherwise, the other components'
    1x1; a strip or tile as large as its segment, or a last strip that is
    taller."""
    tables = bytes(tags.get(347, []))
    flip = tags.get(266, [1])[0] == 2
    tiled, tw, tl, offsets, counts = _layout(tags, h, w, 1, path)
    across, down = -(-w // tw), -(-h // tl)
    sampling = tuple(tags[530][:2]) if ycc and 530 in tags else None
    out = np.zeros((down * tl, across * tw, 3 if ycc else spp), np.int64)
    for k in range(across * down):
        ty, tx = divmod(k, across)
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        if flip:
            chunk = chunk.translate(_REVERSED_BITS)
        img, factors = decode_tiff_strip(chunk, tables, ycc, path)
        if len(factors) != spp:
            raise ValueError(f"{path}: TIFF JPEG strip of {len(factors)} components, {spp} "
                             "samples a pixel")
        if sampling is None:
            sampling = factors[0] if ycc else (1, 1)
        if factors[0] != sampling or any(f != (1, 1) for f in factors[1:]):
            raise ValueError(f"{path}: TIFF JPEG sampling factors {factors}, {sampling} expected "
                             "(cv2 refuses the file)")
        rows = tl if tiled else min(tl, h - ty * tl)
        jh, jw = img.shape[:2]
        taller_last = not tiled and jw == tw and jh > rows and ty == down - 1
        if (jh, jw) != (rows, tw) and not taller_last:
            raise ValueError(f"{path}: TIFF JPEG strip or tile of {jw}x{jh}, {tw}x{rows} "
                             "expected")
        out[ty * tl:ty * tl + rows, tx * tw:(tx + 1) * tw] = img[:rows]
    return out[:h, :w]


def _undo_predictor(raw: bytes, rows: int, per_row: int, spp: int, bps: int,
                    order: str) -> bytes:
    """Horizontal differencing undone: each sample plus the one ``spp``
    before it in its row, modulo 2^bps."""
    dtype = np.dtype(np.uint8 if bps == 8 else order + "u2")
    s = np.frombuffer(raw, dtype)[:rows * per_row].reshape(rows, per_row // spp, spp)
    return np.cumsum(s, 1, dtype=dtype).astype(dtype).tobytes()  # cumsum's result is native


def _unpack(raw: bytes, rows: int, n: int, bps: int, order: str) -> np.ndarray:
    """``rows`` rows of ``n`` samples of ``bps`` bits (each row padded to a
    byte) -> (rows, n) int64."""
    if bps == 16:
        return np.frombuffer(raw, order + "u2")[:rows * n].reshape(rows, n).astype(np.int64)
    stride = -(-n * bps // 8)
    b = np.frombuffer(raw, np.uint8)[:rows * stride].reshape(rows, stride)
    if bps == 8:
        return b.astype(np.int64)
    return np.unpackbits(b, 1).reshape(rows, -1, bps)[:, :n].dot(
        1 << np.arange(bps - 1, -1, -1)).astype(np.int64)


def _drifted(tile: np.ndarray, width: int, bps: int) -> np.ndarray:
    """The first samples of a grey tile of (rows, tile width, spp) as
    libtiff's ``putgreytile``/``putagreytile`` (8 bits, two samples or
    more) and ``put16bitbwtile`` (16 bits) read the ``width`` pixels of a
    tile clipped at the image's right edge: they step from one row to the
    next by the clipped pixels as a count of bytes, not of pixels, so each
    row starts that much short of where it lies (16-bit values read in the
    host's byte order, at any byte offset)."""
    rows, tw, spp = tile.shape
    size = bps // 8
    buf = np.frombuffer(tile.astype("<u2" if size == 2 else np.uint8).tobytes(), np.uint8)
    at = (np.arange(rows)[:, None] * (width * size * spp + tw - width)
          + np.arange(width) * size * spp)
    out = tile.copy()
    out[:, :width, 0] = buf[at] + (buf[at + 1].astype(np.int64) << 8 if size == 2 else 0)
    return out


def _samples(data: bytes, tags: Dict[int, list], order: str, h: int, w: int, spp: int,
             bps: int, from_file: bool, drift: bool, path: str) -> np.ndarray:
    """Every strip or tile decoded -> (h, w, spp) int64 samples. ``drift``:
    grey tiles clipped at the right edge are read as ``_drifted``."""
    compression = tags.get(259, [1])[0]
    planar = tags.get(284, [1])[0]
    predictor = tags.get(317, [1])[0] if compression in (5, 8, 32946) else 1
    if predictor == 3:
        raise ValueError(f"{path}: TIFF floating point Predictor 3 (cv2 refuses it)")
    if predictor not in (1, 2):
        raise NotImplementedError(f"{path}: TIFF Predictor {predictor}")
    if predictor == 2 and bps not in (8, 16):
        raise ValueError(f"{path}: TIFF horizontal differencing of {bps}-bit samples")
    flip = tags.get(266, [1])[0] == 2
    planes = spp if planar == 2 and spp > 1 else 1
    per_plane = spp // planes
    tiled, tw, tl, offsets, counts = _layout(tags, h, w, planes, path)
    if compression in fax.COMPRESSIONS:
        decode = fax.strip_decoder(compression, tags.get(292, [0])[0], tw * per_plane)
    else:
        decode = _DECODERS[compression]
    tile_bytes = tl * -(-tw * per_plane * bps // 8)
    if tiled and not from_file and compression == 1 and tile_bytes % 1024:
        raise ValueError(f"{path}: uncompressed TIFF tiles of {tile_bytes} bytes "
                         "(cv2.imdecode refuses them unless a multiple of 1024)")
    across, down = -(-w // tw), -(-h // tl)
    out = np.zeros((down * tl, across * tw, spp), np.int64)
    k = 0
    for p in range(planes):
        for ty in range(down):
            rows = tl if tiled else min(tl, h - ty * tl)
            for tx in range(across):
                chunk = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                if flip:
                    chunk = chunk.translate(_REVERSED_BITS)
                per_row = tw * per_plane
                raw = decode(chunk, rows * -(-per_row * bps // 8), path)
                if predictor == 2:
                    raw = _undo_predictor(raw, rows, per_row, per_plane, bps, order)
                s = _unpack(raw, rows, per_row, bps, order).reshape(rows, tw, per_plane)
                if drift and tiled and planes == 1 and (tx + 1) * tw > w:
                    s = _drifted(s, w - tx * tw, bps)
                out[ty * tl:ty * tl + rows, tx * tw:(tx + 1) * tw,
                    p * per_plane:(p + 1) * per_plane] = s
    return out[:h, :w]


def _fix(x: np.float32) -> int:
    """libtiff's FIX: a float32 times 2^16, rounded half up."""
    return int(np.floor(float(x * np.float32(65536)) + 0.5))


def _code2v(c: np.ndarray, black: np.float32, white: np.float32, top: int) -> np.ndarray:
    """libtiff's Code2V in float32, then CLAMPw to +-4096 and a cast to int
    (toward zero)."""
    span = white - black if white - black != 0 else np.float32(1)
    v = (c - int(black)).astype(np.float32) * np.float32(top) / span
    return np.clip(v, -4096, 4096).astype(np.int64)


def _ycbcr_to_rgb(ycc: np.ndarray, tags: Dict[int, list], path: str) -> np.ndarray:
    """(..., 3) Y, Cb, Cr bytes -> uint8 RGB by libtiff's ``TIFFYCbCrToRGBInit``
    tables and ``TIFFYCbCrtoRGB``: YCbCrCoefficients (tag 529, default
    0.299, 0.587, 0.114) and ReferenceBlackWhite (532, default 0 255 128 255
    128 255) in float32, the chroma weights in 16-bit fixed point."""
    f32 = np.float32
    luma, rbw = tags.get(529, []), tags.get(532, [])
    red, green, blue = (f32(v) for v in (luma if len(luma) == 3 else (0.299, 0.587, 0.114)))
    rbw = [f32(v) for v in (rbw if len(rbw) == 6 else (0, 255, 128, 255, 128, 255))]
    if not np.isfinite([red, green, blue]).all() or abs(green) < 1e-7:
        raise ValueError(f"{path}: TIFF YCbCrCoefficients {red, green, blue} (cv2 refuses them)")

    def weight(f):
        return _fix(min(max(f, f32(0)), f32(2)))

    d1, d3 = weight(f32(2) - f32(2) * red), weight(f32(2) - f32(2) * blue)
    d2 = -weight(red * (f32(2) - f32(2) * red) / green)
    d4 = -weight(blue * (f32(2) - f32(2) * blue) / green)
    x = np.arange(256) - 128
    cr = _code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = _code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    y_tab = _code2v(x + 128, rbw[0], rbw[1], 255)
    y, b, r = y_tab[ycc[..., 0]], ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + ((d1 * cr + 32768) >> 16)[r],
                    y + (((d4 * cb + 32768)[b] + (d2 * cr)[r]) >> 16),
                    y + ((d3 * cb + 32768) >> 16)[b]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr_samples(data: bytes, tags: Dict[int, list], h: int, w: int, sampling: tuple,
                   from_file: bool, path: str) -> np.ndarray:
    """Every strip or tile of subsampled YCbCr -> (h, w, 3) Y, Cb, Cr: units
    of ``hs x vs`` luma samples, then Cb and Cr, row after row of units
    padded at the right and bottom edges, read as libtiff's RGBA reader
    reads them. A strip is read as so many rows of ``TIFFScanlineSize``,
    which rounds a row of units divided by ``vs`` down, so a 4x4 strip of
    an odd number of units a row loses its last bytes (read as zero). In a
    tile clipped at the right edge, ``putcontig8bitYCbCr44tile`` skips the
    units past the edge as 10 bytes each, not 18."""
    hs, vs = sampling
    unit = hs * vs + 2
    compression = tags.get(259, [1])[0]
    decode = _DECODERS[compression]
    flip = tags.get(266, [1])[0] == 2
    tiled, tw, tl, offsets, counts = _layout(tags, h, w, 1, path)
    across, down = -(-w // tw), -(-h // tl)
    units_across = -(-tw // hs)
    tile_bytes = -(-tl // vs) * units_across * unit
    if tiled and not from_file and compression == 1 and tile_bytes % 1024:
        raise ValueError(f"{path}: uncompressed TIFF tiles of {tile_bytes} bytes "
                         "(cv2.imdecode refuses them unless a multiple of 1024)")
    out = np.zeros((down * tl + vs, across * tw + hs, 3), np.int64)
    for k in range(across * down):
        ty, tx = divmod(k, across)
        rows = min(tl, h - ty * tl)
        units_down = -(-rows // vs)
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        if flip:
            chunk = chunk.translate(_REVERSED_BITS)
        if tiled:
            raw = np.frombuffer(decode(chunk, tile_bytes, path), np.uint8)
            used = -(-min(tw, w - tx * tw) // hs)
            skip = (units_across - used) * (10 if sampling == (4, 4) else unit)
            at = np.arange(units_down)[:, None] * (used * unit + skip) + np.arange(used * unit)
            u = raw[at]
        else:
            used = units_across
            want = units_down * vs * (units_across * unit // vs)
            u = np.zeros(units_down * units_across * unit, np.uint8)
            u[:want] = np.frombuffer(decode(chunk, want, path), np.uint8)
        u = u.reshape(units_down, used, unit).astype(np.int64)
        block = np.empty((units_down * vs, used * hs, 3), np.int64)
        block[..., 0] = u[..., :hs * vs].reshape(units_down, used, vs, hs).transpose(
            0, 2, 1, 3).reshape(units_down * vs, used * hs)
        for c in (1, 2):
            block[..., c] = np.repeat(np.repeat(u[..., hs * vs + c - 1], vs, 0), hs, 1)
        out[ty * tl:ty * tl + len(block), tx * tw:tx * tw + block.shape[1]] = block
    return out[:h, :w]


def _premultiplied(c: np.ndarray, a: np.ndarray, bps: int) -> np.ndarray:
    """Colour samples as libtiff's RGBA interface stores them: 16 bits
    rounded to 8, then times an unassociated alpha (``a``, or None)."""
    if bps == 16:
        c = (c + 128) // 257
        a = None if a is None else (a + 128) // 257
    return c if a is None else (c * a + 127) // 255


def _rgb(s: np.ndarray, tags: Dict[int, list], photometric: int, bps: int, spp: int,
         separate: bool, path: str) -> np.ndarray:
    """(h, w, spp) samples -> (h, w, 3) uint8 as libtiff's RGBA interface
    gives them."""
    extra = tags.get(338, [])
    alpha = 0  # libtiff's: 1 associated, 2 unassociated
    if extra:
        alpha = 1 if extra[0] == 0 and spp > 3 else (extra[0] if extra[0] in (1, 2) else 0)
    elif spp == 4 and photometric == 2:
        alpha = 1
    unassociated = s[..., 3 if photometric == 2 else 1] if alpha == 2 else None
    if photometric in (0, 1):
        g = s[..., 0]
        if separate:  # separate grey and alpha planes: read as RGB, grey in each
            g = _premultiplied(g, unassociated, bps)
        elif bps == 16:
            g = g >> 8
            g = 255 - g if photometric == 0 else g
        else:
            top = (1 << bps) - 1
            g = ((top - g) if photometric == 0 else g) * 255 // top
        return np.repeat(g.astype(np.uint8)[..., None], 3, 2)
    if photometric == 3:
        cmap = np.array(tags.get(320, []), np.int64)
        if len(cmap) != 3 << bps:
            raise ValueError(f"{path}: TIFF palette without its {3 << bps}-entry ColorMap")
        cmap = cmap.reshape(3, -1).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap[s[..., 0]].astype(np.uint8)
    if photometric == 5:
        k = 255 - s[..., 3:4]
        return (k * (255 - s[..., :3]) // 255).astype(np.uint8)
    if spp - len(extra) < 3:
        raise ValueError(f"{path}: TIFF RGB with {spp - len(extra)} colour samples")
    a = None if unassociated is None else unassociated[..., None]
    return _premultiplied(s[..., :3], a, bps).astype(np.uint8)


def decode_tiff(data: bytes, path: str = "<bytes>", from_file: bool = True) -> np.ndarray:
    """A TIFF -> (H, W, 3) uint8 RGB of its first image, equal to cv2's
    decode (see the module's docstring): of a file as ``cv2.imread`` reads
    it (``from_file``), else of bytes as ``cv2.imdecode`` reads them."""
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{path}: not a TIFF")
    tags, order = _ifd(data, path)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{path}: TIFF without its image size")
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, [1])[0]
    bps = tags.get(258, [1])[0]
    compression = tags.get(259, [1])[0]
    if 262 not in tags:
        raise ValueError(f"{path}: TIFF without its PhotometricInterpretation")
    photometric = tags[262][0]
    fmt = tags.get(339, [1])[0]
    if compression not in _DECODERS and compression not in fax.COMPRESSIONS + (7,):
        raise NotImplementedError(f"{path}: TIFF compression "
                                  f"{_COMPRESSIONS.get(compression, 'unknown')} ({compression}): "
                                  "only none, CCITT, LZW, Deflate, PackBits and JPEG are read")
    if compression in fax.COMPRESSIONS and (bps != 1 or spp != 1):
        raise ValueError(f"{path}: CCITT-compressed TIFF of {bps} bits, {spp} samples a pixel "
                         "(cv2 refuses it)")
    if compression == 7:
        return _jpeg_tiff(data, tags, w, h, spp, bps, photometric, fmt, from_file, path)
    if photometric in _REFUSED_PHOTOMETRICS:
        raise ValueError(f"{path}: TIFF photometric interpretation "
                         f"{_REFUSED_PHOTOMETRICS[photometric]} ({photometric}; cv2 refuses it)")
    if photometric in _PHOTOMETRICS:
        raise NotImplementedError(f"{path}: TIFF photometric interpretation "
                                  f"{_PHOTOMETRICS[photometric]} ({photometric})")
    _refuse_sample_format(fmt, path)
    if not w or not h:
        raise ValueError(f"{path}: TIFF of no size")
    if photometric == 6:
        return _ycbcr_tiff(data, tags, order, w, h, spp, bps, from_file, path)
    allowed = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8), 5: (8,)}
    if (photometric not in allowed or bps not in allowed[photometric] or spp > 4
            or (bps == 1 and spp > 1)):
        raise ValueError(f"{path}: TIFF photometric {photometric} at {bps} bits, {spp} "
                         "samples a pixel (cv2 refuses it)")
    separate = tags.get(284, [1])[0] == 2 and spp > 1
    if photometric == 5 and (tags.get(332, [1])[0] != 1 or spp < 4 or (separate and spp != 4)):
        raise ValueError(f"{path}: TIFF separated image of InkSet {tags.get(332, [1])[0]}, "
                         f"{spp} samples (cv2 refuses it)")
    _refuse_transposed(tags, w, h, from_file, path)
    drift = photometric in (0, 1) and (bps == 16 or (bps == 8 and spp > 1))
    s = _samples(data, tags, order, h, w, spp, bps, from_file, drift, path)
    img = _rgb(s, tags, photometric, bps, spp, separate, path)
    return _oriented(img, tags, w)


def _refuse_sample_format(fmt: int, path: str) -> None:
    if fmt in _REFUSED_SAMPLE_FORMATS:
        raise ValueError(f"{path}: TIFF {_REFUSED_SAMPLE_FORMATS[fmt]} samples (cv2 refuses "
                         "them)")
    if fmt in _SAMPLE_FORMATS:
        raise NotImplementedError(f"{path}: TIFF {_SAMPLE_FORMATS[fmt]} samples")


def _jpeg_tiff(data: bytes, tags: Dict[int, list], w: int, h: int, spp: int, bps: int,
               photometric: int, fmt: int, from_file: bool, path: str) -> np.ndarray:
    """A JPEG-compressed TIFF (compression 7) as libtiff's RGBA interface
    reads it: photometric YCbCr through libjpeg's conversion to RGB (libtiff
    sets ``JPEGCOLORMODE_RGB``), grey and RGB as coded, then as the other
    compressions' samples."""
    if photometric not in (0, 1, 2, 6):
        name = {**_PHOTOMETRICS, **_REFUSED_PHOTOMETRICS, 3: "palette", 5: "CMYK"}.get(
            photometric, "?")
        raise NotImplementedError(f"{path}: JPEG-compressed TIFF of photometric {name} "
                                  f"({photometric})")
    _refuse_sample_format(fmt, path)
    if not w or not h:
        raise ValueError(f"{path}: TIFF of no size")
    if tags.get(284, [1])[0] == 2 and spp > 1:
        raise NotImplementedError(f"{path}: JPEG-compressed TIFF with separate planes")
    if bps != 8 or spp != (1 if photometric in (0, 1) else 3):
        raise ValueError(f"{path}: JPEG-compressed TIFF of photometric {photometric}, {bps} "
                         f"bits, {spp} samples a pixel (cv2 refuses it)")
    _refuse_transposed(tags, w, h, from_file, path)
    s = _jpeg_samples(data, tags, h, w, spp, photometric == 6, path)
    if photometric == 6:
        img = s.astype(np.uint8)
    else:
        img = _rgb(s, tags, photometric, 8, spp, False, path)
    return _oriented(img, tags, w)


def _ycbcr_tiff(data: bytes, tags: Dict[int, list], order: str, w: int, h: int, spp: int,
                bps: int, from_file: bool, path: str) -> np.ndarray:
    """A YCbCr TIFF not JPEG-compressed, as libtiff's RGBA reader converts
    it: 8-bit samples, three a pixel; YCbCrSubsampling (tag 530, default
    2x2) of 1x1, 2x1, 2x2, 4x1, 4x2, 4x4 or 1x2 with contiguous samples, 1x1
    with separate planes; YCbCrPositioning ignored."""
    sampling = tuple(tags.get(530, [2, 2])[:2])
    separate = tags.get(284, [1])[0] == 2
    if (bps != 8 or spp != 3 or sampling not in _YCBCR_SAMPLINGS
            or (separate and sampling != (1, 1))):
        raise ValueError(f"{path}: TIFF YCbCr of {bps} bits, {spp} samples, subsampling "
                         f"{sampling}{', separate planes' if separate else ''} (cv2 refuses it)")
    _refuse_transposed(tags, w, h, from_file, path)
    if sampling != (1, 1) and tags.get(317, [1])[0] != 1 and tags.get(259, [1])[0] in (5, 8,
                                                                                      32946):
        raise NotImplementedError(f"{path}: TIFF Predictor {tags[317][0]} on YCbCr subsampled "
                                  f"{sampling}")
    if sampling == (1, 1):
        ycc = _samples(data, tags, order, h, w, 3, 8, from_file, False, path)
    else:
        ycc = _ycbcr_samples(data, tags, h, w, sampling, from_file, path)
    return _oriented(_ycbcr_to_rgb(ycc, tags, path), tags, w)


def _refuse_transposed(tags: Dict[int, list], w: int, h: int, from_file: bool,
                       path: str) -> None:
    if from_file and tags.get(274, [1])[0] in (5, 6, 7, 8) and h != w:
        raise ValueError(f"{path}: TIFF Orientation {tags[274][0]} transposes a {w}x{h} image "
                         "(cv2.imread refuses a size that differs from the header's)")


def _oriented(img: np.ndarray, tags: Dict[int, list], w: int) -> np.ndarray:
    """The Orientation tag applied as cv2 applies it."""
    orientation = tags.get(274, [1])[0]
    if 322 in tags and orientation in (2, 3, 6, 7):
        # libtiff mirrors each tile within its own columns, not the row
        tw = tags[322][0]
        cols = np.concatenate([np.arange(x, min(x + tw, w))[::-1] for x in range(0, w, tw)])
        img = img[:, cols[::-1]]
    return apply_orientation(img, orientation)

"""TIFF in numpy and the standard library's ``zlib``, bit-equal to
``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR`` then
``cv2.cvtColor(BGR2RGB)``.

cv2 reads TIFF through libtiff and, for an 8-bit result, through libtiff's
RGBA interface (``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``), whose rules
``decode_tiff`` copies, as probed on cv2 5.0.0 (libtiff 4.7):

* the first IFD of a classic (``II*\\0``, ``MM\\0*``) or BigTIFF (``II+\\0``,
  ``MM\\0+``) file; strips or tiles, PlanarConfiguration 1 (contiguous) or
  2 (one plane a sample); FillOrder 2 (bits reversed in each byte);
  BitsPerSample and SampleFormat one value, or one a sample all equal;
* compressions 1 (none), 2, 3 and 4 (CCITT modified Huffman, T.4 and
  T.6 of 1-bit samples, decoded by ``data/fax.py`` as libtiff decodes them,
  damaged data included), 5 (LZW, codes most significant bit first, one
  bit wider one code early; or old-style, least significant bit first, no
  early change), 8 and 32946 (Deflate) and 32773 (PackBits); Predictor 2
  (horizontal differencing of 8- or 16-bit samples) undone after LZW and
  Deflate only, as libtiff ignores it with the others, and on subsampled
  YCbCr blind to its units (``_ycbcr_samples``). A strip or tile whose data
  ends or breaks early reads as what its codec decoded, zeros after it,
  neither its predictor undone nor its 16-bit samples swapped (libtiff
  fails the strip and the RGBA reader keeps its zeroed buffer); a
  compression libtiff does not know reads as zero samples;
* compression 7 (JPEG): each strip or tile a JPEG stream read after the
  ``JPEGTables`` tag, decoded by ``data/jpeg.py``; photometric YCbCr to RGB
  by libjpeg (libtiff's ``JPEGCOLORMODE_RGB``), grey, RGB and CIE L*a*b*
  as coded; the first component's sampling that of YCbCrSubsampling (or,
  without the tag, of the first strip) and 1x1 for the others, as libtiff
  checks;
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
  16-bit fixed point), its units read as ``_ycbcr_samples`` says; 8 (CIE
  L*a*b*) at 8 or 16 bits, three contiguous samples, by libtiff's
  ``TIFFCIELabToXYZ`` and ``TIFFXYZToRGB`` (``data/cielab.py``) against
  the WhitePoint tag or D50;
* signed samples (SampleFormat 2) at any depth read as unsigned ones, as
  the RGBA reader reads them (L*a*b* takes its a* and b* as signed anyway);
* the Orientation tag applied as cv2 applies an EXIF orientation.

Depths, photometric interpretations, sample formats and predictors that
cv2 refuses (2-bit samples, 4-bit grey, 16-bit palette or CMYK, ICC and
ITU L*a*b*, L*a*b* of other than three contiguous samples, floating-point,
untyped and complex samples, the floating-point Predictor 3, ...), the
codecs cv2's libtiff lacks (old-style JPEG, JBIG, LZMA, Zstandard, WebP,
LERC, PixarLog) and damaged files raise ``ValueError``; compressions that
cv2 reads and these do not (CCITT RLEW, ThunderScan, SGI Log) and an image
whose first LZW strip is old-style and a later one not raise
``NotImplementedError`` naming what was met. The two routes differ on uncompressed tiles whose byte count
is not a tile's (``_chunks``; ``decode_tiff(from_file=False)`` reads as
``cv2.imdecode`` does).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from . import cielab, fax
from .jpeg import apply_orientation, decode_tiff_strip

SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")

#: field type -> (struct code, bytes) of the integer types; others are kept raw
_INTEGER_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
                  9: ("i", 4), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_TYPE_SIZES = {2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8}

# libtiff's codecs that cv2 5's build has and these do not: name, and what
# the codec and cv2 need to read a file (NotImplementedError; else ValueError)
_COMPRESSIONS = {32771: ("CCITT RLEW",
                         lambda bps, spp, ph: (bps, spp) == (1, 1) and ph in (0, 1, 3)),
                 32809: ("ThunderScan RLE", lambda bps, spp, ph: (bps, spp, ph) == (4, 1, 3)),
                 34676: ("SGI LogL", lambda bps, spp, ph: bps in (8, 16) and ph in (32844, 32845)),
                 34677: ("SGI LogLuv", lambda bps, spp, ph: bps in (8, 16) and ph == 32845)}
# codecs cv2 5 reads nothing with (ValueError): left out of its libtiff
# ("... compression support is not configured"), or NeXT's, which decodes
# only the 2-bit samples cv2 refuses. A compression libtiff does not know
# at all reads as zero samples (``_TIFFNoStripDecode``, ``_no_codec``).
_UNREAD = {6: "old-style JPEG", 32766: "NeXT RLE", 32909: "PixarLog", 34661: "JBIG",
           34887: "LERC", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
# what cv2 refuses (its libtiff RGBA reader does): ValueError. SGI LogL and
# LogLuv are read only under their own compressions (NotImplementedError)
_REFUSED_PHOTOMETRICS = {4: "transparency mask", 9: "ICC L*a*b*", 10: "ITU L*a*b*",
                         32803: "colour filter array", 32844: "SGI LogL", 32845: "SGI LogLuv",
                         34892: "linear raw"}
_REFUSED_SAMPLE_FORMATS = {3: "IEEE floating point", 4: "untyped",
                           5: "complex signed integer", 6: "complex floating point"}
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


def _old_style(data: bytes) -> bool:
    """libtiff's test for old-style LZW (``LZWPreDecode``): a strip whose
    first code, read least significant bit first, is a clear code."""
    return len(data) >= 2 and data[0] == 0 and bool(data[1] & 1)


def _lzw(data: bytes, size: int, path: str) -> bytes:
    """TIFF LZW (libtiff's ``LZWDecode``) -> up to ``size`` bytes: codes
    most significant bit first, 9 to 12 bits, one bit wider when the next
    free entry reaches 2^bits - 1; a clear code first and after every reset.
    Where the data ends or breaks first, what was decoded (libtiff keeps it
    and fails the strip). An image whose first strip is old-style is read
    by ``_lzw_old_style`` instead (``_decoder``)."""
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
                return bytes(out[:size])
            if prev is None:
                if code > 256:
                    return bytes(out[:size])
                out += table[code]
            else:
                if prev < 0 or len(table) >= 4096:
                    return bytes(out[:size])
                if code < len(table):
                    s = table[code]
                    table.append(table[prev] + s[:1])
                elif code == len(table):
                    s = table[prev] + table[prev][:1]
                    table.append(s)
                else:
                    return bytes(out[:size])
                if len(table) == (1 << width) - 1 and width < 12:
                    width += 1
                out += s
            prev = code
            if len(out) >= size:
                return bytes(out[:size])
    return bytes(out[:size])


def _lzw_old_style(data: bytes, size: int, path: str = "<bytes>") -> bytes:
    """Old-style TIFF LZW (libtiff's ``LZWDecodeCompat``) -> up to ``size``
    bytes: codes least significant bit first, 9 to 12 bits, one bit wider
    once the table holds 2^bits entries (no early change), the table
    growing past 4096 entries until 5119 without a clear code; what was
    decoded where the data ends or breaks first."""
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev = 9, None
    out = bytearray()
    bits = 8 * len(data)
    acc = left = at = 0
    while len(out) < size and bits >= width:
        while left < width:
            acc |= data[at] << left
            at += 1
            left += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        left -= width
        bits -= width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            if code > 256:
                break
            out.append(code)
        else:
            if len(table) >= 5119 or code > len(table):
                break
            first = table[code][:1] if code < len(table) else table[prev][:1]
            table.append(table[prev] + first)
            if len(table) >= 1 << width and width < 12:
                width += 1
            out += table[code]
        prev = code
    return bytes(out[:size])


def _packbits(data: bytes, size: int, path: str) -> bytes:
    """PackBits (libtiff's ``PackBitsDecode``) -> up to ``size`` bytes; a
    run cut short by the data's end is dropped whole."""
    out = bytearray()
    i = 0
    while len(out) < size and i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            m = min(n + 1, size - len(out))
            if i + m > len(data):
                break
            out += data[i:i + m]
            i += n + 1
        elif n > 128:
            if i >= len(data):
                break
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out[:size])


def _inflate(data: bytes, size: int, path: str) -> bytes:
    """Deflate (libtiff's ``ZIPDecode``) -> up to ``size`` bytes: where the
    stream is damaged, what zlib's inflate wrote before the damage."""
    try:
        return zlib.decompressobj().decompress(data, size)
    except zlib.error:
        pass
    good, bad = 0, len(data)  # the longest prefix that inflates without an error
    while bad - good > 1:
        mid = (good + bad) // 2
        try:
            zlib.decompressobj().decompress(data[:mid], size)
            good = mid
        except zlib.error:
            bad = mid
    return zlib.decompressobj().decompress(data[:good], size)


def _no_codec(data: bytes, size: int, path: str) -> bytes:
    """A compression libtiff has no codec for: its strips fail to decode
    and the RGBA reader's zeroed buffer stays as it was."""
    return b""


_DECODERS = {1: lambda d, n, p: d[:n] if len(d) >= n else b"", 5: _lzw, 8: _inflate,
             32946: _inflate, 32773: _packbits}


def _decoder(compression: int, first: bytes):
    """The decoder of an image's strips or tiles: libtiff chooses old-style
    LZW by the first one it reads (``LZWPreDecode``) and keeps it."""
    if compression == 5 and _old_style(first):
        return _lzw_old_style
    return _DECODERS.get(compression, _no_codec)


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


def _chunks(data: bytes, tags: Dict[int, list], offsets: list, counts: list, n: int,
            tiled: bool, estimate: int, from_file: bool, path: str) -> List[bytes]:
    """The first ``n`` strips' or tiles' bytes, bits reversed for FillOrder
    2, as libtiff reads them. A chunk of no bytes or past the file's end is
    refused (``TIFFFillStrip``). Uncompressed, libtiff replaces byte counts
    it takes for wrong (``TIFFReadDirectory``) by ``estimate`` bytes each
    (``EstimateStripByteCounts``): the one strip's count where it is short
    or runs past the file's end, and, with more than two contiguous strips
    or tiles, every count where the first two differ. Then cv2 refuses an
    uncompressed tile of other than ``estimate`` bytes (a tile's size):
    ``cv2.imread`` any other count, ``cv2.imdecode`` a larger one, or a
    first tile's count that does not round up to a tile in steps of 1024
    (so also any tile size not a multiple of 1024); a shorter tile reads as
    zeros. libtiff decodes every LZW strip of an image as it decodes the
    first (``_decoder``); old-style, the others must be so too."""
    counts = list(counts[:n])
    compression = tags.get(259, [1])[0]
    if compression == 1 and n == 1 and not tiled and (
            counts[0] < estimate or counts[0] > len(data) - offsets[0]):
        counts[0] = estimate
    elif (compression == 1 and n > 2 and tags.get(284, [1])[0] == 1
          and 0 != counts[0] != counts[1] != 0):
        counts = [estimate] * n
    out = []
    for k, (offset, count) in enumerate(zip(offsets[:n], counts)):
        if not count or offset + count > len(data):
            raise ValueError(f"{path}: TIFF strip or tile of {count} bytes at {offset}, the file "
                             f"has {len(data)} (cv2 refuses it)")
        if compression == 1 and tiled and (
                count != estimate if from_file
                else count > estimate or (k == 0 and -(-count // 1024) * 1024 != estimate)):
            raise ValueError(f"{path}: uncompressed TIFF tile of {count} bytes, {estimate} a "
                             f"tile (cv2.{'imread' if from_file else 'imdecode'} refuses it)")
        chunk = data[offset:offset + count]
        out.append(chunk.translate(_REVERSED_BITS) if tags.get(266, [1])[0] == 2 else chunk)
    if compression == 5 and _old_style(out[0]) and not all(
            _old_style(c) or len(c) < 2 for c in out[1:]):  # one byte: zeros either way
        raise NotImplementedError(f"{path}: TIFF LZW strips old-style (LSB-first), then not")
    return out


def _decoded(decode, chunk: bytes, size: int, predictor, path: str) -> Tuple[bytes, bool]:
    """(``size`` bytes of a strip or tile as the RGBA reader's zeroed buffer
    holds them, whether the codec succeeded): what the codec decoded, zeros
    after it, the predictor (a function of the bytes) undone only where the
    codec succeeded. libtiff swaps 16-bit samples to the host's order only
    then too, so a failed big-endian chunk reads little-endian."""
    raw = decode(chunk, size, path)
    ok = len(raw) == size
    if predictor is not None and ok:
        raw = predictor(raw)
    return raw.ljust(size, b"\0"), ok


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
    tiled, tw, tl, offsets, counts = _layout(tags, h, w, 1, path)
    across, down = -(-w // tw), -(-h // tl)
    sampling = tuple(tags[530][:2]) if ycc and 530 in tags else None
    out = np.zeros((down * tl, across * tw, 3 if ycc else spp), np.int64)
    for k, chunk in enumerate(_chunks(data, tags, offsets, counts, across * down, tiled, 0,
                                      False, path)):
        ty, tx = divmod(k, across)
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
    planes = spp if planar == 2 and spp > 1 else 1
    per_plane = spp // planes
    tiled, tw, tl, offsets, counts = _layout(tags, h, w, planes, path)
    per_row = tw * per_plane
    row_bytes = -(-per_row * bps // 8)
    tile_bytes = tl * row_bytes
    across, down = -(-w // tw), -(-h // tl)
    n = across * down * planes
    chunks = _chunks(data, tags, offsets, counts, n, tiled,
                     tile_bytes if tiled else h // n * row_bytes, from_file, path)
    if compression in fax.COMPRESSIONS:
        decode = fax.strip_decoder(compression, tags.get(292, [0])[0], per_row)
    else:
        decode = _decoder(compression, chunks[0])
    out = np.zeros((down * tl, across * tw, spp), np.int64)
    k = 0
    for p in range(planes):
        for ty in range(down):
            rows = tl if tiled else min(tl, h - ty * tl)
            undo = None
            if predictor == 2:
                def undo(raw, rows=rows):
                    return _undo_predictor(raw, rows, per_row, per_plane, bps, order)
            for tx in range(across):
                raw, ok = _decoded(decode, chunks[k], rows * row_bytes, undo, path)
                k += 1
                s = _unpack(raw, rows, per_row, bps, order if ok else "<").reshape(rows, tw,
                                                                                    per_plane)
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
    units past the edge as 10 bytes each, not 18.

    Predictor 2 (after LZW or Deflate) is undone as libtiff's ``horAcc8``
    undoes it, blind to the units: 3-byte samples summed along rows of
    ``TIFFScanlineSize`` bytes in a strip and of ``TIFFTileRowSize`` (the
    tile's width times 3) in a tile. Where those rows do not divide into
    3-byte samples, or a tile into rows, libtiff fails the strip or tile
    and the RGBA reader takes its bytes as decoded, not undone."""
    hs, vs = sampling
    unit = hs * vs + 2
    compression = tags.get(259, [1])[0]
    tiled, tw, tl, offsets, counts = _layout(tags, h, w, 1, path)
    across, down = -(-w // tw), -(-h // tl)
    units_across = -(-tw // hs)
    tile_bytes = -(-tl // vs) * units_across * unit
    scan = units_across * unit // vs  # TIFFScanlineSize
    predictor = tags.get(317, [1])[0] == 2 and compression in (5, 8, 32946)
    chunks = _chunks(data, tags, offsets, counts, across * down, tiled,
                     tile_bytes if tiled else h // (across * down) * scan, from_file, path)
    decode = _decoder(compression, chunks[0])
    out = np.zeros((down * tl + vs, across * tw + hs, 3), np.int64)
    for k, chunk in enumerate(chunks):
        ty, tx = divmod(k, across)
        rows = min(tl, h - ty * tl)
        units_down = -(-rows // vs)
        if tiled:
            undo = _ycbcr_undo(tw * 3, tile_bytes) if predictor else None
            raw = np.frombuffer(_decoded(decode, chunk, tile_bytes, undo, path)[0], np.uint8)
            used = -(-min(tw, w - tx * tw) // hs)
            skip = (units_across - used) * (10 if sampling == (4, 4) else unit)
            at = np.arange(units_down)[:, None] * (used * unit + skip) + np.arange(used * unit)
            u = raw[at]
        else:
            used = units_across
            want = units_down * vs * scan
            undo = _ycbcr_undo(scan, want) if predictor else None
            u = np.zeros(units_down * units_across * unit, np.uint8)
            u[:want] = np.frombuffer(_decoded(decode, chunk, want, undo, path)[0], np.uint8)
        u = u.reshape(units_down, used, unit).astype(np.int64)
        block = np.empty((units_down * vs, used * hs, 3), np.int64)
        block[..., 0] = u[..., :hs * vs].reshape(units_down, used, vs, hs).transpose(
            0, 2, 1, 3).reshape(units_down * vs, used * hs)
        for c in (1, 2):
            block[..., c] = np.repeat(np.repeat(u[..., hs * vs + c - 1], vs, 0), hs, 1)
        out[ty * tl:ty * tl + len(block), tx * tw:tx * tw + block.shape[1]] = block
    return out[:h, :w]


def _ycbcr_undo(row: int, size: int):
    """Predictor 2 on ``size`` bytes of subsampled YCbCr as libtiff's
    ``horAcc8`` undoes it: 3-byte samples summed along rows of ``row``
    bytes, or None where ``row`` does not divide into samples or ``size``
    into rows (libtiff fails the strip or tile and leaves it as decoded)."""
    if row % 3 or size % row:
        return None

    def undo(raw: bytes) -> bytes:
        s = np.frombuffer(raw, np.uint8).reshape(-1, row // 3, 3)
        return np.cumsum(s, 1, dtype=np.uint8).astype(np.uint8).tobytes()

    return undo


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
    bps = _per_sample(tags, 258, spp, "BitsPerSample", path)
    fmt = _per_sample(tags, 339, spp, "SampleFormat", path)
    if fmt not in (1, 2):  # signed samples read as unsigned ones: libtiff's RGBA reader does
        raise ValueError(f"{path}: TIFF {_REFUSED_SAMPLE_FORMATS.get(fmt, f'SampleFormat {fmt}')} "
                         "samples (cv2 refuses them)")
    compression = tags.get(259, [1])[0]
    if 262 not in tags:
        raise ValueError(f"{path}: TIFF without its PhotometricInterpretation")
    photometric = tags[262][0]
    if compression in _UNREAD:
        raise ValueError(f"{path}: TIFF compression {_UNREAD[compression]} ({compression}): cv2 "
                         "reads no such file")
    if compression in _COMPRESSIONS:
        name, readable = _COMPRESSIONS[compression]
        if not readable(bps, spp, photometric):
            raise ValueError(f"{path}: TIFF compression {name} ({compression}) of {bps}-bit "
                             f"samples, {spp} a pixel, photometric {photometric} (cv2 refuses "
                             "it)")
        raise NotImplementedError(f"{path}: TIFF compression {name} ({compression}): only none, "
                                  "CCITT, LZW, Deflate, PackBits and JPEG are read")
    if compression in fax.COMPRESSIONS and (bps != 1 or spp != 1):
        raise ValueError(f"{path}: CCITT-compressed TIFF of {bps} bits, {spp} samples a pixel "
                         "(cv2 refuses it)")
    if compression == 7:
        return _jpeg_tiff(data, tags, w, h, spp, bps, photometric, from_file, path)
    if photometric in _REFUSED_PHOTOMETRICS:
        raise ValueError(f"{path}: TIFF photometric interpretation "
                         f"{_REFUSED_PHOTOMETRICS[photometric]} ({photometric}; cv2 refuses it)")
    if not w or not h:
        raise ValueError(f"{path}: TIFF of no size")
    if photometric == 6:
        return _ycbcr_tiff(data, tags, order, w, h, spp, bps, from_file, path)
    if photometric == 8:
        white = _check_lab(tags, spp, bps, path)
        _refuse_transposed(tags, w, h, from_file, path)
        s = _samples(data, tags, order, h, w, 3, bps, from_file, False, path)
        return _oriented(_lab_to_rgb(s, bps, white), tags, w)
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


def _per_sample(tags: Dict[int, list], tag: int, spp: int, name: str, path: str) -> int:
    """A tag of one value a sample (BitsPerSample, SampleFormat) as libtiff
    reads it (``TIFFReadDirEntryPersampleShort``): one value, or at least
    ``spp`` of which the first ``spp`` are equal."""
    values = tags.get(tag, [1])
    if len(values) != 1 and (len(values) < spp or len(set(values[:spp])) > 1):
        raise ValueError(f"{path}: TIFF {name} {values} for {spp} samples a pixel (cv2 refuses "
                         "it)")
    return values[0]


def _check_lab(tags: Dict[int, list], spp: int, bps: int, path: str):
    """What libtiff's RGBA reader asks of CIE L*a*b* (``TIFFRGBAImageOK``,
    ``PickContigCase``, ``initCIELabConversion``): three samples a pixel,
    none of them extra, of 8 or 16 bits, contiguous, a WhitePoint whose y
    is not 0 -> the WhitePoint (x, y), or None for libtiff's default."""
    colour = spp - len(tags.get(338, []))
    if spp != 3 or colour != 3 or bps not in (8, 16) or tags.get(284, [1])[0] == 2:
        raise ValueError(f"{path}: TIFF CIE L*a*b* of {spp} samples ({colour} colour), {bps} "
                         f"bits, PlanarConfiguration {tags.get(284, [1])[0]} (cv2 refuses it)")
    white = tags.get(318, [])
    if len(white) != 2:  # libtiff ignores a WhitePoint of another count
        return None
    if white[1] == 0:
        raise ValueError(f"{path}: TIFF CIE L*a*b* WhitePoint {white} (cv2 refuses it)")
    return tuple(white)


def _lab_to_rgb(s: np.ndarray, bps: int, white) -> np.ndarray:
    """(h, w, 3) L*, a*, b* samples as read unsigned -> uint8 RGB."""
    if bps == 8:
        return cielab.lab8_to_rgb(s, white)
    ab = s[..., 1:] - ((s[..., 1:] & 0x8000) << 1)  # int16
    return cielab.lab16_to_rgb(np.concatenate([s[..., :1], ab], -1), white)


def _jpeg_tiff(data: bytes, tags: Dict[int, list], w: int, h: int, spp: int, bps: int,
               photometric: int, from_file: bool, path: str) -> np.ndarray:
    """A JPEG-compressed TIFF (compression 7) as libtiff's RGBA interface
    reads it: photometric YCbCr through libjpeg's conversion to RGB (libtiff
    sets ``JPEGCOLORMODE_RGB``); grey, RGB and CIE L*a*b* as coded (libjpeg's
    ``JCS_UNKNOWN``), then as the other compressions' samples."""
    if photometric in _REFUSED_PHOTOMETRICS:
        raise ValueError(f"{path}: TIFF photometric interpretation "
                         f"{_REFUSED_PHOTOMETRICS[photometric]} ({photometric}; cv2 refuses it)")
    if photometric not in (0, 1, 2, 6, 8):
        name = {3: "palette", 5: "CMYK"}.get(photometric, "?")
        raise NotImplementedError(f"{path}: JPEG-compressed TIFF of photometric {name} "
                                  f"({photometric})")
    if not w or not h:
        raise ValueError(f"{path}: TIFF of no size")
    white = _check_lab(tags, spp, bps, path) if photometric == 8 else None
    if tags.get(284, [1])[0] == 2 and spp > 1:
        raise NotImplementedError(f"{path}: JPEG-compressed TIFF with separate planes")
    if bps != 8 or spp != (1 if photometric in (0, 1) else 3):
        raise ValueError(f"{path}: JPEG-compressed TIFF of photometric {photometric}, {bps} "
                         f"bits, {spp} samples a pixel (cv2 refuses it)")
    _refuse_transposed(tags, w, h, from_file, path)
    s = _jpeg_samples(data, tags, h, w, spp, photometric == 6, path)
    if photometric == 6:
        img = s.astype(np.uint8)
    elif photometric == 8:
        img = cielab.lab8_to_rgb(s, white)
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
    if sampling == (1, 1):
        ycc = _samples(data, tags, order, h, w, 3, 8, from_file, False, path)
    else:
        predictor = tags.get(317, [1])[0] if tags.get(259, [1])[0] in (5, 8, 32946) else 1
        if predictor == 3:
            raise ValueError(f"{path}: TIFF floating point Predictor 3 (cv2 refuses it)")
        if predictor not in (1, 2):
            raise NotImplementedError(f"{path}: TIFF Predictor {predictor}")
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

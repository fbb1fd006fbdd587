#!/usr/bin/env python3
"""Write ``assets/images/``: the PNG, JPEG, BMP, PNM, GIF, TIFF, WebP,
Radiance HDR, PFM, Sun raster and JPEG 2000 files beyond baseline and progressive
YCbCr JPEG and 8-bit PNG that the port's readers
(``megreader_tpu_torch/data/``) are held to.

The card's machine has no encoder for these (no cv2, no PIL), so the files
are committed. This script makes them with cv2, PIL and writers of its own
(it runs where cv2 and PIL are installed, not on the card's machine) and
records each file's decode by cv2 5 in ``manifest.json``: the SHA-256 and
shape of ``cv2.imread(path, IMREAD_COLOR)`` then ``BGR2RGB`` (C-order uint8
bytes), and of ``cv2.imdecode`` of its bytes where that differs (``null``
where cv2.imdecode returns None). Files, under ``cases/`` unless named:

* PNG (``png_bytes``, its own writer: PIL cannot write grey below 8 bits):
  grey at 1, 2, 4, 8 and 16 bits, RGB at 8 and 16, palette at 1, 2, 4 and 8
  (with and without ``tRNS``, a short palette), grey and RGB with ``tRNS``,
  grey and RGB with alpha at 8 and 16; each also Adam7-interlaced, with
  all five row filters in turn; ``gAMA``, ``sBIT`` and text chunks; an
  ``eXIf`` Orientation of 6 before the image data and of 3 after it;
* JPEG: a COM, APP1, DQT, DHT or DRI segment between the last scan and EOI
  (baseline, progressive, grey), an SOS and an SOF after a baseline scan, a
  COM segment cut short; files without their EOI (4:2:0, 4:4:4, grey,
  restart intervals, progressive, multi-scan; and two, found by seed,
  that ``cv2.imdecode`` decodes as well); RGB-coded files (PIL's ``keep_rgb``, and cv2's
  4:2:0 and 4:2:2 files made RGB by an Adobe segment of transform 0 or by
  the component ids R, G, B); CMYK from PIL (4:4:4 and 4:2:0, a flat
  colour, a ramp, with and without its Adobe segment) and YCCK (the same
  files with Adobe transform 2); multi-scan sequential files
  (``jpeg_rescan``: a cv2 file's coefficients written again with the
  script's own Huffman writer, one scan for each group of components);
* BMP: ``cv2.imwrite``'s 24-bit and 8-bit grey files; 1, 4 and 8-bit
  palettes, 16 bits as 5-5-5 and by 5-6-5 and 5-5-5 masks, 24 and 32 bits,
  the OS/2 header, top-down rows, RLE8 and RLE4 with runs, literal pixels,
  ends of line, jumps and an early end of bitmap (``bmp_bytes``);
* PNM: ``cv2.imwrite``'s P1-P6 (``IMWRITE_PXM_BINARY`` 0 and 1, 16-bit
  samples), and by hand: maxval 1, 100 and 1000, comments in the header,
  samples above maxval;
* WebP (``webp_cases``): lossless and lossy files of cv2 and PIL, RGBA,
  lossy files from the system's libwebp encoder with the simple loop
  filter, sharpness and token partitions (``libwebp_lossy``, through
  ``ctypes``), VP8L streams of the script's own encoder (``vp8l_bytes``:
  each transform, both prefix code forms, the colour cache, meta prefix
  codes), lossless ALPH chunks, EXIF orientations, animations, cut, padded
  and refused files;
* JPEG-compressed TIFF (``tiff_jpeg_cases``, ``tiff_jpeg_bytes``): cv2's
  JPEGs as strips or tiles, whole or abbreviated with ``JPEGTables``, YCbCr
  at each sampling, grey, RGB, PIL's files;
* CCITT and YCbCr TIFF (``fax_ycbcr_cases``): libtiff's own modified
  Huffman, T.4 (1-D, 2-D, fill bits) and T.6 strips through PIL
  (``fax_strip``, ``fax_tiff``: photometric, fill order, strips, tiles,
  a cut and a damaged strip), YCbCr units at every subsampling, tiles and
  other coefficients and reference range (``ycbcr_tiff``);
* Radiance HDR (``hdr_bytes``: run-length and flat scanlines, cv2's file),
  PFM (``pfm_bytes``: both byte orders, a scale, grey) and Sun raster
  (``sunras_bytes``: 1, 8, 24 and 32 bits, colour maps, cv2's file, a
  byte-encoded file cv2 refuses) (``hdr_pfm_ras_cases``);
* JPEG 2000 (``jpeg2000_cases``): PIL's 5/3 RGB JP2, a raw 9/7
  codestream, layers over precincts in RPCL order, a palette with channel
  definitions (``jp2_file``, the script's own box writer, over a codestream
  of libopenjp2's encoder through ``ctypes``: ``openjpeg``), a cut file;
* TIFF variants (``tiff_variant_cases``): CIE L*a*b*, signed 16-bit RGB
  and old-style LZW (``tiff_lzw_old_style``, the script's own writer);
* ``pages/``: 640x640 pages drawn by ``chip_smoke.TextPages``: a CMYK
  JPEG, a palette PNG, a 16-bit Adam7 PNG and an RLE8 BMP, cut JPEGs, a
  GIF and an LZW TIFF, a lossless and a lossy WebP, a JPEG-compressed
  TIFF, a CCITT Group 4 TIFF and a grey 9/7 JPEG 2000, for
  ``chip_smoke.py``'s ``cli.pipeline`` run.

Each size runs from 1x1 to odd sizes such as 33x50 and 37x100. The script
is deterministic:

    python3 scripts/make_port_image_assets.py [--out assets/images]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# ------------------------------------------------------------------- PNG
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) samples -> (h, bytes) rows of ``depth``-bit samples."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)], 1)
    s = s.reshape(h, -1, per).astype(np.int64)
    return (s << (depth * np.arange(per - 1, -1, -1))).sum(-1).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Each row with its filter type byte, filters taken in turn."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y in range(rows.shape[0]):
        c, k = rows[y].astype(np.int64), filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), c[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if k == 0:
            pred = 0 * c
        elif k == 1:
            pred = a
        elif k == 2:
            pred = prev
        elif k == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - ul
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, ul))
        out.append(bytes([k]) + ((c - pred) % 256).astype(np.uint8).tobytes())
        prev = c
    return b"".join(out)


def png_bytes(samples, depth: int, colour: int, palette=None, trns: bytes = None,
              interlace: int = 0, before=(), after=(), filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of (h, w) or (h, w, channels) integer ``samples`` at bit depth
    ``depth`` and colour type ``colour``; ``before``/``after``: (kind, body)
    chunks before and after IDAT."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, ch = s.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b"".join(_filtered(_pack(p.reshape(p.shape[0], -1), depth), bpp, filters)
                       for p in (s[y0::dy, x0::dx] for y0, x0, dy, dx in ADAM7) if p.size)
    else:
        raw = _filtered(_pack(s.reshape(h, -1), depth), bpp, filters)
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                         interlace))
    out += b"".join(png_chunk(k, b) for k, b in before)
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    out += png_chunk(b"IDAT", zlib.compress(raw, 9))
    out += b"".join(png_chunk(k, b) for k, b in after)
    return out + png_chunk(b"IEND", b"")


def exif_tiff(orientation: int, order: str = "<") -> bytes:
    """A TIFF header and an IFD0 holding only Orientation."""
    mark = b"II" if order == "<" else b"MM"
    return (mark + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))


# ------------------------------------------------------------------- BMP
def bmp_bytes(pixels, bpp: int, palette=None, header: int = 40, compression: int = 0,
              masks=None, top_down: bool = False, rle: bytes = None, used: int = None) -> bytes:
    """A BMP: ``pixels`` (h, w) palette indices for ``bpp`` <= 8, (h, w)
    16-bit words, or (h, w, 3|4) BGR(A) bytes; ``palette`` (n, 3) BGR;
    ``rle`` the RLE stream in place of rows; ``masks`` written after a
    40-byte header, or inside a header of 108 bytes and more."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if rle is None:
        rows = []
        for y in range(h):
            r = pixels[y]
            if bpp < 8:
                b = _pack(r[None].astype(np.int64), bpp)[0].tobytes()
            elif bpp == 8:
                b = r.astype(np.uint8).tobytes()
            elif bpp == 16:
                b = r.astype("<u2").tobytes()
            else:
                b = r.astype(np.uint8).tobytes()
            rows.append(b + b"\0" * ((-len(b)) % 4))
        data = b"".join(rows if top_down else rows[::-1])
    else:
        data = rle
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        pal = p.tobytes() if header == 12 else np.concatenate(
            [p, np.zeros((len(p), 1), np.uint8)], 1).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n = len(palette) if palette is not None else 0
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, compression,
                           len(data), 2835, 2835, used if used is not None else n, 0)
        if header >= 108:
            info += struct.pack("<IIII", *(masks or (0, 0, 0)), 0)
            info += b"\0" * (header - len(info))
        elif masks is not None:
            info += struct.pack("<III", *masks)
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + pal + data


def rle_encode(idx: np.ndarray, four: bool) -> bytes:
    """An RLE8 (or RLE4) stream of (h, w) palette indices, bottom row first:
    runs of one index (of two alternating ones for RLE4) and literal
    stretches, an end of line after each row, an end of bitmap last."""
    out = bytearray()
    for row in np.asarray(idx)[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, row[x] * 17 if four else row[x]])
                x += n
                continue
            m = 3  # a literal stretch up to the next run of three
            while x + m < w and m < 255 and not (x + m + 2 < w and row[x + m] == row[x + m + 1]
                                                  == row[x + m + 2]):
                m += 1
            lit = row[x:x + m]
            if four:
                body = bytes((a << 4) | b for a, b in zip(lit[0::2], lit[1::2] + [0]))
                body += b"\0" * ((-len(body)) % 2)
            else:
                body = bytes(lit) + b"\0" * (m % 2)
            out += bytes([0, m]) + body
            x += m
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


# ------------------------------------------------------------------ JPEG
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def jpeg_segments(data: bytes):
    """(marker, start, end) of each segment from SOI up to the first SOS."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + length))
        pos += 2 + length
        if marker == 0xDA:
            return out


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def before_eoi(data: bytes, seg: bytes) -> bytes:
    assert data.endswith(b"\xff\xd9")
    return data[:-2] + seg + data[-2:]


def without(data: bytes, marker: int, prefix: bytes = b"") -> bytes:
    """``data`` without its header segments of ``marker`` whose body starts
    with ``prefix``."""
    for m, a, b in jpeg_segments(data)[::-1]:
        if m == marker and data[a + 4:b].startswith(prefix):
            data = data[:a] + data[b:]
    return data


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    """``data`` with its Adobe segment replaced by one of ``transform``."""
    data = without(data, 0xEE, b"Adobe")
    return data[:2] + adobe(transform) + data[2:]


def with_component_ids(data: bytes, ids) -> bytes:
    """``data`` with the component ids of its frame and first scan replaced."""
    data = bytearray(data)
    old = []
    for m, a, b in jpeg_segments(bytes(data)):
        if m == 0xC0:
            for c, cid in enumerate(ids):
                old.append(data[a + 10 + 3 * c])
                data[a + 10 + 3 * c] = cid
        elif m == 0xDA:
            for j in range(data[a + 4]):
                data[a + 5 + 2 * j] = ids[old.index(data[a + 5 + 2 * j])]
    return bytes(data)


def _codes(counts: bytes, symbols: bytes) -> dict:
    """symbol -> (code, length) of a canonical Huffman table (T.81 C.2)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            k += 1
            code += 1
        code <<= 1
    return codes


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out += b"\xff\x00" if byte == 0xFF else bytes([byte])

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _encode_block(bits: _Bits, zz, pred: int, dc: dict, ac: dict) -> int:
    """One block's zigzag coefficients; returns its DC."""
    diff = int(zz[0]) - pred
    size = abs(diff).bit_length()
    bits.put(*dc[size])
    if size:
        bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
    run = 0
    last = max([k for k in range(1, 64) if zz[k]], default=0)
    for k in range(1, last + 1):
        v = int(zz[k])
        if not v:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        size = abs(v).bit_length()
        bits.put(*ac[(run << 4) | size])
        bits.put(v if v > 0 else v + (1 << size) - 1, size)
        run = 0
    if last < 63:
        bits.put(*ac[0x00])
    return int(zz[0])


def jpeg_rescan(data: bytes, groups, restart: int = 0) -> bytes:
    """A baseline JPEG written again as one sequential scan for each group
    of component indices in ``groups`` (a group of one covers that
    component's own blocks; a larger one interleaves over the MCU grid),
    with the file's own tables, and a restart marker every ``restart``
    MCUs of each scan."""
    from megreader_tpu_torch.data.jpeg import read_coefficients

    segs = jpeg_segments(data)
    head = data[:segs[-1][1]]
    tables, sof, sos = {}, None, None
    for m, a, b in segs:
        body = data[a + 4:b]
        if m == 0xC4:
            i = 0
            while i < len(body):
                counts = body[i + 1:i + 17]
                n = sum(counts)
                tables[body[i] >> 4, body[i] & 15] = _codes(counts, body[i + 17:i + 17 + n])
                i += 17 + n
        elif m in (0xC0, 0xC1):
            sof = body
        elif m == 0xDA:
            sos = body
    height, width, nc = struct.unpack(">HHB", sof[1:6])
    comps = [(sof[6 + 3 * c], sof[7 + 3 * c] >> 4, sof[7 + 3 * c] & 15) for c in range(nc)]
    select = {sos[1 + 2 * j]: sos[2 + 2 * j] for j in range(sos[0])}
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    blocks = read_coefficients(data)["blocks"]
    zz = [b.reshape(b.shape[0], b.shape[1], 64)[..., ZIGZAG] for b in blocks]
    out = bytearray(head)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    for group in groups:
        if len(group) == 1:
            c = group[0]
            bh = -(-(-(-height * comps[c][2] // vmax)) // 8)
            bw = -(-(-(-width * comps[c][1] // hmax)) // 8)
            mcus = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            my, mx = -(-height // (8 * vmax)), -(-width // (8 * hmax))
            mcus = [[(c, y * comps[c][2] + by, x * comps[c][1] + bx) for c in group
                     for by in range(comps[c][2]) for bx in range(comps[c][1])]
                    for y in range(my) for x in range(mx)]
        out += segment(0xDA, bytes([len(group)]) + b"".join(
            bytes([comps[c][0], select[comps[c][0]]]) for c in group) + b"\x00\x3f\x00")
        bits, pred = _Bits(), {}
        for i, mcu in enumerate(mcus):
            if restart and i and i % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                pred = {}
            for c, by, bx in mcu:
                t = select[comps[c][0]]
                pred[c] = _encode_block(bits, zz[c][by, bx], pred.get(c, 0), tables[0, t >> 4],
                                        tables[1, t & 15])
        bits.flush()
        out += bits.out
    return bytes(out) + b"\xff\xd9"


def _fdct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    m = np.cos((2 * np.arange(8)[None] + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def jpeg_frame_file(planes, precision: int = 8, sof: int = 0xC0, sampling=None,
                    transform: int = None) -> bytes:
    """A sequential JPEG of any component count and sample precision, which
    no library encoder here writes (2 or 5 components, 12 or 16 bits): each
    plane's level-shifted 8x8 blocks through the DCT, quantised by 1, coded
    with the script's Huffman writer and flat tables that hold every DC size
    to 15 and every AC run/size to 15. ``sampling``: (h, v) a component,
    1x1 by default; the planes' sizes must be what the frame gives them.
    One interleaved scan of up to four components, else one scan each;
    ``transform`` adds an Adobe segment of that transform."""
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height = max(p.shape[0] * vmax // v for p, (_, v) in zip(planes, sampling))
    width = max(p.shape[1] * hmax // h for p, (h, _) in zip(planes, sampling))
    dc = _codes(bytes([0, 0, 0, 0, 16] + [0] * 11), bytes(range(16)))
    ac_symbols = bytes([0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)])
    ac = _codes(bytes([0] * 7 + [len(ac_symbols)] + [0] * 8), ac_symbols)
    m = _fdct_matrix()
    zz = []
    for p in planes:
        h8, w8 = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.astype(np.float64).reshape(h8, 8, w8, 8).transpose(0, 2, 1, 3)
        coef = np.rint(m @ (blocks - (1 << (precision - 1))) @ m.T).astype(np.int64)
        zz.append(coef.reshape(h8, w8, 64)[..., ZIGZAG])
    ids = list(range(1, nc + 1))
    out = bytearray(b"\xff\xd8")
    if transform is not None:
        out += adobe(transform)
    out += segment(0xDB, b"\x00" + bytes([1] * 64))
    out += segment(sof, struct.pack(">BHHB", precision, height, width, nc) + b"".join(
        bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], 0]) for c in range(nc)))
    dht = b"\x00" + bytes([0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16))
    dht += b"\x10" + bytes([0] * 7 + [len(ac_symbols)] + [0] * 8) + ac_symbols
    out += segment(0xC4, dht)
    groups = [list(range(nc))] if nc <= 4 else [[c] for c in range(nc)]
    for group in groups:
        out += segment(0xDA, bytes([len(group)]) + b"".join(bytes([ids[c], 0x00]) for c in group)
                       + b"\x00\x3f\x00")
        if len(group) == 1:
            c = group[0]
            mcus = [[(c, by, bx)] for by in range(zz[c].shape[0]) for bx in range(zz[c].shape[1])]
        else:
            my, mx = -(-height // (8 * vmax)), -(-width // (8 * hmax))
            mcus = [[(c, y * sampling[c][1] + by, x * sampling[c][0] + bx) for c in group
                     for by in range(sampling[c][1]) for bx in range(sampling[c][0])]
                    for y in range(my) for x in range(mx)]
        bits, pred = _Bits(), {}
        for mcu in mcus:
            for c, by, bx in mcu:
                pred[c] = _encode_block(bits, zz[c][by, bx], pred.get(c, 0), dc, ac)
        bits.flush()
        out += bits.out
    return bytes(out) + b"\xff\xd9"


# ----------------------------------------------------------------- cases
def smooth(rng, h: int, w: int, ch: int = 3, top: int = 256) -> np.ndarray:
    """A smooth random uint8 image with some noise, values below ``top``."""
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int64)
    img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255)
    img = img[..., :ch] if ch <= 3 else np.concatenate([img, img[..., :ch - 3]], -1)
    img = (img * top // 256).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def cv_encode(ext: str, img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, [int(p) for p in params])
    assert ok, ext
    return buf.tobytes()


def pil_jpeg(img: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img).astype(np.uint8), mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


SIZES = ((1, 1), (7, 13), (33, 50), (37, 100))


def reached_without_eoi(rng, params, grey: bool) -> bytes:
    """A cv2 file without its EOI that ``cv2.imdecode`` still decodes (its
    bit reader reaches the last MCU without asking for more data): the
    first of seeded 23x37 images that gives one."""
    while True:
        data = cv_encode(".jpg", smooth(rng, 23, 37, 1 if grey else 3), params)[:-2]
        if cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None:
            return data


def png_cases(rng) -> dict:
    out = {}
    kinds = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
             6: (4, (8, 16))}
    for colour, (ch, depths) in kinds.items():
        for depth in depths:
            for i, (h, w) in enumerate(SIZES):
                interlace = i % 2
                s = rng.integers(0, 1 << depth, (h, w, ch))
                kw = {}
                if colour == 3:
                    kw["palette"] = rng.integers(0, 256, (1 << depth, 3))
                if i == 2 and colour == 3:
                    kw["trns"] = bytes(rng.integers(0, 256, min(4, 1 << depth)).tolist())
                if i == 2 and colour in (0, 2):
                    kw["trns"] = struct.pack(">" + "H" * ch, *s[0, 0].tolist())
                out[f"png_c{colour}_d{depth}_{h}x{w}{'_adam7' if interlace else ''}"] = \
                    png_bytes(s, depth, colour, interlace=interlace, **kw)
    img = smooth(rng, 33, 50)
    out["png_palette_short_33x50"] = png_bytes(rng.integers(0, 16, (33, 50)), 4, 3,
                                               palette=rng.integers(0, 256, (5, 3)))
    out["png_ancillary_33x50"] = png_bytes(img, 8, 2, before=[
        (b"gAMA", struct.pack(">I", 100000)), (b"sBIT", bytes([4, 5, 6])),
        (b"tEXt", b"Comment\0made by hand")], interlace=1)
    out["png_sbit16_37x100"] = png_bytes(smooth(rng, 37, 100).astype(np.int64) * 257, 16, 2,
                                         before=[(b"sBIT", bytes([10, 10, 10]))])
    out["png_exif6_before_20x30"] = png_bytes(smooth(rng, 20, 30), 8, 2,
                                              before=[(b"eXIf", exif_tiff(6))])
    out["png_exif3_after_be_20x30"] = png_bytes(smooth(rng, 20, 30), 16, 2, interlace=1,
                                                after=[(b"eXIf", exif_tiff(3, ">"))])
    out["png_exif8_grey2_9x17"] = png_bytes(rng.integers(0, 4, (9, 17)), 2, 0,
                                            before=[(b"eXIf", exif_tiff(8))])
    return out


def jpeg_cases(rng) -> dict:
    out = {}
    base = cv_encode(".jpg", smooth(rng, 33, 50))
    prog = cv_encode(".jpg", smooth(rng, 33, 50), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    grey = cv_encode(".jpg", smooth(rng, 37, 100, 1))
    com = segment(0xFE, b"a comment after the scan")
    app1 = segment(0xE1, b"XMP\0not exif")
    for name, data in (("s420", base), ("progressive", prog), ("grey", grey)):
        out[f"jpeg_com_after_scan_{name}"] = before_eoi(data, com)
        out[f"jpeg_app1_after_scan_{name}"] = before_eoi(data, app1)
    dqt = [base[a:b] for m, a, b in jpeg_segments(base) if m == 0xDB][0]
    dht = [base[a:b] for m, a, b in jpeg_segments(base) if m == 0xC4][0]
    out["jpeg_tables_after_scan_s420"] = before_eoi(base, dqt + dht + segment(0xDD, b"\0\4"))
    for name, img, params in (
            ("s420_33x50", smooth(rng, 33, 50), []),
            ("s444_7x13", smooth(rng, 7, 13), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
            ("grey_37x100", smooth(rng, 37, 100, 1), []),
            ("rst2_s420_64x80", smooth(rng, 64, 80), [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
            ("s422_1x1", smooth(rng, 1, 1), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])):
        out[f"jpeg_no_eoi_{name}"] = cv_encode(".jpg", img, params)[:-2]
    for name, params in (("s420", []), ("rst1_grey", [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])):
        out[f"jpeg_no_eoi_imdecode_{name}"] = reached_without_eoi(rng, params, "grey" in name)
    out["jpeg_no_eoi_progressive_33x50"] = prog[:-2]
    multi = jpeg_rescan(cv_encode(".jpg", smooth(rng, 33, 50)), [[0], [1, 2]])
    out["jpeg_no_eoi_multiscan_33x50"] = multi[:-2]
    out["jpeg_com_after_scan_no_eoi_multiscan_33x50"] = multi[:-2] + com
    sos = [base[a:b] for m, a, b in jpeg_segments(base) if m == 0xDA][0]
    sof = [base[a:b] for m, a, b in jpeg_segments(base) if m == 0xC0][0]
    out["jpeg_sos_sof_after_scan_s420"] = before_eoi(base, sos + b"\0" * 8 + sof)
    out["jpeg_com_cut_after_scan_s420"] = base[:-2] + com[:6]
    for h, w in ((1, 1), (33, 50)):
        out[f"jpeg_rgb_keep_{h}x{w}"] = pil_jpeg(smooth(rng, h, w), "RGB", keep_rgb=True,
                                                 quality=90, subsampling=0)
    for s, flag in (("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                    ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)):
        ycc = cv_encode(".jpg", smooth(rng, 37, 100), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        out[f"jpeg_rgb_adobe0_s{s}_37x100"] = with_adobe_transform(ycc, 0)
        out[f"jpeg_rgb_ids_s{s}_37x100"] = with_component_ids(without(ycc, 0xE0, b"JFIF"),
                                                              b"RGB")
    for sub, (h, w) in ((0, (33, 50)), (2, (37, 100)), (2, (1, 1)), (1, (7, 13))):
        cmyk = smooth(rng, h, w, 4)
        data = pil_jpeg(cmyk, "CMYK", quality=90, subsampling=sub)
        out[f"jpeg_cmyk_sub{sub}_{h}x{w}"] = data
        out[f"jpeg_ycck_sub{sub}_{h}x{w}"] = with_adobe_transform(data, 2)
    flat = np.broadcast_to(np.array([30, 200, 90, 60], np.uint8), (16, 16, 4))
    out["jpeg_cmyk_flat_16x16"] = pil_jpeg(flat, "CMYK", quality=100, subsampling=0)
    ramp = np.stack(np.meshgrid(np.arange(32) * 8, np.arange(32) * 8), -1)
    ramp = np.concatenate([ramp, 255 - ramp], -1)
    data = pil_jpeg(ramp, "CMYK", quality=100, subsampling=0)
    out["jpeg_cmyk_ramp_32x32"] = data
    out["jpeg_cmyk_no_adobe_32x32"] = without(data, 0xEE, b"Adobe")
    out["jpeg_ycck_ramp_32x32"] = with_adobe_transform(data, 2)
    s422 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
    s411 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]
    for name, (h, w), params, groups, rst in (
            ("s420_one_each", (33, 50), [], [[0], [1], [2]], 0),
            ("s420_chroma_first", (37, 100), [], [[1, 2], [0]], 0),
            ("s422_split", (33, 50), s422, [[0, 2], [1]], 0),
            ("s420_rst3", (64, 80), [], [[0], [1, 2]], 3),
            ("s411", (7, 13), s411, [[2], [0], [1]], 0),
            ("s420", (1, 1), [], [[0], [1], [2]], 0)):
        data = cv_encode(".jpg", smooth(rng, h, w), params)
        out[f"jpeg_multiscan_{name}_{h}x{w}"] = jpeg_rescan(data, groups, rst)
    cmyk = pil_jpeg(smooth(rng, 33, 50, 4), "CMYK", quality=90, subsampling=2)
    out["jpeg_multiscan_cmyk_33x50"] = jpeg_rescan(cmyk, [[0, 1], [2], [3]])
    return out


def bmp_cases(rng) -> dict:
    out = {}
    out["bmp_cv2_24_37x100"] = cv_encode(".bmp", smooth(rng, 37, 100))
    out["bmp_cv2_grey_33x50"] = cv_encode(".bmp", smooth(rng, 33, 50, 1))
    for bpp in (1, 4, 8):
        for i, (h, w) in enumerate(SIZES):
            pal = rng.integers(0, 256, (1 << bpp, 3))
            idx = rng.integers(0, 1 << bpp, (h, w))
            out[f"bmp_pal{bpp}_{h}x{w}"] = bmp_bytes(idx, bpp, pal, header=(40, 124, 12, 108)[i],
                                                     top_down=i == 1)
    idx = rng.integers(0, 256, (33, 50))
    out["bmp_pal8_short_33x50"] = bmp_bytes(idx, 8, rng.integers(0, 256, (20, 3)))
    for name, comp, masks in (("555", 0, None), ("565_bitfields", 3, (0xF800, 0x7E0, 0x1F)),
                              ("555_bitfields", 3, (0x7C00, 0x3E0, 0x1F))):
        for h, w in ((1, 1), (33, 50)):
            out[f"bmp_16_{name}_{h}x{w}"] = bmp_bytes(rng.integers(0, 1 << 16, (h, w)), 16,
                                                      compression=comp, masks=masks)
    out["bmp_24_top_down_7x13"] = bmp_bytes(smooth(rng, 7, 13)[..., ::-1], 24, top_down=True)
    out["bmp_24_os2_33x50"] = bmp_bytes(smooth(rng, 33, 50)[..., ::-1], 24, header=12)
    bgra = np.concatenate([smooth(rng, 37, 100), rng.integers(0, 256, (37, 100, 1))], -1)
    out["bmp_32_37x100"] = bmp_bytes(bgra, 32)
    out["bmp_32_v5_bitfields_33x50"] = bmp_bytes(bgra[:33, :50], 32, header=124, compression=3,
                                                 masks=(0xFF00, 0xFF0000, 0xFF000000))
    out["bmp_32_bitfields_ignored_7x13"] = bmp_bytes(bgra[:7, :13], 32, compression=3,
                                                     masks=(0xFF, 0xFF00, 0xFF0000))
    # RLE: an encoder's streams, and hand-made ones with every escape
    for four, bpp in ((False, 8), (True, 4)):
        n = 1 << bpp
        pal = rng.integers(0, 256, (n, 3))
        for h, w in ((1, 1), (33, 50), (37, 100)):
            idx = np.repeat(rng.integers(0, n, (h, w // 5 + 1)), 5, 1)[:, :w]
            idx[::3] = rng.integers(0, n, idx[::3].shape)  # literal stretches
            out[f"bmp_rle{bpp}_{h}x{w}"] = bmp_bytes(idx, bpp, pal, compression=2 if four else 1,
                                                     rle=rle_encode(idx, four))
        if four:
            stream = [6, 0x12, 0, 0, 0, 5, 0x34, 0x56, 0x70, 0, 1, 0x8, 0, 0, 3, 0x9A, 0, 2,
                      1, 1, 0, 0, 0, 0, 0, 1, 0, 0]
        else:
            stream = [2, 5, 0, 0, 0, 2, 1, 1, 3, 7, 0, 0, 0, 3, 7, 8, 9, 0, 3, 4, 0, 0, 0, 1]
        out[f"bmp_rle{bpp}_escapes_5x6"] = bmp_bytes(np.zeros((5, 6)), bpp, pal,
                                                      compression=2 if four else 1,
                                                      rle=bytes(stream))
    return out


def pnm_cases(rng) -> dict:
    out = {}
    for ext, binary in ((".pbm", 0), (".pbm", 1), (".pgm", 0), (".pgm", 1), (".ppm", 0),
                        (".ppm", 1)):
        for h, w in ((1, 1), (33, 50)):
            if ext == ".ppm":
                img = smooth(rng, h, w)
            else:
                img = smooth(rng, h, w, 1)
                if ext == ".pbm":
                    img = (img > 127).astype(np.uint8) * 255
            out[f"pnm_cv2_{ext[1:]}_{'bin' if binary else 'ascii'}_{h}x{w}"] = cv_encode(
                ext, img.astype(np.uint8), [cv2.IMWRITE_PXM_BINARY, binary])
    img16 = smooth(rng, 37, 100, 1).astype(np.uint16) * 257 + rng.integers(0, 256, (37, 100))
    out["pnm_cv2_pgm16_bin_37x100"] = cv_encode(".pgm", img16.astype(np.uint16))
    rgb16 = smooth(rng, 7, 13).astype(np.uint16) * 257
    out["pnm_cv2_ppm16_ascii_7x13"] = cv_encode(".ppm", rgb16, [cv2.IMWRITE_PXM_BINARY, 0])
    for maxval in (1, 100, 1000):
        g = rng.integers(0, maxval + 1, (33, 50))
        if maxval == 100:
            g[0, :5] = [100, 150, 255, 0, 101]  # above maxval: kept in P5, clamped in P2
        head = f"P5\n# a comment\n50 33\n{maxval}\n".encode()
        body = g.astype(">u2" if maxval > 255 else np.uint8).tobytes()
        out[f"pnm_p5_maxval{maxval}_33x50"] = head + body
        text = " ".join(map(str, g.reshape(-1).tolist())).encode()
        out[f"pnm_p2_maxval{maxval}_33x50"] = f"P2 50 # width\n33\n{maxval}\n".encode() + text + b"\n"
    c = rng.integers(0, 8, (7, 13, 3))
    out["pnm_p3_maxval7_7x13"] = b"P3\n13 7 7\n" + "\n".join(
        " ".join(map(str, row)) for row in c.reshape(7, -1).tolist()).encode() + b"\n"
    bits = rng.integers(0, 2, (9, 17))
    out["pnm_p1_packed_9x17"] = b"P1\n17 9\n" + "".join(map(str, bits.reshape(-1))).encode()
    row = np.packbits(bits, axis=1)
    row[:, -1] |= 0x7F  # the padding bits are ignored
    out["pnm_p4_padding_9x17"] = b"P4 17 9\n" + row.tobytes()
    return out


def pages() -> dict:
    """The four 640x640 pages for ``cli.pipeline`` on the card, each from a
    ``chip_smoke.TextPages`` page."""
    import chip_smoke as cs

    out = {}
    img = cs.TextPages(1, 31, (640, 640), noise=8)[0]["image"]
    cmyk = np.concatenate([255 - img, np.zeros(img.shape[:2] + (1,), np.uint8)], -1)
    out["page_cmyk.jpg"] = pil_jpeg(cmyk, "CMYK", quality=90, subsampling=2)
    img = cs.TextPages(1, 32, (640, 640), noise=4)[0]["image"]
    colours, idx = np.unique(img.reshape(-1, 3), axis=0, return_inverse=True)
    out["page_palette.png"] = png_bytes(idx.reshape(640, 640), 8, 3, palette=colours,
                                        filters=(1,))
    img = cs.TextPages(1, 33, (640, 640), noise=2)[0]["image"].astype(np.int64)
    out["page_adam7_16.png"] = png_bytes(img * 257, 16, 2, interlace=1, filters=(1, 2))
    img = cs.TextPages(1, 34, (640, 640), noise=1)[0]["image"]
    colours, idx = np.unique(img.reshape(-1, 3), axis=0, return_inverse=True)
    out["page_rle8.bmp"] = bmp_bytes(idx.reshape(640, 640), 8, colours[:, ::-1], compression=1,
                                     rle=rle_encode(idx.reshape(640, 640), False))
    return out


def cut_pages() -> dict:
    """Four more 640x640 pages: a baseline JPEG cut at about 60% of its
    bytes, a progressive JPEG cut inside its first AC scan, a GIF of at most
    256 colours and an LZW TIFF with Predictor 2."""
    import chip_smoke as cs

    out = {}
    img = cs.TextPages(1, 41, (640, 640), noise=4)[0]["image"]
    data = cv_encode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 85])
    out["page_cut.jpg"] = data[:int(len(data) * 0.6)]
    img = cs.TextPages(1, 42, (640, 640), noise=4)[0]["image"]
    data = cv_encode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                              cv2.IMWRITE_JPEG_QUALITY, 85])
    out["page_progressive_cut.jpg"] = cut_in_scan(data, 1, 0.5)
    img = cs.TextPages(1, 43, (640, 640), noise=1)[0]["image"]
    colours, idx = np.unique(img.reshape(-1, 3), axis=0, return_inverse=True)
    assert len(colours) <= 256
    out["page.gif"] = gif_bytes([dict(idx=idx.reshape(640, 640))], (640, 640), colours)
    img = cs.TextPages(1, 44, (640, 640), noise=1)[0]["image"]
    out["page_lzw_predictor.tif"] = tiff_bytes(img, 8, 2, 5, predictor=2, rows_per_strip=32)
    return out


# --------------------------------------------------------- JPEG cut short
def scans(data: bytes):
    """(SOS offset, data start, data end) of each scan of a JPEG: its data
    runs to the next marker other than RSTn (or to the file's end)."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker != 0xDA:
            pos += 2 + length
            continue
        start = end = pos + 2 + length
        while end < len(data) and not (data[end] == 0xFF and end + 1 < len(data)
                                       and data[end + 1] not in (0, *range(0xD0, 0xD8))):
            end += 1
        out.append((pos, start, end))
        pos = end
    return out


def cut_in_scan(data: bytes, scan: int, fraction: float) -> bytes:
    """``data`` cut ``fraction`` of the way into scan ``scan``'s data."""
    _, start, end = scans(data)[scan]
    return data[:start + int((end - start) * fraction)]


def jpeg_cut_cases(rng) -> dict:
    """JPEGs cut short as scraped sets carry them: ``cv2.imread`` decodes the
    data up to the cut (libjpeg's stdio source supplies an EOI) and greys
    the rest; ``cv2.imdecode`` refuses them."""
    out = {}
    s422 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
    s444 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    base = cv_encode(".jpg", smooth(rng, 33, 50))
    for f in (0.3, 0.55, 0.8, 0.97):
        out[f"jpeg_cut_s420_33x50_at{int(f * 100)}"] = cut_in_scan(base, 0, f)
    _, start, end = scans(base)[0]
    out["jpeg_cut_s420_33x50_after_sos"] = base[:start]
    out["jpeg_cut_s420_33x50_in_sos_tail"] = base[:start - 2]  # Se and Ah/Al from the EOI
    out["jpeg_cut_s420_33x50_in_headers"] = base[:start - 200]  # cv2 refuses it
    for name, (h, w), params, f in (("grey", (37, 100), [], 0.5), ("s444", (7, 13), s444, 0.6),
                                    ("s422", (37, 100), s422, 0.4), ("s420", (1, 1), [], 0.5)):
        img = smooth(rng, h, w, 1 if name == "grey" else 3)
        out[f"jpeg_cut_{name}_{h}x{w}"] = cut_in_scan(cv_encode(".jpg", img, params), 0, f)
    rst = cv_encode(".jpg", smooth(rng, 64, 80), [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    _, start, end = scans(rst)[0]
    marks = [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", rst[start:end])]
    out["jpeg_cut_rst2_s420_64x80_at35"] = cut_in_scan(rst, 0, 0.35)
    out["jpeg_cut_rst2_s420_64x80_before_rst"] = rst[:start + marks[3]]
    out["jpeg_cut_rst2_s420_64x80_after_rst"] = rst[:start + marks[3] + 2]
    multi = jpeg_rescan(cv_encode(".jpg", smooth(rng, 33, 50)), [[0], [1, 2]])
    out["jpeg_cut_multiscan_33x50_scan1"] = cut_in_scan(multi, 0, 0.6)
    out["jpeg_cut_multiscan_33x50_scan2"] = cut_in_scan(multi, 1, 0.5)
    p = cv_encode(".jpg", smooth(rng, 33, 50), prog)
    for name, scan, f in (("dc", 0, 0.5), ("ac_first", 1, 0.4), ("ac_chroma", 2, 0.7),
                          ("refine", 5, 0.5), ("dc_refine", 6, 0.5), ("last", 9, 0.9)):
        out[f"jpeg_cut_progressive_33x50_{name}"] = cut_in_scan(p, scan, f)
    sos = scans(p)
    out["jpeg_cut_progressive_33x50_in_dht"] = p[:sos[1][0] - 6]  # inside the table's symbols
    pr = cv_encode(".jpg", smooth(rng, 37, 100), prog + [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    out["jpeg_cut_progressive_rst3_37x100_ac"] = cut_in_scan(pr, 3, 0.5)
    pg = cv_encode(".jpg", smooth(rng, 37, 100, 1), prog)
    out["jpeg_cut_progressive_grey_37x100_ac"] = cut_in_scan(pg, 1, 0.5)
    # complete files whose scans leave bits unrefined: libjpeg-turbo smooths them
    for (h, w), last in (((33, 50), 6), ((37, 100), 1), ((7, 13), 3), ((1, 1), 2), ((9, 16), 5)):
        q = cv_encode(".jpg", smooth(rng, h, w), prog)
        out[f"jpeg_unrefined_{last}scans_{h}x{w}"] = q[:scans(q)[last][0]] + b"\xff\xd9"
    return out


# -------------------------------------------------------------------- GIF
def gif_lzw(idx, min_size: int, clear_every: int = 0, clear_when_full: bool = True) -> bytes:
    """GIF LZW of a flat index sequence (codes least significant bit first):
    a clear code first, a clear code every ``clear_every`` codes, and when
    the table holds 4096 entries a clear code, or none (``clear_when_full``
    False: the decoder keeps the full table)."""
    clear = 1 << min_size
    out, acc, n = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, n
        acc |= code << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, clear + 2, min_size + 1

    table, nxt, width = reset()
    put(clear, width)
    w, emitted = b"", 0
    for ch in np.asarray(idx, np.uint8).reshape(-1).tobytes():
        c = bytes([ch])
        if w + c in table:
            w += c
            continue
        put(table[w], width)
        emitted += 1
        if nxt < 4096:
            table[w + c] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        elif clear_when_full:
            put(clear, width)
            table, nxt, width = reset()
        w = c
        if clear_every and emitted % clear_every == 0:
            put(clear, width)
            table, nxt, width = reset()
    if w:
        put(table[w], width)
    put(clear + 1, width)
    if n:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _gif_table(colours):
    """(size bits, padded table bytes) of a colour table."""
    size = max(0, int(np.ceil(np.log2(max(len(colours), 2)))) - 1)
    t = np.zeros((2 << size, 3), np.uint8)
    t[:len(colours)] = colours
    return size, t.tobytes()


def gif_bytes(frames, screen, gct=None, bg: int = 0, version: bytes = b"89a",
              extensions: bytes = b"") -> bytes:
    """A GIF of ``frames`` (dicts: ``idx`` (h, w) indices and optionally
    ``left``, ``top``, ``lct``, ``interlace``, ``min_size``, ``transparent``
    and ``lzw`` keyword arguments) on a (height, width) ``screen``."""
    h, w = screen
    flags, table = 0, b""
    if gct is not None:
        size, table = _gif_table(gct)
        flags = 0xF0 | size
    out = b"GIF" + version + struct.pack("<HHBBB", w, h, flags, bg, 0) + table + extensions
    for f in frames:
        idx = np.asarray(f["idx"])
        fh, fw = idx.shape
        if f.get("transparent") is not None:
            out += b"!\xf9\x04\x01\0\0" + bytes([f["transparent"]]) + b"\0"
        fflags, local = 0, b""
        if f.get("lct") is not None:
            size, local = _gif_table(f["lct"])
            fflags = 0x80 | size
        rows = idx
        if f.get("interlace"):
            fflags |= 0x40
            rows = idx[np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                       np.arange(2, fh, 4), np.arange(1, fh, 2)])]
        m = f.get("min_size", 8)
        out += (b"," + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), fw, fh, fflags)
                + local + bytes([m]) + sub_blocks(gif_lzw(rows, m, **f.get("lzw", {}))))
    return out + b";"


def gif_cases(rng) -> dict:
    out = {}
    for i, (h, w) in enumerate(SIZES):
        m = (2, 4, 6, 8)[i]
        pal = rng.integers(0, 256, (1 << m, 3))
        idx = rng.integers(0, 1 << m, (h, w))
        idx[h // 2:] = idx[h // 2:, :1]  # runs too
        out[f"gif_min{m}_{h}x{w}"] = gif_bytes([dict(idx=idx, min_size=m)], (h, w), pal)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (33, 50))
    out["gif_transparent_33x50"] = gif_bytes([dict(idx=idx, min_size=4, transparent=5)],
                                             (33, 50), pal, bg=9)
    out["gif_interlaced_37x100"] = gif_bytes([dict(idx=rng.integers(0, 16, (37, 100)),
                                                   min_size=4, interlace=True)], (37, 100), pal)
    out["gif_small_frame_33x50"] = gif_bytes(
        [dict(idx=rng.integers(0, 16, (20, 31)), min_size=4, left=11, top=7, interlace=True)],
        (33, 50), pal, bg=3)
    out["gif_local_over_global_7x13"] = gif_bytes(
        [dict(idx=rng.integers(0, 32, (7, 13)), min_size=5, lct=rng.integers(0, 256, (8, 3)))],
        (7, 13), rng.integers(0, 256, (32, 3)))
    out["gif_local_only_transparent_7x13"] = gif_bytes(
        [dict(idx=rng.integers(0, 8, (7, 13)), min_size=3, lct=rng.integers(0, 256, (8, 3)),
              transparent=2)], (7, 13))
    out["gif_no_table_7x13"] = gif_bytes([dict(idx=rng.integers(0, 256, (7, 13)))], (7, 13))
    full = rng.integers(0, 256, (48, 100))
    pal256 = rng.integers(0, 256, (256, 3))
    out["gif_full_table_no_clear_48x100"] = gif_bytes(
        [dict(idx=full, lzw=dict(clear_when_full=False))], (48, 100), pal256)
    out["gif_clear_every_300_37x100"] = gif_bytes(
        [dict(idx=full[:37], lzw=dict(clear_every=300))], (37, 100), pal256)
    comment = b"!\xfe" + sub_blocks(b"made by hand")
    loop = b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    idx = rng.integers(0, 16, (7, 13))
    out["gif_two_frames_7x13"] = gif_bytes(
        [dict(idx=idx, min_size=4), dict(idx=15 - idx, min_size=4, transparent=1)], (7, 13),
        pal, extensions=comment + loop)
    out["gif_87a_1x1"] = gif_bytes([dict(idx=[[3]], min_size=2)], (1, 1), pal[:4],
                                  version=b"87a")
    data = gif_bytes([dict(idx=rng.integers(0, 16, (37, 100)), min_size=4)], (37, 100), pal)
    out["gif_cut_37x100"] = data[:len(data) // 2]  # cv2 refuses it
    out["gif_frame_outside_7x13"] = gif_bytes([dict(idx=idx, min_size=4, left=2)], (7, 13), pal)
    out["gif_index_past_table_7x13"] = gif_bytes([dict(idx=idx, min_size=4)], (7, 13), pal[:8])
    return out


# ------------------------------------------------------------------- TIFF
_TIFF_TYPES = {3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}  # RATIONAL: numerator, denominator


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: codes most significant bit first, 9 to
    12 bits, one bit wider when the next free entry reaches 2^bits (the
    decoder sees it one code early), a clear code first and at 4094 entries."""
    out, acc, n = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, n
        acc = (acc << width) | code
        n += width
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 0xFF)
        acc &= (1 << n) - 1

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    put(256, width)
    w = b""
    for ch in data:
        c = bytes([ch])
        if w + c in table:
            w += c
            continue
        put(table[w], width)
        table[w + c] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, width)
            table, nxt, width = reset()
        elif nxt == 1 << width and width < 12:
            width += 1
        w = c
    if w:
        put(table[w], width)
        nxt += 1
        if nxt == 4094:
            put(256, width)
            width = 9
        elif nxt == 1 << width and width < 12:
            width += 1
    put(257, width)
    if n:
        out.append((acc << (8 - n)) & 0xFF)
    return bytes(out)


def tiff_lzw_old_style(data: bytes, clear_after: int = 0, eoi: bool = True,
                       clear_when_full: bool = True) -> bytes:
    """Old-style TIFF LZW as libtiff's ``LZWDecodeCompat`` reads it (no
    encoder here writes it): codes least significant bit first, 9 to 12
    bits, one bit wider once the decoder's table holds 2^bits entries (the
    decoder adds an entry for each code but the first after a clear), a
    clear code first, at 4094 entries (unless ``clear_when_full`` is False:
    then the table stops at 4096 and the decoder's grows on, to its limit
    of 5119) and, with ``clear_after``, after that many codes; the EOI code
    last unless ``eoi`` is False."""
    out, acc, n = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, n
        acc |= code << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9, 258, 0

    table, nxt, width, held, codes = reset()  # held: the decoder's table size
    put(256, width)

    def emit(code):
        nonlocal width, held, codes
        put(code, width)
        if codes:
            held += 1
            if held >= 1 << width and width < 12:
                width += 1
        codes += 1

    w = b""
    for ch in data:
        c = bytes([ch])
        if w + c in table:
            w += c
            continue
        emit(table[w])
        if nxt < 4096:
            table[w + c] = nxt
            nxt += 1
        if (nxt == 4094 and clear_when_full) or codes == clear_after:
            put(256, width)
            table, nxt, width, held, codes = reset()
        w = c
    if w:
        emit(table[w])
    if eoi:
        put(257, width)
    if n:
        out.append(acc & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_compress(raw: bytes, compression: int, old_lzw: bool = False) -> bytes:
    if compression == 5:
        return tiff_lzw_old_style(raw) if old_lzw else tiff_lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits(raw)
    return raw


def tiff_bytes(samples, bps: int, photometric: int, compression: int = 1, order: str = "<",
               planar: int = 1, rows_per_strip: int = None, tile=None, predictor: int = 1,
               colormap=None, extra=None, orientation: int = None, big: bool = False,
               fill_order: int = 1, old_lzw: bool = False, more: dict = None) -> bytes:
    """A TIFF of (h, w) or (h, w, samples) integer ``samples``: strips of
    ``rows_per_strip`` rows or (width, length) ``tile``s, each compressed on
    its own (Predictor 2 differencing each row first; FillOrder 2 reversing
    the bits of each byte after), then the IFD. ``big``: BigTIFF;
    ``old_lzw``: LZW strips old-style (``tiff_lzw_old_style``); ``more``:
    more tags (tag -> (type, values)), SampleFormat (339) or WhitePoint
    (318) say."""
    s = np.asarray(samples, np.int64)
    s = s[..., None] if s.ndim == 2 else s
    h, w, spp = s.shape

    def chunk(block):
        r, c, ch = block.shape
        flat = block.reshape(r, c * ch)
        if predictor == 2:
            flat = flat.copy()
            flat[:, ch:] = (flat[:, ch:] - block.reshape(r, c * ch)[:, :-ch]) & ((1 << bps) - 1)
        if bps == 16:
            raw = flat.astype(order + "u2").tobytes()
        elif bps == 8:
            raw = flat.astype(np.uint8).tobytes()
        else:
            raw = _pack(flat, bps).tobytes()
        out = _tiff_compress(raw, compression, old_lzw)
        return out if fill_order == 1 else bytes(int(f"{b:08b}"[::-1], 2) for b in out)

    planes = [s] if planar == 1 else [s[..., k:k + 1] for k in range(spp)]
    chunks = []
    for p in planes:
        if tile:
            tw, tl = tile
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    block = np.zeros((tl, tw, p.shape[2]), np.int64)
                    part = p[y:y + tl, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(chunk(block))
        else:
            chunks += [chunk(p[y:y + (rows_per_strip or h)])
                       for y in range(0, h, rows_per_strip or h)]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    fields.update({322: (3, [tile[0]]), 323: (3, [tile[1]])} if tile
                  else {278: (4, [rows_per_strip or h])})
    for tag, value in ((317, predictor if predictor != 1 else None), (274, orientation),
                       (266, fill_order if fill_order != 1 else None)):
        if value is not None:
            fields[tag] = (3, [value])
    if colormap is not None:
        fields[320] = (3, np.asarray(colormap).T.reshape(-1).tolist())
    if extra is not None:
        fields[338] = (3, list(extra))
    return tiff_file(chunks, {**fields, **(more or {})}, bool(tile), order, big)


def tiff_file(chunks, fields: dict, tiled: bool, order: str = "<", big: bool = False) -> bytes:
    """A TIFF of ``chunks`` (its strips or tiles, in order) and the IFD
    ``fields`` (tag -> (type, values)), to which the offsets and byte counts
    of the chunks are added: the chunks first, then the values too long for
    their entries, then the IFD."""
    offset_type = 16 if big else 4
    body, offsets = bytearray(), []
    start = 16 if big else 8
    for c in chunks:
        offsets.append(start + len(body))
        body += c + b"\0" * (len(c) % 2)
    fields[324 if tiled else 273] = (offset_type, offsets)
    fields[325 if tiled else 279] = (offset_type, [len(c) for c in chunks])
    inline = 8 if big else 4
    values, entries = bytearray(), []
    for tag in sorted(fields):
        kind, vals = fields[tag]
        raw = struct.pack(order + _TIFF_TYPES[kind] * len(vals), *vals)
        count = len(vals) // 2 if kind == 5 else len(vals)
        if len(raw) > inline:
            entries.append((tag, kind, count, struct.pack(
                order + ("Q" if big else "I"), start + len(body) + len(values))))
            values += raw + b"\0" * (len(raw) % 2)
        else:
            entries.append((tag, kind, count, raw + b"\0" * (inline - len(raw))))
    ifd = start + len(body) + len(values)
    head = (b"II" if order == "<" else b"MM") + (struct.pack(order + "HHHQ", 43, 8, 0, ifd) if big
                                                 else struct.pack(order + "HI", 42, ifd))
    entry = "HHQ" if big else "HHI"
    return (head + bytes(body) + bytes(values)
            + struct.pack(order + ("Q" if big else "H"), len(entries))
            + b"".join(struct.pack(order + entry, t, k, n) + v for t, k, n, v in entries)
            + struct.pack(order + ("Q" if big else "I"), 0))


def pil_tiff(img: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img), mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


def tiff_cases(rng) -> dict:
    out = {}
    for i, (h, w) in enumerate(SIZES):
        img = smooth(rng, h, w)
        for comp, name in ((1, "none"), (5, "lzw"), (8, "deflate"), (32946, "adobe_deflate"),
                           (32773, "packbits")):
            out[f"tiff_{name}_rgb_{h}x{w}"] = tiff_bytes(img, 8, 2, comp, "<>"[i % 2],
                                                          rows_per_strip=max(1, h // 3))
    g16 = smooth(rng, 37, 100, 1).astype(np.int64) * 257 + rng.integers(0, 257, (37, 100))
    rgb16 = smooth(rng, 33, 50).astype(np.int64) * 257 + rng.integers(0, 257, (33, 50, 3))
    out["tiff_lzw_predictor_rgb16_33x50"] = tiff_bytes(rgb16, 16, 2, 5, predictor=2,
                                                       rows_per_strip=8)
    out["tiff_deflate_predictor_grey16_be_37x100"] = tiff_bytes(g16, 16, 1, 8, ">", predictor=2)
    out["tiff_lzw_predictor_planar_be_37x100"] = tiff_bytes(smooth(rng, 37, 100), 8, 2, 5, ">",
                                                            planar=2, predictor=2,
                                                            rows_per_strip=10)
    out["tiff_min_is_white16_7x13"] = tiff_bytes(g16[:7, :13], 16, 0, 32946)
    for bps in (1, 8):
        g = rng.integers(0, 1 << bps, (33, 50))
        out[f"tiff_min_is_white{bps}_33x50"] = tiff_bytes(g, bps, 0, 5)
        out[f"tiff_min_is_black{bps}_7x13"] = tiff_bytes(g[:7, :13], bps, 1, 32773)
    for i, (bps, (h, w)) in enumerate(((1, (7, 13)), (4, (33, 50)), (8, (37, 100)), (8, (1, 1)))):
        cmap = rng.integers(0, 65536 if i % 2 else 256, (1 << bps, 3))
        out[f"tiff_palette{bps}_{'16bit' if i % 2 else '8bit'}_map_{h}x{w}"] = tiff_bytes(
            rng.integers(0, 1 << bps, (h, w)), bps, 3, (5, 8, 32773, 1)[i], colormap=cmap)
    rgba = np.concatenate([smooth(rng, 33, 50), rng.integers(0, 256, (33, 50, 1))], -1)
    for code, name in ((2, "unassociated"), (1, "associated"), (0, "unspecified")):
        out[f"tiff_rgba_{name}_33x50"] = tiff_bytes(rgba, 8, 2, 8, extra=[code])
    out["tiff_rgba_no_extrasamples_7x13"] = tiff_bytes(rgba[:7, :13], 8, 2, 5)
    out["tiff_rgba16_unassociated_planar_37x100"] = tiff_bytes(
        np.concatenate([rgb16, rgb16[..., :1]], -1)[:33, :50], 16, 2, 8, planar=2, extra=[2])
    ga = np.stack([smooth(rng, 37, 100, 1), rng.integers(0, 256, (37, 100))], -1)
    out["tiff_grey_alpha_37x100"] = tiff_bytes(ga, 8, 1, 5, extra=[2])
    out["tiff_grey_alpha_planar_unassociated_37x100"] = tiff_bytes(ga, 8, 1, 5, planar=2,
                                                                   extra=[2])
    cmyk = smooth(rng, 33, 50, 4)
    out["tiff_cmyk_33x50"] = tiff_bytes(cmyk, 8, 5, 5)
    out["tiff_cmyk_planar_7x13"] = tiff_bytes(cmyk[:7, :13], 8, 5, 32773, planar=2)
    img = smooth(rng, 37, 100)
    out["tiff_tiles_lzw_37x100"] = tiff_bytes(img, 8, 2, 5, tile=(32, 16))
    out["tiff_tiles_uncompressed_37x100"] = tiff_bytes(img, 8, 2, 1, tile=(16, 16))
    out["tiff_tiles_grey16_clipped_37x100"] = tiff_bytes(g16, 16, 1, 8, tile=(32, 32))
    out["tiff_tiles_grey_alpha_clipped_37x100"] = tiff_bytes(ga, 8, 1, 32773, tile=(48, 16),
                                                             extra=[1])
    out["tiff_tiles_orientation2_37x100"] = tiff_bytes(img, 8, 2, 8, tile=(32, 16), orientation=2)
    sq = smooth(rng, 33, 33)
    for o in range(2, 9):
        out[f"tiff_orientation{o}_33x50"] = tiff_bytes(smooth(rng, 33, 50), 8, 2, 8, orientation=o)
    out["tiff_orientation6_square_33x33"] = tiff_bytes(sq, 8, 2, 5, orientation=6)
    out["tiff_bigtiff_33x50"] = tiff_bytes(smooth(rng, 33, 50), 8, 2, 5, big=True)
    out["tiff_fill_order2_7x13"] = tiff_bytes(smooth(rng, 7, 13), 8, 2, 5, fill_order=2)
    page = smooth(rng, 37, 100)
    out["tiff_pil_lzw_rgb_37x100"] = pil_tiff(page, "RGB", compression="tiff_lzw")
    out["tiff_pil_deflate_grey_33x50"] = pil_tiff(smooth(rng, 33, 50, 1), "L",
                                                  compression="tiff_adobe_deflate")
    out["tiff_pil_packbits_rgba_7x13"] = pil_tiff(rgba[:7, :13].astype(np.uint8), "RGBA",
                                                  compression="packbits")
    return out


# ---------------------------------------------------- JPEG-compressed TIFF
#: cv2's IMWRITE_JPEG_SAMPLING_FACTOR values -> the luma (h, v) factors
JPEG_SAMPLING = {0x111111: (1, 1), 0x211111: (2, 1), 0x121111: (1, 2), 0x221111: (2, 2),
                 0x411111: (4, 1)}


def split_jpeg_tables(data: bytes):
    """A JPEG -> (its DQT and DHT segments as a tables-only stream, SOI ...
    EOI; the rest as an abbreviated stream)."""
    segs = jpeg_segments(data)
    tables = b"".join(data[a:b] for m, a, b in segs if m in (0xDB, 0xC4))
    rest = b"".join(data[a:b] for m, a, b in segs if m not in (0xDB, 0xC4))
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest + data[segs[-1][2]:]


def tiff_jpeg_bytes(img: np.ndarray, photometric: int = 6, sampling: int = 0x221111,
                    rows_per_strip: int = 16, tile=None, tables: bool = False,
                    subsampling_tag: bool = True, quality: int = 85, last_full: bool = False,
                    params=(), orientation: int = None) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of (h, w, 3) RGB or (h, w)
    grey: each strip (``rows_per_strip``) or (width, length) ``tile`` a JPEG
    of its own from cv2 (YCbCr at ``sampling``, or grey), with its tables,
    or (``tables``) abbreviated and the tables in ``JPEGTables``;
    photometric 6 (YCbCr, ``YCbCrSubsampling`` written as the JPEG's
    unless ``subsampling_tag`` is False or another (h, v)), 2 (the same YCbCr JPEG declared RGB) or
    0/1 (grey). ``last_full``: the last strip coded at full height."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    blocks = []
    if tile:
        tw, tl = tile
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                block = np.zeros((tl, tw) + img.shape[2:], np.uint8)
                part = img[y:y + tl, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
                blocks.append(block)
    else:
        for y in range(0, h, rows_per_strip):
            block = img[y:y + rows_per_strip]
            if last_full and len(block) < rows_per_strip:
                block = np.concatenate([block, block[-1:].repeat(rows_per_strip - len(block), 0)])
            blocks.append(block)
    p = [cv2.IMWRITE_JPEG_QUALITY, quality, *params]
    if spp == 3:
        p += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    chunks = [cv_encode(".jpg", b[..., ::-1] if spp == 3 else b, p) for b in blocks]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [1])}
    fields.update({322: (3, [tile[0]]), 323: (3, [tile[1]])} if tile
                  else {278: (4, [rows_per_strip])})
    if tables:
        split = [split_jpeg_tables(c) for c in chunks]
        fields[347] = (7, list(split[0][0]))
        chunks = [s for _, s in split]
    if photometric == 6 and subsampling_tag:
        fields[530] = (3, list(JPEG_SAMPLING[sampling] if subsampling_tag is True
                               else subsampling_tag))
    if orientation is not None:
        fields[274] = (3, [orientation])
    return tiff_file(chunks, fields, bool(tile))


def tiff_jpeg_cases(rng) -> dict:
    """JPEG-compressed TIFFs: YCbCr strips at every size (abbreviated, with
    ``JPEGTables``), each sampling, tiles, grey, PIL's RGB files, the last
    strip at full height, no subsampling tag, restart intervals, a
    progressive strip, an orientation, and a subsampling tag that disagrees
    with the JPEG (cv2 refuses it)."""
    out = {}
    for h, w in SIZES:
        out[f"tiffjpeg_ycbcr420_tables_{h}x{w}"] = tiff_jpeg_bytes(smooth(rng, h, w), tables=True)
    img = smooth(rng, 37, 100)
    for sampling, name in ((0x111111, "444"), (0x211111, "422"), (0x121111, "440"),
                           (0x221111, "420")):
        out[f"tiffjpeg_ycbcr{name}_strips8_37x100"] = tiff_jpeg_bytes(img, sampling=sampling,
                                                                      rows_per_strip=16)
    out["tiffjpeg_ycbcr411_no_subsampling_tag_37x100"] = tiff_jpeg_bytes(
        img, sampling=0x411111, subsampling_tag=False)
    out["tiffjpeg_ycbcr420_no_subsampling_tag_33x50"] = tiff_jpeg_bytes(
        smooth(rng, 33, 50), subsampling_tag=False, tables=True)
    out["tiffjpeg_ycbcr411_wrong_subsampling_tag_33x50"] = tiff_jpeg_bytes(
        smooth(rng, 33, 50), sampling=0x411111, subsampling_tag=(1, 1))  # refused
    out["tiffjpeg_ycbcr420_tiles16_37x100"] = tiff_jpeg_bytes(img, tile=(16, 16))
    out["tiffjpeg_ycbcr444_tiles32x16_tables_37x100"] = tiff_jpeg_bytes(
        img, sampling=0x111111, tile=(32, 16), tables=True, quality=60)
    out["tiffjpeg_ycbcr420_last_strip_full_33x50"] = tiff_jpeg_bytes(smooth(rng, 33, 50),
                                                                     last_full=True)
    out["tiffjpeg_ycbcr420_restarts_37x100"] = tiff_jpeg_bytes(
        img, rows_per_strip=32, params=[cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    out["tiffjpeg_ycbcr420_progressive_33x50"] = tiff_jpeg_bytes(
        smooth(rng, 33, 50), params=[cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out["tiffjpeg_ycbcr420_orientation6_33x33"] = tiff_jpeg_bytes(smooth(rng, 33, 33),
                                                                  orientation=6)
    out["tiffjpeg_ycbcr420_orientation3_33x50"] = tiff_jpeg_bytes(smooth(rng, 33, 50),
                                                                  orientation=3)
    out["tiffjpeg_rgb_photometric_444_33x50"] = tiff_jpeg_bytes(smooth(rng, 33, 50),
                                                                photometric=2, sampling=0x111111)
    grey = smooth(rng, 37, 100, 1)
    out["tiffjpeg_grey_strips_37x100"] = tiff_jpeg_bytes(grey, photometric=1, tables=True)
    out["tiffjpeg_grey_tiles16_37x100"] = tiff_jpeg_bytes(grey, photometric=1, tile=(16, 16))
    out["tiffjpeg_min_is_white_7x13"] = tiff_jpeg_bytes(grey[:7, :13], photometric=0)
    out["tiffjpeg_pil_rgb_37x100"] = pil_tiff(smooth(rng, 37, 100), "RGB", compression="jpeg")
    out["tiffjpeg_pil_rgb_q40_7x13"] = pil_tiff(smooth(rng, 7, 13), "RGB", compression="jpeg",
                                                quality=40)
    out["tiffjpeg_pil_grey_33x50"] = pil_tiff(smooth(rng, 33, 50, 1), "L", compression="jpeg")
    return out


def _alpha_stream(alpha: np.ndarray) -> bytes:
    """An ALPH chunk's lossless stream: the alpha plane as the green of a
    VP8L image without its header (the script's own VP8L writer)."""
    a = np.zeros(alpha.shape + (4,), np.uint8)
    a[..., 0] = 255
    a[..., 2] = alpha
    return vp8l_bytes(a, [("green",)], header=False)


def webp_cases(rng) -> dict:
    """WebP: lossless and lossy at ``SIZES`` (cv2 and PIL), RGBA both ways,
    lossy files of the simple loop filter, sharpness, segments and 2 or 8
    token partitions (``libwebp_lossy``), hand-made VP8L streams (``vp8l_bytes``: each
    transform, both code forms, the colour cache, meta prefix codes),
    lossless ALPH chunks, EXIF Orientation 1-8, two-frame animations (PIL's
    and by hand: a first frame smaller than the canvas, alpha with each
    blending and disposal flag, EXIF), a bare VP8L bitstream, files cut at
    50, 80 and 97% and padded with zeros, and files cv2 refuses."""
    out = {}
    for i, (h, w) in enumerate(SIZES):
        img = smooth(rng, h, w)
        out[f"webp_lossless_cv2_{h}x{w}"] = cv_encode(".webp", img[..., ::-1],
                                                      [cv2.IMWRITE_WEBP_QUALITY, 101])
        out[f"webp_lossless_pil_m{2 * i}_{h}x{w}"] = pil_webp(img, "RGB", lossless=True,
                                                              method=2 * i, quality=30 * i)
        out[f"webp_lossy_q80_{h}x{w}"] = cv_encode(".webp", img[..., ::-1],
                                                   [cv2.IMWRITE_WEBP_QUALITY, 80])
        out[f"webp_lossy_pil_q{20 + 25 * i}_{h}x{w}"] = pil_webp(img, "RGB", quality=20 + 25 * i,
                                                                 method=6 - i)
        rgba = np.concatenate([img, rng.integers(0, 256, (h, w, 1))], -1)
        out[f"webp_rgba_lossless_{h}x{w}"] = pil_webp(rgba, "RGBA", lossless=True)
        out[f"webp_rgba_lossy_{h}x{w}"] = pil_webp(rgba, "RGBA", quality=70)
    noisy = np.clip(smooth(rng, 64, 80).astype(np.int64) + rng.integers(-40, 41, (64, 80, 3)),
                    0, 255)
    for k, cfg in enumerate((dict(filter_type=0, filter_strength=60),
                             dict(filter_type=0, filter_sharpness=5, filter_strength=90),
                             dict(filter_type=1, filter_sharpness=3, segments=4),
                             dict(filter_type=1, filter_strength=0, segments=1),
                             dict(partitions=3, method=1), dict(partitions=1, method=2,
                                                                filter_type=0))):
        name = "_".join(f"{a}{b}" for a, b in cfg.items())
        out[f"webp_libwebp_{name}_64x80"] = libwebp_lossy(noisy, 40.0 + 10 * k, **cfg)
    argb = np.concatenate([np.full((13, 37, 1), 255), smooth(rng, 13, 37)], -1)
    bw = 4 * 10  # blocks of 4 pixels
    vp8l = {
        "green": [("green",)],
        "colour": [("colour", 2, rng.integers(-128, 128, (bw, 3)))],
        "predict_modes": [("predict", 2, [m % 14 for m in range(bw)])],
        "green_predict_colour": [("green",), ("predict", 3, list(rng.integers(0, 14, 10))),
                                 ("colour", 2, rng.integers(-128, 128, (bw, 3)))],
    }
    for name, transforms in vp8l.items():
        out[f"webp_vp8l_{name}_13x37"] = webp_file(riff_chunk(b"VP8L", vp8l_bytes(argb,
                                                                                 transforms)))
    for n in (2, 3, 11, 200):
        pal = np.concatenate([np.full((n, 1), 255), rng.integers(0, 256, (n, 3))], -1)
        img = pal[rng.integers(0, n, (13, 37))]
        out[f"webp_vp8l_palette{n}_13x37"] = webp_file(riff_chunk(b"VP8L", vp8l_bytes(
            img, [("palette",)], cache_bits=3)))
    out["webp_vp8l_cache_meta_codes_13x37"] = webp_file(riff_chunk(b"VP8L", vp8l_bytes(
        argb, cache_bits=5, group_bits=2, groups=list(rng.integers(0, 4, bw)))))
    out["webp_vp8l_normal_codes_13x37"] = webp_file(riff_chunk(b"VP8L", vp8l_bytes(
        argb[..., [0, 1, 1, 1]] // 128 * 255, simple=False, lz77=False)))
    out["webp_vp8l_simple_codes_13x37"] = webp_file(riff_chunk(b"VP8L", vp8l_bytes(
        argb[..., [0, 1, 1, 1]] // 128 * 255, lz77=False)))
    img = smooth(rng, 33, 50)
    vp8 = webp_payload(cv_encode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 75]),
                       b"VP8 ")
    alpha = rng.integers(0, 256, (33, 50))
    stream = _alpha_stream(alpha)
    for head, name in ((0x01, "lossless"), (0x05, "lossless_horizontal"),
                       (0x1D, "lossless_gradient_levels"), (0x00, "raw")):
        body = stream if head else alpha.astype(np.uint8).tobytes()
        out[f"webp_alph_{name}_33x50"] = webp_file(vp8x_chunk(0x10, 50, 33) + riff_chunk(
            b"ALPH", bytes([head]) + body) + riff_chunk(b"VP8 ", vp8))
    out["webp_alph_reserved_bits_33x50"] = webp_file(vp8x_chunk(0x10, 50, 33) + riff_chunk(
        b"ALPH", b"\xc1" + stream) + riff_chunk(b"VP8 ", vp8))  # refused
    out["webp_alph_cut_33x50"] = webp_file(vp8x_chunk(0x10, 50, 33) + riff_chunk(
        b"ALPH", b"\x01" + stream[:len(stream) // 2]) + riff_chunk(b"VP8 ", vp8))  # refused
    small = smooth(rng, 7, 13)
    lossless = webp_payload(cv_encode(".webp", small[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 101]),
                            b"VP8L")
    for o in range(1, 9):
        out[f"webp_exif{o}_7x13"] = webp_file(vp8x_chunk(0x08, 13, 7) + riff_chunk(
            b"VP8L", lossless) + riff_chunk(b"EXIF", exif_tiff(o, "<>"[o % 2])))
    out["webp_exif6_lossy_33x50"] = webp_file(vp8x_chunk(0x08, 50, 33) + riff_chunk(
        b"VP8 ", vp8) + riff_chunk(b"EXIF", exif_tiff(6)))
    out["webp_exif6_unflagged_7x13"] = webp_file(vp8x_chunk(0, 13, 7) + riff_chunk(
        b"VP8L", lossless) + riff_chunk(b"EXIF", exif_tiff(6)))
    out["webp_exif6_reserved_flags_7x13"] = webp_file(vp8x_chunk(0xC8, 13, 7) + riff_chunk(
        b"VP8L", lossless) + riff_chunk(b"EXIF", exif_tiff(6)))
    out["webp_exif8_iccp_xmp_7x13"] = webp_file(
        vp8x_chunk(0x2C, 13, 7) + riff_chunk(b"ICCP", bytes(rng.integers(0, 256, 31, np.uint8)))
        + riff_chunk(b"VP8L", lossless) + riff_chunk(b"EXIF", exif_tiff(8))
        + riff_chunk(b"XMP ", b"<x:xmpmeta/>"))
    frames = [smooth(rng, 33, 50), smooth(rng, 33, 50)]
    out["webp_anim_pil_lossless_33x50"] = pil_webp_animation(frames, lossless=True)
    out["webp_anim_pil_lossy_33x50"] = pil_webp_animation(frames, quality=60)
    second = webp_payload(cv_encode(".webp", frames[1][..., ::-1],
                                    [cv2.IMWRITE_WEBP_QUALITY, 101]), b"VP8L")
    out["webp_anim_small_first_frame_33x50"] = animation(
        [(6, 4, 13, 7, 0, riff_chunk(b"VP8L", lossless)), (0, 0, 50, 33, 0,
                                                            riff_chunk(b"VP8L", second))],
        50, 33, background=0xFF2040C0)
    rgba = np.concatenate([small, rng.integers(0, 256, (7, 13, 1))], -1)
    frame = webp_payload(pil_webp(rgba, "RGBA", lossless=True), b"VP8L")
    for flags in range(4):
        out[f"webp_anim_alpha_flags{flags}_33x50"] = animation(
            [(10, 20, 13, 7, flags, riff_chunk(b"VP8L", frame)), (0, 0, 50, 33, 0,
                                                                 riff_chunk(b"VP8L", second))],
            50, 33, flags=0x12, background=0x80402010)
    out["webp_anim_lossy_alpha_33x50"] = animation(
        [(0, 0, 50, 33, 2, riff_chunk(b"ALPH", b"\x01" + stream) + riff_chunk(b"VP8 ", vp8))],
        50, 33, flags=0x12)
    out["webp_anim_exif6_33x50"] = animation(
        [(0, 0, 50, 33, 0, riff_chunk(b"VP8L", second))], 50, 33, flags=0x0A,
        extra=riff_chunk(b"EXIF", exif_tiff(6)))
    out["webp_anim_frame_past_canvas_33x50"] = animation(  # refused
        [(40, 0, 13, 7, 0, riff_chunk(b"VP8L", lossless))], 50, 33)
    out["webp_bare_vp8l_7x13"] = lossless
    whole = {"lossless": out["webp_lossless_cv2_37x100"], "lossy": out["webp_lossy_q80_37x100"],
             "anim": out["webp_anim_small_first_frame_33x50"]}
    for name, data in whole.items():
        for f in (0.5, 0.8, 0.97):
            out[f"webp_cut{int(f * 100)}_{name}"] = data[:int(len(data) * f)]
        out[f"webp_padded_{name}"] = data + bytes(10)
    out["webp_canvas_mismatch_7x13"] = webp_file(vp8x_chunk(0, 14, 7) + riff_chunk(b"VP8L",
                                                                                   lossless))
    out["webp_riff_size_short_7x13"] = webp_file(riff_chunk(b"VP8L", lossless),
                                                 riff_size=len(lossless) + 6)
    out["webp_31_bytes"] = out["webp_lossless_cv2_1x1"][:31]
    return out


def webp_jpeg_tiff_pages() -> dict:
    """Three 640x640 pages from ``chip_smoke.TextPages``: a lossless WebP (of
    the page's first channel), a lossy WebP at quality 80 and a
    JPEG-compressed TIFF (YCbCr 4:2:0 strips of 64 rows with
    ``JPEGTables``)."""
    import chip_smoke as cs

    out = {}
    img = cs.TextPages(1, 51, (640, 640), noise=2)[0]["image"]
    img = np.repeat(img[..., :1], 3, 2)  # grey: a third of the noise's bytes
    out["page_lossless.webp"] = cv_encode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 101])
    img = cs.TextPages(1, 52, (640, 640), noise=8)[0]["image"]
    out["page_lossy.webp"] = pil_webp(img, "RGB", quality=80)
    img = cs.TextPages(1, 53, (640, 640), noise=4)[0]["image"]
    out["page_jpeg.tif"] = tiff_jpeg_bytes(img, rows_per_strip=64, tables=True, quality=90)
    return out


# ------------------------------------------------------------------ WebP
def riff_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: tag, little-endian size, payload, a pad byte if odd."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def webp_file(body: bytes, riff_size: int = None) -> bytes:
    """``RIFF`` + size + ``WEBP`` + the chunks in ``body``."""
    size = len(body) + 4 if riff_size is None else riff_size
    return b"RIFF" + struct.pack("<I", size) + b"WEBP" + body


def vp8x_chunk(flags: int, w: int, h: int) -> bytes:
    return riff_chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def anmf_chunk(x: int, y: int, w: int, h: int, flags: int, frame: bytes,
               duration: int = 100) -> bytes:
    """An animation frame at (x, y) (even), ``frame`` its ALPH/VP8/VP8L chunks."""
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, duration))
    return riff_chunk(b"ANMF", head + bytes([flags]) + frame)


def animation(frames, w: int, h: int, flags: int = 0x02, extra: bytes = b"",
              background: int = 0) -> bytes:
    """An animated WebP: VP8X, ANIM, one ANMF a (x, y, w, h, flags, chunks)."""
    return webp_file(vp8x_chunk(flags, w, h) + riff_chunk(b"ANIM", struct.pack(
        "<IH", background, 0)) + b"".join(anmf_chunk(*f) for f in frames) + extra)


def webp_chunks(data: bytes) -> list:
    """A RIFF WebP's (tag, payload) chunks."""
    out, at = [], 12
    while at + 8 <= len(data):
        n = struct.unpack("<I", data[at + 4:at + 8])[0]
        out.append((data[at:at + 4], data[at + 8:at + 8 + n]))
        at += 8 + n + (n & 1)
    return out


def webp_payload(data: bytes, tag: bytes) -> bytes:
    return next(p for t, p in webp_chunks(data) if t == tag)


def pil_webp(img: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img).astype(np.uint8), mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


def pil_webp_animation(frames, **kw) -> bytes:
    buf = io.BytesIO()
    ims = [Image.fromarray(np.ascontiguousarray(f).astype(np.uint8)) for f in frames]
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:], duration=100, **kw)
    return buf.getvalue()


#: libwebp's ``WebPConfig`` fields (byte offsets, all 4-byte) that
#: ``libwebp_lossy`` sets; PIL and cv2 do not reach them
_WEBP_CONFIG = dict(quality=4, method=8, segments=24, sns_strength=28, filter_strength=32,
                    filter_sharpness=36, filter_type=40, autofilter=44, partitions=72)


def libwebp_lossy(img: np.ndarray, quality: float, **fields) -> bytes:
    """A lossy WebP of (h, w, 3) RGB from the system's libwebp through its
    advanced API (``WebPEncode``), with ``_WEBP_CONFIG`` fields set: the
    simple loop filter (``filter_type=0``), sharpness, segments, token
    partitions (written by methods 0-2 only). ``WebPPicture`` is laid out as libwebp 1.x lays it out
    (width and height at bytes 8 and 12, the writer at 96, its data at 104)."""
    import ctypes
    import ctypes.util

    lib = ctypes.CDLL(ctypes.util.find_library("webp"))
    abi = 0x0200
    cfg = ctypes.create_string_buffer(256)
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), abi)
    for k, v in fields.items():
        ctypes.c_int.from_buffer(cfg, _WEBP_CONFIG[k]).value = v
    assert lib.WebPValidateConfig(cfg)
    pic = ctypes.create_string_buffer(512)
    assert lib.WebPPictureInitInternal(pic, abi)
    h, w = img.shape[:2]
    ctypes.c_int.from_buffer(pic, 8).value = w
    ctypes.c_int.from_buffer(pic, 12).value = h
    rgb = np.ascontiguousarray(img, np.uint8)
    assert lib.WebPPictureImportRGB(pic, rgb.ctypes.data_as(ctypes.c_void_p), 3 * w)
    writer = ctypes.create_string_buffer(64)
    lib.WebPMemoryWriterInit(writer)
    ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(lib.WebPMemoryWrite,
                                                             ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
    ok = lib.WebPEncode(cfg, pic)
    lib.WebPPictureFree(pic)
    assert ok
    out = ctypes.string_at(ctypes.c_void_p.from_buffer(writer, 0).value,
                           ctypes.c_size_t.from_buffer(writer, 8).value)
    lib.WebPMemoryWriterClear(writer)
    return out


class LsbBits:
    """A bit writer, least significant bit first (VP8L's order)."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        self.acc |= (int(value) & ((1 << n) - 1)) << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def data(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def complete_lengths(n: int) -> list:
    """Code lengths of a complete prefix code of ``n`` > 1 leaves."""
    k = n.bit_length() - 1
    m = n - (1 << k)
    return [k + 1] * (2 * m) + [k] * ((1 << k) - m)


VP8L_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _canonical(lengths: dict) -> dict:
    """symbol -> code length -> symbol -> (bits as written LSB first, length)."""
    out, code, prev = {}, 0, 0
    for sym, n in sorted(lengths.items(), key=lambda kv: (kv[1], kv[0])):
        code <<= n - prev
        prev = n
        out[sym] = (int(f"{code:0{n}b}"[::-1], 2), n)
        code += 1
    return out


def put_vp8l_code(bits: LsbBits, used, alphabet: int, simple: bool = True) -> dict:
    """A VP8L prefix code for the symbols ``used`` -> symbol -> (bits,
    length): the simple form for one or two symbols below 256 (``simple``),
    else the normal form, each symbol's length written through a code-length
    code of its own."""
    used = sorted(set(used))
    if simple and len(used) <= 2 and used[-1] < 256:
        bits.put(1, 1)
        bits.put(len(used) - 1, 1)
        eight = used[0] > 1
        bits.put(eight, 1)
        bits.put(used[0], 8 if eight else 1)
        if len(used) == 2:
            bits.put(used[1], 8)
            return {used[0]: (0, 1), used[1]: (1, 1)}
        return {used[0]: (0, 0)}
    lengths = dict(zip(used, complete_lengths(len(used)))) if len(used) > 1 else {used[0]: 1}
    per_symbol = [lengths.get(s, 0) for s in range(alphabet)]
    values = sorted(set(per_symbol))
    cl = dict(zip(values, complete_lengths(len(values)))) if len(values) > 1 else {values[0]: 1}
    cl_codes = _canonical(cl) if len(values) > 1 else {values[0]: (0, 0)}
    bits.put(0, 1)
    last = max(i for i, s in enumerate(VP8L_CODE_LENGTH_ORDER) if s in cl)
    count = max(4, last + 1)
    bits.put(count - 4, 4)
    for s in VP8L_CODE_LENGTH_ORDER[:count]:
        bits.put(cl.get(s, 0), 3)
    bits.put(0, 1)  # every symbol's length is written
    for n in per_symbol:
        bits.put(*cl_codes[n])
    return _canonical(lengths) if len(used) > 1 else {used[0]: (0, 0)}


def _prefix(value: int):
    """An LZ77 length or distance (>= 1) -> (prefix symbol, extra bits, count)."""
    if value <= 4:
        return value - 1, 0, 0
    n = value - 1
    h = n.bit_length() - 1
    second = (n >> (h - 1)) & 1
    return 2 * h + second, n & ((1 << (h - 1)) - 1), h - 1


def _vp8l_tokens(px: list, width: int, cache_bits: int, lz77: bool) -> list:
    """Pixels (ARGB ints) -> tokens: ('lit', argb), ('cache', key) or
    ('copy', length, distance code): greedy copies from the left pixel or
    the one above (short distance codes 2 and 1) or from 3 pixels back
    (a long code), at least 3 long; a cache hit where the pixel is in it."""
    cache = {} if cache_bits else None
    out, i, n = [], 0, len(px)

    def add(p):
        if cache is not None:
            cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)] = p

    while i < n:
        best = (0, 0, 0)
        if lz77:
            for dist, code in ((1, 2), (width, 1), (3, 3 + 120)):
                if dist > i:
                    continue
                k = 0
                while i + k < n and k < 4096 and px[i + k] == px[i + k - dist]:
                    k += 1
                if k > best[0]:
                    best = (k, dist, code)
        if best[0] >= 3:
            out.append(("copy", best[0], best[2]))
            for p in px[i:i + best[0]]:
                add(p)
            i += best[0]
            continue
        p = px[i]
        key = ((p * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits) if cache_bits else None
        if cache is not None and cache.get(key) == p:
            out.append(("cache", key))
        else:
            out.append(("lit", p))
        add(p)
        i += 1
    return out


def _put_vp8l_image(bits: LsbBits, px: list, width: int, cache_bits: int = 0,
                    lz77: bool = True, groups=None, group_bits: int = 0,
                    simple: bool = True, level0: bool = False) -> None:
    """One entropy-coded image: the colour cache, at level 0 the meta prefix
    codes (``groups``: a group index for each block of 2^group_bits pixels,
    read row by row), each group's five codes, then the tokens."""
    if cache_bits:
        bits.put(1, 1)
        bits.put(cache_bits, 4)
    else:
        bits.put(0, 1)
    tokens = _vp8l_tokens(px, width, cache_bits, lz77)
    if level0:
        bits.put(groups is not None, 1)
    if groups is not None:
        bits.put(group_bits - 2, 3)
        gw = -(-width // (1 << group_bits))
        _put_vp8l_image(bits, [g << 8 for g in groups], gw, lz77=False)
    at_group, pos = [], 0
    for t in tokens:
        y, x = divmod(pos, width)
        at_group.append(groups[(y >> group_bits) * -(-width // (1 << group_bits))
                               + (x >> group_bits)] if groups is not None else 0)
        pos += t[1] if t[0] == "copy" else 1
    n_groups = max(groups) + 1 if groups is not None else 1
    codes = []
    for g in range(n_groups):
        sets = [set(), set(), set(), set(), set()]
        for t, gi in zip(tokens, at_group):
            if gi != g:
                continue
            if t[0] == "lit":
                p = t[1]
                for k, v in enumerate(((p >> 8) & 255, (p >> 16) & 255, p & 255, p >> 24)):
                    sets[k].add(v)
            elif t[0] == "cache":
                sets[0].add(280 + t[1])
            else:
                sets[0].add(256 + _prefix(t[1])[0])
                sets[4].add(_prefix(t[2])[0])
        alphabets = (280 + ((1 << cache_bits) if cache_bits else 0), 256, 256, 256, 40)
        codes.append([put_vp8l_code(bits, s or {0}, a, simple) for s, a in zip(sets, alphabets)])
    for t, g in zip(tokens, at_group):
        green, red, blue, alpha, dist = codes[g]
        if t[0] == "lit":
            p = t[1]
            bits.put(*green[(p >> 8) & 255])
            bits.put(*red[(p >> 16) & 255])
            bits.put(*blue[p & 255])
            bits.put(*alpha[p >> 24])
        elif t[0] == "cache":
            bits.put(*green[280 + t[1]])
        else:
            sym, extra, n = _prefix(t[1])
            bits.put(*green[256 + sym])
            bits.put(extra, n)
            sym, extra, n = _prefix(t[2])
            bits.put(*dist[sym])
            bits.put(extra, n)


def _argb(c) -> int:
    a, r, g, b = (int(v) & 255 for v in c)
    return (a << 24) | (r << 16) | (g << 8) | b


def _vp8l_predict(mode: int, L, T, TR, TL):
    """RFC 9649's predictors on (a, r, g, b) tuples, one pixel."""
    avg = lambda u, v: tuple((p + q) >> 1 for p, q in zip(u, v))  # noqa: E731
    clip = lambda v: min(255, max(0, v))  # noqa: E731
    if mode == 0:
        return (255, 0, 0, 0)
    if mode <= 4:
        return (L, T, TR, TL)[mode - 1]
    if mode == 5:
        return avg(avg(L, TR), T)
    if mode == 6:
        return avg(L, TL)
    if mode == 7:
        return avg(L, T)
    if mode == 8:
        return avg(TL, T)
    if mode == 9:
        return avg(T, TR)
    if mode == 10:
        return avg(avg(L, TL), avg(T, TR))
    if mode == 11:
        pl = sum(abs(t - tl) for t, tl in zip(T, TL))
        pt = sum(abs(l_ - tl) for l_, tl in zip(L, TL))
        return L if pl < pt else T
    if mode == 12:
        return tuple(clip(l_ + t - tl) for l_, t, tl in zip(L, T, TL))
    a = avg(L, T)
    return tuple(clip(v + int((v - tl) / 2)) for v, tl in zip(a, TL))


def vp8l_bytes(argb: np.ndarray, transforms=(), cache_bits: int = 0, lz77: bool = True,
               group_bits: int = 0, groups=None, alpha_hint: bool = False,
               simple: bool = True, header: bool = True) -> bytes:
    """A VP8L bitstream of (h, w, 4) uint8 (a, r, g, b) pixels written by
    this script's own encoder, so that each feature of RFC 9649 can be held
    to cv2 on its own. ``transforms``, applied in turn and written in that
    order: ('green',), ('colour', bits, (n, 3) int8 multipliers (green to
    red, green to blue, red to blue) a block), ('predict', bits, modes a
    block), ('palette',) (every colour of the image, at most 256, in order
    of first use; pixels bundled by the palette's size). ``groups``: meta
    prefix codes, a group a block of ``group_bits``. ``header``: the 0x2f
    signature and the size fields (False: an ALPH chunk's stream)."""
    img = np.asarray(argb, np.int64)
    h, w = img.shape[:2]
    bits = LsbBits()
    if header:
        bits.put(0x2F, 8)
        bits.put(w - 1, 14)
        bits.put(h - 1, 14)
        bits.put(int(alpha_hint), 1)
        bits.put(0, 3)
    cur, width = img.copy(), w
    for t in transforms:
        bits.put(1, 1)
        if t[0] == "green":
            bits.put(2, 2)
            cur[..., 1] = (cur[..., 1] - cur[..., 2]) & 255
            cur[..., 3] = (cur[..., 3] - cur[..., 2]) & 255
        elif t[0] == "colour":
            _, tb, mult = t
            bits.put(1, 2)
            bits.put(tb - 2, 3)
            bw = -(-width // (1 << tb))
            mult = np.asarray(mult, np.int64).reshape(-1, 3)
            _put_vp8l_image(bits, [_argb((255, m[2], m[1], m[0])) for m in mult], bw)
            s8 = lambda v: ((int(v) + 128) & 255) - 128  # noqa: E731
            for y in range(h):
                for x in range(width):
                    g2r, g2b, r2b = mult[(y >> tb) * bw + (x >> tb)]
                    _, r, g, b = (int(v) for v in cur[y, x])
                    cur[y, x, 1] = (r - ((s8(g2r) * s8(g)) >> 5)) & 255
                    cur[y, x, 3] = (b - ((s8(g2b) * s8(g)) >> 5) - ((s8(r2b) * s8(r)) >> 5)) & 255
        elif t[0] == "predict":
            _, tb, modes = t
            bits.put(0, 2)
            bits.put(tb - 2, 3)
            bw = -(-width // (1 << tb))
            _put_vp8l_image(bits, [_argb((255, 0, m, 0)) for m in modes], bw)
            orig = [tuple(int(v) for v in p) for p in cur.reshape(-1, 4)]
            res = cur.reshape(-1, 4)
            for i, p in enumerate(orig):
                y, x = divmod(i, width)
                mode = 0 if i == 0 else 1 if y == 0 else 2 if x == 0 else \
                    modes[(y >> tb) * bw + (x >> tb)]
                tr = orig[i - width + 1] if y else None
                pred = _vp8l_predict(mode, orig[i - 1] if i else None,
                                     orig[i - width] if y else None, tr,
                                     orig[i - width - 1] if y and x else None)
                res[i] = [(v - q) & 255 for v, q in zip(p, pred)]
            cur = res.reshape(cur.shape)
        elif t[0] == "palette":
            flat = [tuple(int(v) for v in p) for p in cur.reshape(-1, 4)]
            palette = list(dict.fromkeys(flat))
            n = len(palette)
            bits.put(3, 2)
            bits.put(n - 1, 8)
            deltas = [palette[0]] + [tuple((c - p) & 255 for c, p in zip(palette[k],
                                                                        palette[k - 1]))
                                     for k in range(1, n)]
            _put_vp8l_image(bits, [_argb(d) for d in deltas], n)
            wb = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            index = {c: k for k, c in enumerate(palette)}
            idx = np.array([index[p] for p in flat]).reshape(h, width)
            per, depth = 1 << wb, 8 >> wb
            packed_w = -(-width // per)
            packed = np.zeros((h, packed_w, 4), np.int64)
            packed[..., 0] = 255
            for x in range(width):
                packed[:, x >> wb, 2] |= idx[:, x] << ((x & (per - 1)) * depth)
            cur, width = packed, packed_w
    bits.put(0, 1)
    _put_vp8l_image(bits, [_argb(p) for p in cur.reshape(-1, 4)], width, cache_bits, lz77,
                    groups, group_bits, simple, level0=True)
    return bits.data()


# ---------------------------------------------------- CCITT and YCbCr TIFF
_FAX_NAMES = {2: "tiff_ccitt", 3: "group3", 4: "group4"}


def fax_strip(bits: np.ndarray, compression: int, options: int = 0) -> bytes:
    """The CCITT data of one strip of (h, w) 0/1 ``bits`` (1: a black run),
    as libtiff's encoder writes it (through PIL): compression 2, 3 (with
    T4Options ``options``: 1 2-D rows, 4 fill bits before each EOL) or 4."""
    buf = io.BytesIO()
    info = {278: bits.shape[0], **({292: options} if compression == 3 else {})}
    Image.fromarray(np.asarray(bits, bool)).save(buf, "TIFF", compression=_FAX_NAMES[compression],
                                                tiffinfo=info)
    data = buf.getvalue()
    tags = Image.open(io.BytesIO(data)).tag_v2
    return data[tags[273][0]:tags[273][0] + tags[279][0]]


def fax_tiff(bits: np.ndarray, compression: int, options: int = 0, photometric: int = 0,
             fill_order: int = 1, rows_per_strip: int = None, tile=None, colormap=None,
             chunks=None, order: str = "<") -> bytes:
    """A 1-bit CCITT TIFF of (h, w) 0/1 ``bits``: strips of
    ``rows_per_strip`` rows or (width, length) ``tile``s, each encoded on
    its own by ``fax_strip`` (or given as ``chunks``), FillOrder 2 reversing
    the bits of each byte after."""
    h, w = bits.shape
    if chunks is None:
        if tile:
            tw, tl = tile
            padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw), np.uint8)
            padded[:h, :w] = bits
            chunks = [fax_strip(padded[y:y + tl, x:x + tw], compression, options)
                      for y in range(0, h, tl) for x in range(0, w, tw)]
        else:
            rows = rows_per_strip or h
            chunks = [fax_strip(bits[y:y + rows], compression, options) for y in range(0, h, rows)]
    if fill_order == 2:
        chunks = [c.translate(bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))) for c in chunks]
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]), 259: (3, [compression]),
              262: (3, [photometric]), 277: (3, [1])}
    fields.update({322: (3, [tile[0]]), 323: (3, [tile[1]])} if tile
                  else {278: (4, [rows_per_strip or h])})
    if compression == 3 and options:
        fields[292] = (4, [options])
    if fill_order != 1:
        fields[266] = (3, [fill_order])
    if colormap is not None:
        fields[320] = (3, np.asarray(colormap).T.reshape(-1).tolist())
    return tiff_file(chunks, fields, bool(tile), order)


def ycbcr_units(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """(h, w, 3) Y, Cb, Cr samples -> TIFF's YCbCr data units: ``hs x vs``
    luma samples then the block's Cb and Cr (its top-left pixel's), the
    edges padded by repeating the last row and column."""
    h, w, _ = ycc.shape
    bh, bw = -(-h // vs), -(-w // hs)
    pad = np.pad(np.asarray(ycc), ((0, bh * vs - h), (0, bw * hs - w), (0, 0)), mode="edge")
    blocks = pad.reshape(bh, vs, bw, hs, 3).transpose(0, 2, 1, 3, 4).reshape(bh, bw, vs * hs, 3)
    units = np.concatenate([blocks[..., 0], blocks[:, :, :1, 1], blocks[:, :, :1, 2]], -1)
    return units.astype(np.uint8).tobytes()


def ycbcr_tiff(ycc: np.ndarray, sampling=(2, 2), compression: int = 1,
               rows_per_strip: int = None, tile=None, planar: int = 1, fields: dict = None,
               subsampling_tag: bool = True, order: str = "<") -> bytes:
    """An 8-bit YCbCr TIFF (photometric 6, not JPEG) of (h, w, 3) Y, Cb, Cr
    samples: units of ``sampling`` (YCbCrSubsampling, tag 530, written
    unless ``subsampling_tag`` is False) in strips of ``rows_per_strip``
    rows or in (width, length) ``tile``s, or separate planes (``planar``
    2, 1x1 only); ``fields``: more tags (tag -> (type, values))."""
    h, w, _ = ycc.shape
    hs, vs = sampling
    rows = rows_per_strip or h
    if planar == 2:
        chunks = [_tiff_compress(np.asarray(ycc)[y:y + rows, :, c].astype(np.uint8).tobytes(),
                                 compression) for c in range(3) for y in range(0, h, rows)]
    elif tile:
        tw, tl = tile
        chunks = []
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                block = np.zeros((tl, tw, 3), np.int64)
                part = ycc[y:y + tl, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
                chunks.append(_tiff_compress(ycbcr_units(block, hs, vs), compression))
    else:
        chunks = [_tiff_compress(ycbcr_units(ycc[y:y + rows], hs, vs), compression)
                  for y in range(0, h, rows)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]),
            262: (3, [6]), 277: (3, [3]), 284: (3, [planar])}
    tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]])} if tile else {278: (4, [rows])})
    if subsampling_tag:
        tags[530] = (3, [hs, vs])
    tags.update(fields or {})
    return tiff_file(chunks, tags, bool(tile), order)


def fax_ycbcr_cases(rng) -> dict:
    """Small CCITT and YCbCr TIFFs for the card's phase jpeg."""
    out = {}
    bits = (smooth(rng, 7, 13, 1) > 128).astype(np.uint8)
    for comp, options, name in ((2, 0, "mh"), (3, 0, "g3_1d"), (3, 5, "g3_2d_fill"),
                                (4, 0, "g4")):
        out[f"fax_{name}_7x13"] = fax_tiff(bits, comp, options)
    page = (smooth(rng, 33, 50, 1) > 128).astype(np.uint8)
    out["fax_g4_black_is_zero_fill_order2_strips_33x50"] = fax_tiff(
        page, 4, photometric=1, fill_order=2, rows_per_strip=10)
    out["fax_g3_2d_tiles_33x50"] = fax_tiff(page, 3, 1, tile=(32, 16))
    strip = fax_strip(page, 4)
    out["fax_g4_cut_33x50"] = fax_tiff(page, 4, chunks=[strip[:len(strip) // 2]])
    strip = bytearray(fax_strip(page, 3, 1))
    strip[len(strip) // 3] ^= 0x24
    out["fax_g3_2d_damaged_33x50"] = fax_tiff(page, 3, 1, chunks=[bytes(strip)])
    ycc = smooth(rng, 7, 13)
    for sampling, comp in (((1, 1), 32773), ((2, 1), 5), ((2, 2), 1), ((4, 1), 8),
                           ((4, 2), 5), ((4, 4), 8), ((1, 2), 32773)):
        out[f"ycbcr_{sampling[0]}{sampling[1]}_{comp}_7x13"] = ycbcr_tiff(ycc, sampling, comp)
    out["ycbcr_44_tiles_clipped_19x21"] = ycbcr_tiff(smooth(rng, 19, 21), (4, 4), 5,
                                                     tile=(16, 16))
    out["ycbcr_rec709_studio_range_7x13"] = ycbcr_tiff(
        ycc, (2, 2), 5, fields={529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
                                532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    return out


def fax_pages() -> dict:
    """A 640x640 CCITT Group 4 page: a ``chip_smoke.TextPages`` page's text
    (grey 128 and above) as white on black (BlackIsZero)."""
    import chip_smoke as cs

    img = cs.TextPages(1, 61, (640, 640), noise=4)[0]["image"]
    return {"page_g4.tif": fax_tiff((img.mean(-1) >= 128).astype(np.uint8), 4, photometric=1)}


# ------------------------------------------------ Radiance, PFM, Sun raster
def _rgbe_channel(values: np.ndarray) -> bytes:
    """One channel of a Radiance scanline in new-style run-length form: a
    run of 3 to 127 equal bytes as 128 + count and the byte, else up to 128
    bytes as count and the bytes."""
    out, i, n = bytearray(), 0, len(values)
    while i < n:
        j = i
        while j < n and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, int(values[i])])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 2 < n and values[j] == values[j + 1]
                                             == values[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(values[i:j].astype(np.uint8))
        i = j
    return bytes(out)


def hdr_bytes(rgbe: np.ndarray, rle: bool = True, header: bytes = None,
              resolution: bytes = None, flat_from: int = None) -> bytes:
    """A Radiance file of (h, w, 4) R, G, B, E bytes: ``header`` (by default
    cv2's: ``#?RADIANCE``, the FORMAT line, a blank line), the resolution
    line, then each scanline run-length coded (``rle``, for widths 8 to
    32767) or flat (from row ``flat_from`` on, all of them flat)."""
    h, w, _ = rgbe.shape
    out = bytearray(header if header is not None
                    else b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += resolution if resolution is not None else f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if rle and 8 <= w <= 0x7FFF and (flat_from is None or y < flat_from):
            out += bytes([2, 2, w >> 8, w & 255])
            out += b"".join(_rgbe_channel(rgbe[y, :, c]) for c in range(4))
        else:
            out += np.asarray(rgbe[y], np.uint8).tobytes()
    return bytes(out)


def pfm_bytes(values: np.ndarray, scale: float = -1.0, header: bytes = None) -> bytes:
    """A PFM of (h, w, 3) (``PF``) or (h, w) (``Pf``) float32 ``values``:
    rows bottom to top, little-endian where ``scale`` is negative."""
    x = np.asarray(values, np.float32)
    h, w = x.shape[:2]
    head = header if header is not None else (
        f"P{'F' if x.ndim == 3 else 'f'}\n{w} {h}\n{scale!r}\n".encode())
    return head + x[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


def sunras_bytes(rows: np.ndarray, width: int, bpp: int, kind: int = 1, colormap=None,
                 maptype: int = None) -> bytes:
    """A Sun raster of ``rows`` (h, bytes a row) of ``width`` pixels at
    ``bpp`` bits, each row padded to 16 bits; ``colormap``: (n, 3) RGB,
    stored as all reds, then greens, then blues."""
    rows = np.asarray(rows, np.uint8)
    h = len(rows)
    pitch = ((width * bpp + 7) // 8 + 1) & ~1
    body = np.zeros((h, pitch), np.uint8)
    body[:, :rows.shape[1]] = rows
    cmap = b"" if colormap is None else np.asarray(colormap, np.uint8).T.tobytes()
    maptype = (1 if len(cmap) else 0) if maptype is None else maptype
    return (struct.pack(">8I", 0x59A66A95, width, h, bpp, body.size, kind, maptype, len(cmap))
            + cmap + body.tobytes())


def hdr_pfm_ras_cases(rng) -> dict:
    """Small Radiance, PFM and Sun raster files for the card's phase jpeg."""
    out = {}
    rgbe = rng.integers(0, 256, (7, 13, 4))
    rgbe[..., 3] = rng.integers(125, 140, (7, 13))
    rgbe[2:5, 3:11] = rgbe[2:5, 3:4]  # runs
    out["hdr_rle_7x13"] = hdr_bytes(rgbe)
    out["hdr_flat_exposure_7x5"] = hdr_bytes(rgbe[:, :5], header=b"#?RGBE\nEXPOSURE=2.0\n"
                                             b"FORMAT=32-bit_rle_rgbe\n\n")
    out["hdr_cv2_9x10"] = cv_encode(".hdr", (smooth(rng, 9, 10) / 200).astype(np.float32))
    x = (rng.random((5, 7, 3)) * 300 - 20).astype(np.float32)
    out["pfm_le_5x7"] = pfm_bytes(x)
    out["pfm_be_scale2_5x7"] = pfm_bytes(x, 2.0)
    out["pfm_grey_5x7"] = pfm_bytes(x[..., 0], -0.5)
    out["ras_cv2_7x13"] = cv_encode(".ras", smooth(rng, 7, 13))
    out["ras_1bit_map_7x13"] = sunras_bytes(rng.integers(0, 256, (7, 2)), 13, 1, 0,
                                            colormap=rng.integers(0, 256, (2, 3)))
    out["ras_8bit_short_map_7x13"] = sunras_bytes(rng.integers(0, 12, (7, 13)), 13, 8,
                                                  colormap=rng.integers(0, 256, (10, 3)))
    out["ras_32bit_7x13"] = sunras_bytes(rng.integers(0, 256, (7, 52)), 13, 32)
    out["ras_rle_refused_7x13"] = sunras_bytes(rng.integers(0, 256, (7, 13)), 13, 8, 2)
    return out


def cv2_decode(data: bytes, path: str = None):
    """cv2's RGB decode of a file (``path``) or of bytes, or None."""
    bgr = (cv2.imread(path, cv2.IMREAD_COLOR) if path
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else np.ascontiguousarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))


def digest(img) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


# ------------------------------------------------------------- JPEG 2000
def jp2_box(kind: bytes, body: bytes, xl: bool = False, length: int = None) -> bytes:
    """A JP2 box: LBox, TBox, body; ``xl`` writes LBox 1 and a 64-bit
    XLBox, ``length`` overrides LBox (0: the box runs to the file's end)."""
    if xl:
        return struct.pack(">I4sQ", 1, kind, 16 + len(body)) + body
    return struct.pack(">I4s", 8 + len(body) if length is None else length, kind) + body


def jp2_file(codestream: bytes, colour=17, pclr=None, cmap=None, cdef=None, xl: bool = False,
             to_end: bool = False, before=(), inside=()) -> bytes:
    """A JP2 file around a raw codestream, with the header boxes no encoder
    here writes: ``colour`` an enumerated colour space (16 sRGB, 17 grey,
    18 sYCC, ...) or an ICC profile's bytes; ``pclr`` (entries (n, columns)
    ints, bit depths a column, negative for signed); ``cmap`` [(component,
    mapping type, palette column)]; ``cdef`` [(channel, type, association)];
    ``xl``: the codestream box with a 64-bit length, ``to_end``: with LBox 0;
    ``before``/``inside``: extra boxes before jp2h and inside it."""
    (h, w), comps = _j2k_siz(codestream)
    bpc = comps[0] if all(c == comps[0] for c in comps) else 255
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, len(comps), bpc, 7, 0, 0))
    colr = jp2_box(b"colr", b"\x02\x00\x00" + colour if isinstance(colour, bytes)
                   else struct.pack(">BBBI", 1, 0, 0, colour))
    boxes = [ihdr, colr, *inside]
    if pclr is not None:
        entries, bits = pclr
        entries = np.asarray(entries, np.int64)
        body = struct.pack(">HB", *entries.shape) + bytes(
            (abs(b) - 1) | (0x80 if b < 0 else 0) for b in bits)
        for row in entries:
            body += b"".join(int(v).to_bytes((abs(b) + 7) // 8, "big", signed=b < 0)
                             for v, b in zip(row, bits))
        boxes.append(jp2_box(b"pclr", body))
    if cmap is not None:
        boxes.append(jp2_box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap)))
    if cdef is not None:
        boxes.append(jp2_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *d) for d in cdef)))
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + b"".join(before) + jp2_box(b"jp2h", b"".join(boxes))
            + jp2_box(b"jp2c", codestream, xl=xl, length=0 if to_end else None))


def _j2k_siz(codestream: bytes):
    """((height, width), [Ssiz of each component]) of a codestream's SIZ."""
    x1, y1, x0, y0 = struct.unpack_from(">IIII", codestream, 8)
    nc = struct.unpack_from(">H", codestream, 40)[0]
    return (y1 - y0, x1 - x0), [codestream[42 + 3 * c] for c in range(nc)]


def pil_jpeg2000(img: np.ndarray, **kw) -> bytes:
    """PIL's JPEG 2000 writer (its bundled OpenJPEG) on a uint8 (h, w) L,
    (h, w, 2) LA, RGB or RGBA image, or a uint16 (h, w) I;16 one: a JP2
    file, or a raw codestream with ``no_jp2=True``."""
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def openjpeg(planes, **kw) -> bytes:
    """libopenjp2's own encoder through ``ctypes`` (``scripts/openjpeg_ctypes.py``):
    the code-block styles, SOP/EPH, POC, ROI, subsampling, precisions and
    tile-parts PIL does not expose."""
    import openjpeg_ctypes

    return openjpeg_ctypes.encode([np.asarray(p, np.int64) for p in planes], **kw)


def jpeg2000_cases(rng) -> dict:
    """A few small JPEG 2000 files for the card's phase jpeg (the tests make
    many more from seeds): PIL's 5/3 RGB JP2 (the reversible component
    transform), a raw 9/7 codestream, a grey JP2 of three quality layers
    over 8x8 precincts in RPCL order, a JP2 palette (``pclr``/``cmap``)
    with channel definitions, and a JP2 cut at 60% of its bytes (refused)."""
    out = {}
    img = smooth(rng, 7, 13)
    out["jp2_53_rgb_7x13"] = pil_jpeg2000(img, num_resolutions=2)
    out["j2k_97_rgb_7x13"] = pil_jpeg2000(smooth(rng, 7, 13), num_resolutions=2, irreversible=True,
                                          no_jp2=True)
    out["jp2_layers_precincts_rpcl_33x50"] = pil_jpeg2000(
        smooth(rng, 33, 50, 1), num_resolutions=3, irreversible=True, quality_mode="rates",
        quality_layers=[24, 12, 6], progression="RPCL", precinct_size=(16, 16),
        codeblock_size=(8, 8))
    idx = rng.integers(0, 5, (7, 13))
    palette = rng.integers(0, 256, (5, 3))
    out["jp2_pclr_cdef_7x13"] = jp2_file(
        openjpeg([idx], numresolution=2), 16, pclr=(palette, [8, 8, 8]),
        cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)], cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)])
    data = out["jp2_53_rgb_7x13"]
    out["jp2_cut_7x13"] = data[:int(len(data) * 0.6)]
    return out


def jpeg2000_page() -> dict:
    """A 640x640 grey JPEG 2000 page: ``chip_smoke.TextPages``' page of
    ``page_palette.png``, its first channel, as PIL writes it in one 9/7
    layer at a rate of 160:1."""
    import chip_smoke as cs

    img = cs.TextPages(1, 32, (640, 640), noise=4)[0]["image"][..., 0]
    return {"page_97.jp2": pil_jpeg2000(img, irreversible=True, quality_mode="rates",
                                        quality_layers=[160])}


def tiff_variant_cases(rng) -> dict:
    """Three small TIFFs for the card's phase jpeg (the tests make many
    more from seeds): CIE L*a*b* with Predictor 2 under LZW, signed 16-bit
    RGB (SampleFormat 2, big-endian), and old-style LZW (``old_lzw``)."""
    return {
        "tifflab_lzw_predictor_7x13": tiff_bytes(smooth(rng, 7, 13), 8, 8, 5, predictor=2),
        "tiffsigned_rgb16_be_5x7": tiff_bytes(smooth(rng, 5, 7, 3, 65536), 16, 2, 8, ">",
                                              more={339: (3, [2] * 3)}),
        "tifflzwold_rgb_7x13": tiff_bytes(smooth(rng, 7, 13), 8, 2, 5, old_lzw=True),
    }


EXTENSIONS = {b"\x89P": ".png", b"\xff\xd8": ".jpg", b"BM": ".bmp", b"P1": ".pbm",
              b"P4": ".pbm", b"P2": ".pgm", b"P5": ".pgm", b"P3": ".ppm", b"P6": ".ppm",
              b"GI": ".gif", b"II": ".tif", b"MM": ".tif", b"RI": ".webp", b"#?": ".hdr",
              b"PF": ".pfm", b"Pf": ".pfm", b"\x59\xa6": ".ras", b"\0\0": ".jp2", b"\xffO": ".j2k"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "assets", "images"))
    args = ap.parse_args(argv)
    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    rng = np.random.default_rng(23)
    files = {}
    todo = {f"cases/{name}{EXTENSIONS[data[:2]]}": data
            for make in (png_cases, jpeg_cases, bmp_cases, pnm_cases)
            for name, data in make(rng).items()}
    todo.update({f"pages/{name}": data for name, data in pages().items()})
    rng = np.random.default_rng(24)  # the files above stay as they were
    todo.update({f"cases/{name}{EXTENSIONS[data[:2]]}": data
                 for make in (jpeg_cut_cases, gif_cases, tiff_cases)
                 for name, data in make(rng).items()})
    todo.update({f"pages/{name}": data for name, data in cut_pages().items()})
    rng = np.random.default_rng(25)  # the files above stay as they were
    todo.update({f"cases/{name}{EXTENSIONS.get(data[:2], '.webp')}": data
                 for make in (webp_cases, tiff_jpeg_cases) for name, data in make(rng).items()})
    todo.update({f"pages/{name}": data for name, data in webp_jpeg_tiff_pages().items()})
    rng = np.random.default_rng(26)  # the files above stay as they were
    todo.update({f"cases/{name}{EXTENSIONS[data[:2]]}": data
                 for make in (fax_ycbcr_cases, hdr_pfm_ras_cases) for name, data in make(rng).items()})
    todo.update({f"pages/{name}": data for name, data in fax_pages().items()})
    rng = np.random.default_rng(27)  # the files above stay as they were
    todo.update({f"cases/{name}{EXTENSIONS[data[:2]]}": data
                 for name, data in jpeg2000_cases(rng).items()})
    todo.update({f"pages/{name}": data for name, data in jpeg2000_page().items()})
    rng = np.random.default_rng(28)  # the files above stay as they were
    todo.update({f"cases/{name}.tif": data for name, data in tiff_variant_cases(rng).items()})
    for rel, data in todo.items():
        path = os.path.join(args.out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        from_file = cv2_decode(data, path)
        entry = {**(digest(from_file) if from_file is not None
                    else {"sha256": None, "shape": None}), "bytes": len(data)}
        from_bytes = cv2_decode(data)
        if from_bytes is None or from_file is None or not np.array_equal(from_bytes, from_file):
            entry["imdecode"] = None if from_bytes is None else digest(from_bytes)
        files[rel] = entry
    build = [line.strip() for line in cv2.getBuildInformation().splitlines()
             if line.strip().startswith(("JPEG:", "PNG:", "TIFF:", "WEBP:", "JPEG 2000:"))]
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"made_by": "scripts/make_port_image_assets.py",
                   "decoder": f"cv2 {cv2.__version__} ({'; '.join(build)})",
                   "digest": "sha256 of cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), "
                             "cv2.COLOR_BGR2RGB) as C-order uint8 bytes (null where imread "
                             "returns None); 'imdecode': that of cv2.imdecode(buf, "
                             "cv2.IMREAD_COLOR) where it differs (null: None)",
                   "files": files}, f, indent=1, sort_keys=True)
    total = sum(v["bytes"] for v in files.values())
    print(f"wrote {len(files)} files, {total} bytes, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

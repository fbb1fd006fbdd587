#!/usr/bin/env python3
"""Write ``assets/images/``: the PNG, JPEG, BMP and PNM files beyond
baseline and progressive YCbCr JPEG and 8-bit PNG that the port's readers
(``megreader_tpu_torch/data/{png,jpeg,bitmap}.py``) are held to.

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
* ``pages/``: four 640x640 pages drawn by ``chip_smoke.TextPages``: a CMYK
  JPEG, a palette PNG, a 16-bit Adam7 PNG and an RLE8 BMP, for
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


def cv2_decode(data: bytes, path: str = None):
    """cv2's RGB decode of a file (``path``) or of bytes, or None."""
    bgr = (cv2.imread(path, cv2.IMREAD_COLOR) if path
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if bgr is None else np.ascontiguousarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))


def digest(img) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


EXTENSIONS = {b"\x89P": ".png", b"\xff\xd8": ".jpg", b"BM": ".bmp", b"P1": ".pbm",
              b"P4": ".pbm", b"P2": ".pgm", b"P5": ".pgm", b"P3": ".ppm", b"P6": ".ppm"}


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
    for rel, data in todo.items():
        path = os.path.join(args.out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        from_file = cv2_decode(data, path)
        if from_file is None:
            raise RuntimeError(f"cv2.imread cannot read {rel}")
        entry = {**digest(from_file), "bytes": len(data)}
        from_bytes = cv2_decode(data)
        if from_bytes is None or not np.array_equal(from_bytes, from_file):
            entry["imdecode"] = None if from_bytes is None else digest(from_bytes)
        files[rel] = entry
    build = [line.strip() for line in cv2.getBuildInformation().splitlines()
             if line.strip().startswith(("JPEG:", "PNG:"))]
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"made_by": "scripts/make_port_image_assets.py",
                   "decoder": f"cv2 {cv2.__version__} ({'; '.join(build)})",
                   "digest": "sha256 of cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), "
                             "cv2.COLOR_BGR2RGB) as C-order uint8 bytes; 'imdecode': that of "
                             "cv2.imdecode(buf, cv2.IMREAD_COLOR) where it differs (null: None)",
                   "files": files}, f, indent=1, sort_keys=True)
    total = sum(v["bytes"] for v in files.values())
    print(f"wrote {len(files)} files, {total} bytes, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""JPEG in numpy, bit-equal to ``cv2.imread`` / ``cv2.imdecode`` with
``IMREAD_COLOR`` followed by ``cv2.cvtColor(BGR2RGB)``.

The reference reads ICDAR pages with ``cv2.imread`` and LMDB crops with
``cv2.imdecode``; the card's machine has neither cv2 nor PIL, so the port
decodes the files itself. cv2 decodes through libjpeg-turbo, whose default
decompression this module reproduces step for step:

* entropy decoding of sequential scans (SOF0 and SOF1): one interleaved
  scan of every component, or several scans that each code some of them
  (libjpeg's buffered mode), 8-bit samples, Huffman tables, restart
  intervals, byte stuffing and fill bytes. Symbols are read through a table
  indexed by the next 16 bits that, where the code and its extra bits fit
  in those bits, also gives the run and the coefficient;
* or the scans of a progressive file (SOF2, ITU T.81 annex G): spectral
  selection and successive approximation, DC first and refinement scans
  (interleaved or not), AC first and refinement scans of one component
  over that component's own blocks (not the MCU grid), runs of empty blocks
  (EOBr), restart intervals, and tables and restart intervals redefined
  between scans;
* libjpeg-turbo's block smoothing (``decompress_smooth_data``, ``_smooth``)
  of a progressive file whose scans leave any of the first ten coefficients
  unknown or unrefined: estimates of them, and where no AC coefficient is
  known of the DC too, from the DC values of the 5x5 blocks around each
  block. A complete file's scans leave nothing to smooth;
* a file cut short, as ``cv2.imread`` reads it: libjpeg's stdio source
  hands over an EOI marker wherever the file has no more bytes (the file is
  read as if followed by endless EOI markers, so a segment cut short reads
  them as its fields), and the Huffman decoder, once it meets that marker,
  decodes the MCU in which the data ran out from zero bits and leaves the
  rest of the scan undecoded: zero coefficients, libjpeg's grey rest, or
  what earlier scans gave (``_run_out``);
* the integer "islow" inverse DCT as libjpeg-turbo's AVX2 code computes it
  (``jidctint-avx2.asm``, ``CONST_BITS`` 13, ``PASS1_BITS`` 2) over all
  blocks at once in int64: ``jpeg_idct_islow``'s products, 16-bit sums and
  dequantization, its passes saturated to int16 and to the sample range
  (where corrupt or zero-padded data makes coefficients extreme);
* the upsampling ``jdsample.c`` picks under ``do_fancy_upsampling``:
  the triangle filters h2v1 and h2v2 (box replication when the component is
  at most 2 samples wide), h1v2, and box replication for any other integral
  factor (h4v1 of 4:1:1). Edges replicate the component's last real sample
  row and column, not the padded block;
* the colour space libjpeg infers (``_colour_space``: JFIF, the Adobe
  segment's transform, the component ids): grey repeated into the three
  channels, the fixed-point YCbCr -> RGB tables of ``jdcolor.c``
  (``SCALEBITS`` 16), RGB as coded, CMYK as coded and YCCK through
  ``ycck_cmyk_convert``, both then through cv2's own CMYK -> BGR formula
  (``cmyk_to_rgb``);
* the EXIF ``Orientation`` tag of an APP1 segment, applied as cv2 applies
  it (all eight values);
* what follows the scans as cv2 reads it: after one scan of every component
  nothing more is read; a file whose data runs to its end without EOI is
  decoded through ``cv2.imread``'s route (above) and, through
  ``cv2.imdecode``'s, only where libjpeg-turbo reaches its last MCU
  (``decode_jpeg``): cv2's memory source has no EOI to hand over, so
  libjpeg suspends and cv2 returns None;
* a strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec hands
  it over (``decode_tiff_strip``): the ``JPEGTables`` stream first, the
  colour space that of the TIFF, no orientation.

Anything else raises ``NotImplementedError`` naming what it met: lossless,
arithmetic-coded and hierarchical files, and a component coded in two
sequential scans. A file that cv2 refuses raises ``ValueError``: samples
of other than 8 bits (12-bit, 16-bit), other than 1, 3 or 4 components
(with an Adobe segment or without), and damage (a bad Huffman code, a
missing table or marker, progressive scans out of order, a file cut inside
its headers or, through ``decode_image``, inside its data).
"""

from __future__ import annotations

import functools
import re
import struct
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np

#: zigzag position -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_NAMES = {
    0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded differential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
#: a run past the end of a block: the entry for EOB skips this far
_EOB = 1000
_MARKER = re.compile(rb"\xff+([^\x00\xff])")


@functools.lru_cache(maxsize=64)
def _huffman(counts: bytes, symbols: bytes, ac: bool) -> list:
    """A Huffman table as a 65536-entry list indexed by the next 16 bits
    (cached: most files carry the same standard tables).

    Entry ``w`` is ``(bits, run, value)`` when the code and its extra bits
    fit in ``w``: consume ``bits``, skip ``run`` coefficients (``_EOB + r``
    for an end of block: of r's band of blocks, in progressive scans), store
    ``value``. Otherwise it is ``(-length, symbol, 0)``
    for a code of ``length`` bits whose extra bits lie beyond ``w``, or
    ``(0, 0, 0)`` where no code starts."""
    n_bits = np.zeros(65536, np.int64)
    run = np.zeros(65536, np.int64)
    value = np.zeros(65536, np.int64)
    window = np.arange(65536, dtype=np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("Huffman code lengths oversubscribed")
            sym = symbols[k]
            k += 1
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            size = sym & 15
            skip = (sym >> 4) if ac else 0
            if ac and size == 0:  # ZRL (sixteen zeros) or EOB: _EOB + r for EOBr
                n_bits[lo:hi] = length
                run[lo:hi] = 15 if sym >> 4 == 15 else _EOB + (sym >> 4)
            elif length + size <= 16:
                bits = (window[lo:hi] >> (16 - length - size)) & ((1 << size) - 1)
                n_bits[lo:hi] = length + size
                run[lo:hi] = skip
                value[lo:hi] = np.where(bits < (1 << size) >> 1,
                                        bits - (1 << size) + 1, bits) if size else 0
            else:
                n_bits[lo:hi] = -length
                run[lo:hi] = sym
            code += 1
        code <<= 1
    return list(zip(n_bits.tolist(), run.tolist(), value.tolist()))


def _extend(bits: int, size: int) -> int:
    return bits - (1 << size) + 1 if bits < 1 << (size - 1) else bits


def _segments(data: bytes, name: str, pos: int = 2, stop: Optional[int] = None):
    """(marker, payload) for each marker segment from ``pos`` (after SOI) up
    to the next SOS included, then ("data", offset of its entropy-coded
    data); or ("eoi", offset) where EOI comes first (``stop``: or a segment
    would start at or past that offset, where ``data`` goes on with the
    EOI markers of libjpeg's stdio source)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG (no SOI)")
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if data[pos:pos + 2] == b"\xff\xd9" or (stop is not None and pos >= stop):
            yield "eoi", pos
            return
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{name}: truncated or damaged JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # parameterless
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"{name}: truncated JPEG segment {marker:#04x}")
        yield marker, body
        pos += 2 + length
        if marker == 0xDA:
            yield "data", pos
            return


def _scan_chunks(data: bytes, start: int) -> Tuple[List[bytes], Optional[int]]:
    """The entropy-coded data from ``start``, split at its restart markers,
    and the offset of the marker that ends it, or None where the data runs
    to the end of the file (a last 0xff there is fill)."""
    chunks = []
    for m in _MARKER.finditer(data, start):
        chunks.append(data[start:m.start()])
        start = m.end()
        if not 0xD0 <= m.group(1)[0] <= 0xD7:
            return chunks, m.end() - 2
    return chunks + [data[start:].rstrip(b"\xff")], None


def _windows(chunk: bytes, pad: int = 8) -> Tuple[list, int]:
    """An unstuffed chunk as its 32-bit windows at each byte, and its bits
    (``pad`` zero bytes follow them)."""
    raw = chunk.replace(b"\xff\x00", b"\xff")
    b = np.frombuffer(raw + b"\0" * pad, np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist(), 8 * len(raw)


def _orientation(app1: bytes) -> Optional[int]:
    """The EXIF Orientation tag (0x0112) of an APP1 segment's IFD0, or None."""
    if not app1.startswith(b"Exif\0\0") or len(app1) < 14:
        return None
    return tiff_orientation(app1[6:])


def tiff_orientation(tiff: bytes) -> Optional[int]:
    """The Orientation tag (0x0112) of IFD0 of an EXIF block that starts with
    its TIFF header ("II" or "MM"), or None."""
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return None
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (n,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            tag, kind, count = struct.unpack(order + "HHI", tiff[ifd + 2 + 12 * i:ifd + 10 + 12 * i])
            if tag == 0x0112 and kind == 3 and count == 1:
                return struct.unpack(order + "H", tiff[ifd + 10 + 12 * i:ifd + 12 + 12 * i])[0]
    except struct.error:
        return None
    return None


def apply_orientation(img: np.ndarray, orientation: Optional[int]) -> np.ndarray:
    """cv2's EXIF orientation transforms (``ExifTransform``)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------- the IDCT
_F = dict(f0_298=2446, f0_390=3196, f0_541=4433, f0_765=6270, f0_899=7373, f1_175=9633,
          f1_501=12299, f1_847=15137, f1_961=16069, f2_053=16819, f2_562=20995, f3_072=25172)


def _wrap16(x: np.ndarray) -> np.ndarray:
    """int16 arithmetic's wrap-around of int64 values."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x: List[np.ndarray]) -> List[np.ndarray]:
    """libjpeg-turbo's AVX2 islow butterfly (``jidctint-avx2.asm``) on 8
    int64 arrays of int16 values: the 8 outputs before their descale
    (scaled by 2^13). The products are ``jpeg_idct_islow``'s, merged into
    one constant a pair of inputs; the sums in0 +- in4, in7 + in3 and
    in5 + in1 wrap at 16 bits."""
    f = _F
    in0, in1, in2, in3, in4, in5, in6, in7 = x
    tmp3 = in2 * (f["f0_541"] + f["f0_765"]) + in6 * f["f0_541"]
    tmp2 = in2 * f["f0_541"] + in6 * (f["f0_541"] - f["f1_847"])
    tmp0 = _wrap16(in0 + in4) << 13
    tmp1 = _wrap16(in0 - in4) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(in7 + in3), _wrap16(in5 + in1)
    z3, z4 = (z3 * (f["f1_175"] - f["f1_961"]) + z4 * f["f1_175"],
              z3 * f["f1_175"] + z4 * (f["f1_175"] - f["f0_390"]))
    o0 = in7 * (f["f0_298"] - f["f0_899"]) - in1 * f["f0_899"] + z3
    o1 = in5 * (f["f2_053"] - f["f2_562"]) - in3 * f["f2_562"] + z4
    o2 = in3 * (f["f3_072"] - f["f2_562"]) - in5 * f["f2_562"] + z3
    o3 = in1 * (f["f1_501"] - f["f0_899"]) - in7 * f["f0_899"] + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 8, 8) quantized coefficients in natural order and an (8, 8)
    table -> (N, 8, 8) uint8 samples, as cv2's libjpeg-turbo computes them
    with ``jsimd_idct_islow_avx2``: the product of coefficient and quantizer
    in 16 bits, pass 1 down each column (a block whose rows 1-7 are all zero
    takes each column's DC x 4 in 16 bits instead), its outputs saturated
    to int16, pass 2 along each row, saturated to int8 and offset by 128.
    On coefficients of real images this is ``jpeg_idct_islow`` exactly; it
    differs where corrupt or zero-padded data makes them extreme."""
    x = _wrap16(coef.astype(np.int64) * quant.astype(np.int64))
    cols = _idct_1d([x[:, k, :] for k in range(8)])  # pass 1: down each column
    ws = [np.clip((c + (1 << 10)) >> 11, -32768, 32767) for c in cols]  # DESCALE_P1, packssdw
    flat = ~x[:, 1:, :].any((1, 2))  # the AC-terms-all-zero route
    if flat.any():
        dc = _wrap16(x[:, 0, :] << 2)
        ws = [np.where(flat[:, None], dc, w) for w in ws]
    rows = _idct_1d([np.stack([ws[r][:, k] for r in range(8)], 1) for k in range(8)])
    out = np.stack([np.clip((r + (1 << 17)) >> 18, -128, 127) for r in rows], 2)  # (N, row, col)
    return (out + 128).astype(np.uint8)


# ---------------------------------------------------------- the upsampling
def _fancy_h(p: np.ndarray, bias_lo: int, bias_hi: int, shift: int, edge: int) -> np.ndarray:
    """Triangle filter along the last axis, doubling it: output 2i takes
    3 p[i] + p[i - 1], output 2i + 1 takes 3 p[i] + p[i + 1]; the two end
    outputs take 4 p (``edge`` times)."""
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],), np.int64)
    out[..., 2::2] = (3 * p[..., 1:] + p[..., :-1] + bias_lo) >> shift
    out[..., 1:-1:2] = (3 * p[..., :-1] + p[..., 1:] + bias_hi) >> shift
    out[..., 0] = (edge * p[..., 0] + bias_lo) >> shift
    out[..., -1] = (edge * p[..., -1] + bias_hi) >> shift
    return out


def _colsums(p: np.ndarray) -> np.ndarray:
    """h1v2 / h2v2 context: 3 p[j] + p[j -+ 1] for the upper and lower
    output row of input row j, edges replicating the first and last row,
    interleaved into 2 x the rows."""
    above = np.concatenate([p[:1], p[:-1]])
    below = np.concatenate([p[1:], p[-1:]])
    out = np.empty((2 * p.shape[0],) + p.shape[1:], np.int64)
    out[0::2] = 3 * p + above
    out[1::2] = 3 * p + below
    return out


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's (downsampled_height, downsampled_width) samples ->
    (fv x, fh x) as libjpeg-turbo's fancy upsampling gives them."""
    p = plane.astype(np.int64)
    w = p.shape[1]
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) == (2, 1) and w > 2:  # h2v1_fancy_upsample
        return _fancy_h(p, 1, 2, 2, 4)
    if (fh, fv) == (1, 2):  # h1v2_fancy_upsample
        cs = _colsums(p)
        cs[0::2] += 1
        cs[1::2] += 2
        return cs >> 2
    if (fh, fv) == (2, 2) and w > 2:  # h2v2_fancy_upsample
        cs = _colsums(p)
        out = np.empty((cs.shape[0], 2 * w), np.int64)
        out[:, 2::2] = (3 * cs[:, 1:] + cs[:, :-1] + 8) >> 4
        out[:, 1:-1:2] = (3 * cs[:, :-1] + cs[:, 1:] + 7) >> 4
        out[:, 0] = (4 * cs[:, 0] + 8) >> 4
        out[:, -1] = (4 * cs[:, -1] + 7) >> 4
        return out
    return np.repeat(np.repeat(p, fv, 0), fh, 1)  # h2v1/h2v2 box, int_upsample


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s fixed-point YCbCr -> RGB (SCALEBITS 16)."""
    half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb - 46802 * cr + half) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ----------------------------------------------------------- the decoder
def _decode_interval(win: list, n_bits: int, blocks: list, coef, name: str, per: int = 1,
                     cut: bool = False) -> bool:
    """Decode one restart interval: ``blocks`` lists (coefficient offset,
    DC table, AC table, component) in scan order, ``per`` blocks an MCU;
    writes zigzag-ordered coefficients into ``coef`` (an ``array('h')``), DC
    already summed. ``cut``: the data may end early (see ``_run_out``): the
    MCU that reads past the last bit is decoded from zero bits and the
    interval stops after it. Returns whether the data ran out."""
    pred: Dict[int, int] = {}
    pos = 0
    for j, (base, dct, act, c) in enumerate(blocks):
        if pos > n_bits and j % per == 0:
            break
        n, size, diff = dct[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if n <= 0:  # the code's extra bits lie past the 16-bit window
            if n == 0:
                raise ValueError(f"{name}: bad Huffman code in a DC coefficient")
            pos -= n
            bits = (win[pos >> 3] >> (32 - (pos & 7) - size)) & ((1 << size) - 1)
            n, diff = size, _extend(bits, size)
        pos += n
        v = pred.get(c, 0) + diff
        pred[c] = v
        coef[base] = ((v + 32768) & 0xFFFF) - 32768  # JCOEF
        k = 1
        while k < 64:
            n, r, v = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if n <= 0:
                if n == 0:
                    raise ValueError(f"{name}: bad Huffman code in an AC coefficient")
                pos -= n
                size = r & 15
                bits = (win[pos >> 3] >> (32 - (pos & 7) - size)) & ((1 << size) - 1)
                n, r, v = size, r >> 4, _extend(bits, size)
            pos += n
            k += r
            if k >= 64:  # libjpeg writes a run past the block's end at 63
                if v and k < _EOB:
                    coef[base + 63] = v
                break
            coef[base + k] = v
            k += 1
    if pos > n_bits and not cut:
        raise ValueError(f"{name}: truncated JPEG (the scan ends inside its data)")
    return pos > n_bits


def _symbol_trace(win: list, blocks: list) -> list:
    """The Huffman symbols of a sequential interval that ``_decode_interval``
    decoded: -1 before each block, then (code length, extra bits) of each
    symbol."""
    out, pos = [], 0
    for _, dct, act, _ in blocks:
        n, diff = _dc_symbol(win, pos, dct, "")
        s = abs(diff).bit_length()
        out += [-1, (n - s, s)]
        pos += n
        k = 1
        while k < 64:
            n, r, v = _ac_symbol(win, pos, act, "")
            s = abs(v).bit_length()
            out.append((n - s, s))
            pos += n
            if r >= _EOB:
                break
            k += r + 1
    return out


def _memory_source_reaches_end(chunk: bytes, trace: list, per_mcu: int, fast: bool) -> bool:
    """Whether libjpeg-turbo 3's Huffman decoder (``jdhuff.c``, a 64-bit bit
    buffer) decodes every MCU of a scan's last interval, whose raw bytes
    ``chunk`` run to the end of cv2's memory source, without asking that
    source for more bytes (it has none: libjpeg suspends, and cv2.imdecode
    returns None). ``trace``: ``_symbol_trace``. Where the interval is the
    whole scan (``fast``: no restart interval), an MCU that starts with
    512 bytes a block or more still unread takes ``decode_mcu_fast``, which
    reads six bytes whenever 16 bits or fewer are left; the others take
    ``decode_mcu_slow``: before a symbol with fewer than 8 bits left, a code
    longer than 8 bits with fewer than 9 (then one bit at a time), extra
    bits with fewer than they need, ``jpeg_fill_bit_buffer`` reads bytes up
    to 57 bits, and suspends if the bytes run out first."""
    pos, bits, n = 0, 0, len(chunk)

    def fill() -> bool:
        nonlocal pos, bits
        while bits < 57:
            if pos >= n or (chunk[pos] == 0xFF and pos + 1 >= n):
                return False
            pos += 2 if chunk[pos] == 0xFF else 1  # 0xff 0x00 is one byte of data
            bits += 8
        return True

    def fill_fast() -> None:
        nonlocal pos, bits
        for _ in range(6):
            pos += 2 if chunk[pos] == 0xFF else 1
            bits += 8

    block, use_fast = 0, False
    for item in trace:
        if item == -1:
            if block % per_mcu == 0:
                use_fast = fast and n - pos >= 512 * per_mcu
            block += 1
            continue
        length, extra = item
        if use_fast:
            if bits <= 16:
                fill_fast()
            bits -= length
            if extra and bits <= 16:
                fill_fast()
            bits -= extra
            continue
        if bits < 8 and not fill():
            return False
        if length > 8:
            if bits < 9 and not fill():
                return False
            bits -= 9
            for _ in range(length - 9):
                if bits < 1 and not fill():
                    return False
                bits -= 1
        else:
            bits -= length
        if extra:
            if bits < extra and not fill():
                return False
            bits -= extra
    return True


def _table_segment(marker: int, body: bytes, quant: Dict, tables: Dict, name: str) -> None:
    """Read a DQT (0xDB) or DHT (0xC4) segment into ``quant`` / ``tables``."""
    i = 0
    if marker == 0xDB:
        while i < len(body):
            pq, tq = body[i] >> 4, body[i] & 15
            size = 128 if pq else 64
            raw = body[i + 1:i + 1 + size]
            if len(raw) != size or pq > 1:
                raise ValueError(f"{name}: bad quantization table")
            zz = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
            q = np.zeros(64, np.int64)
            q[ZIGZAG] = zz
            quant[tq] = q.reshape(8, 8)
            i += 1 + size
        return
    while i + 17 <= len(body):
        tc, th = body[i] >> 4, body[i] & 15
        counts = body[i + 1:i + 17]
        n = sum(counts)
        if tc > 1 or i + 17 + n > len(body):
            raise ValueError(f"{name}: bad Huffman table segment")
        try:
            tables[tc, th] = _huffman(bytes(counts), body[i + 17:i + 17 + n], bool(tc))
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        i += 17 + n


def _frame(body: bytes, name: str):
    """A SOF segment -> (height, width, [(id, h, v, quant table)])."""
    if len(body) < 6:
        raise ValueError(f"{name}: bad frame header")
    precision, h, w, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG samples (cv2 reads 8-bit ones only)")
    if nc not in (1, 3, 4):
        raise ValueError(f"{name}: a JPEG of {nc} components (cv2 reads 1, 3 or 4)")
    if h == 0:
        raise NotImplementedError(f"{name}: a JPEG whose height comes in a DNL marker")
    if len(body) < 6 + 3 * nc:
        raise ValueError(f"{name}: bad frame header")
    comps = []
    for c in range(nc):
        cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
        comps.append((cid, hv >> 4, hv & 15, tq))
    if any(not (1 <= ch <= 4 and 1 <= cv <= 4) for _, ch, cv, _ in comps):
        raise ValueError(f"{name}: bad frame header")
    return h, w, comps


def _scan_components(scan: bytes, comps, name: str) -> List[Tuple[int, int]]:
    """A scan header's (frame index, table byte) for each of its components."""
    ns = scan[0] if scan else 0
    if not 1 <= ns <= len(comps) or len(scan) < 4 + 2 * ns:
        raise ValueError(f"{name}: bad scan header")
    by_id = {c[0]: i for i, c in enumerate(comps)}
    out = []
    for j in range(ns):
        cid, t = scan[1 + 2 * j:3 + 2 * j]
        if cid not in by_id:
            raise ValueError(f"{name}: scan names a missing component")
        out.append((by_id[cid], t))
    return out


def _block_orders(comps, members, h: int, w: int, hmax: int, vmax: int, grids):
    """Coefficient offsets of a scan's blocks in coding order, one row an
    MCU: interleaved, each MCU's blocks component by component; a
    one-component scan covers that component's own blocks (its samples'
    8x8 cover, not the MCU grid) in raster order, one block an MCU."""
    if len(members) == 1:
        ci = members[0]
        gy, gx, off = grids[ci]
        if len(comps) == 1:
            bh, bw = gy, gx
        else:
            bh = -(-(-(-h * comps[ci][2] // vmax)) // 8)
            bw = -(-(-(-w * comps[ci][1] // hmax)) // 8)
        by, bx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        return (off + (by * gx + bx) * 64).reshape(-1, 1), [ci]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    order, kinds = [], []
    for ci in members:
        ch, cv = comps[ci][1], comps[ci][2]
        gy, gx, off = grids[ci]
        my, mx, by, bx = np.meshgrid(np.arange(mcuy), np.arange(mcux), np.arange(cv),
                                     np.arange(ch), indexing="ij")
        order.append((off + ((my * cv + by) * gx + mx * ch + bx) * 64).reshape(-1, cv * ch))
        kinds += [ci] * (ch * cv)
    return np.concatenate(order, 1), kinds


def _grids(comps, h: int, w: int, hmax: int, vmax: int):
    """Each component's block grid (rows, columns, coefficient offset) in one
    coefficient array: the MCU grid of an interleaved scan (a lone
    component's 8x8 cover), and the total coefficient count."""
    grids, total = [], 0
    if len(comps) == 1:
        mcux, mcuy, hv = -(-w // 8), -(-h // 8), [(1, 1)]
    else:
        mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        hv = [(c[1], c[2]) for c in comps]
    for ch, cv in hv:
        grids.append((mcuy * cv, mcux * ch, total))
        total += mcuy * cv * mcux * ch * 64
    return grids, total


def _intervals(order: np.ndarray, kinds: list, restart: int, chunks: list, name: str,
               cut: bool = False):
    """Split a scan's blocks into restart intervals of (offset, component)
    lists: (blocks, chunk of data) for each interval. ``cut``: the data ends
    early, and the interval after its last chunk reads no data at all (its
    first MCU is decoded from zero bits: ``_run_out``); the intervals after
    that one are not decoded."""
    n_mcu = order.shape[0]
    per = restart if restart else n_mcu
    n_intervals = -(-n_mcu // per)
    if cut and len(chunks) < n_intervals:
        chunks = chunks + [b""]
    elif len(chunks) != n_intervals:
        raise ValueError(f"{name}: {len(chunks)} restart intervals, expected {n_intervals}")
    rows = order.tolist()
    return [([(b, k) for row in rows[i * per:(i + 1) * per] for b, k in zip(row, kinds)], chunk)
            for i, chunk in enumerate(chunks)]


#: zero bytes after the data of an interval that runs out: more than the
#: zero bits any MCU (at most 10 blocks of 64 codes) can read
_ZERO_PAD = 4096


def _run_out(chunk: bytes, decode, last: bool, name: str):
    """``decode(win, n_bits)`` of one interval's data -> (its result, the
    windows); ``last``: the interval may run out of data (one of the last
    two of a scan cut short), so zero bytes follow it.

    That is how libjpeg-turbo reads past the end of a file under
    ``cv2.imread``, whose stdio source hands over an EOI marker there: once
    the Huffman decoder meets it, it reads zero bits, so the MCU in which
    the data runs out is decoded from them; it then sets
    ``insufficient_data`` and leaves every later MCU of the scan undecoded
    (zero coefficients, or what earlier scans gave), restart markers or not
    (the EOI is not the restart marker it expects)."""
    win, n_bits = _windows(chunk, _ZERO_PAD if last else 8)
    try:
        return decode(win, n_bits), win
    except IndexError:
        raise ValueError(f"{name}: truncated or damaged JPEG scan") from None


def _dc_symbol(win: list, pos: int, dct: list, name: str) -> Tuple[int, int]:
    """(bits consumed, DC difference) of the DC code at ``pos``."""
    n, size, diff = dct[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if n <= 0:  # the code's extra bits lie past the 16-bit window
        if n == 0:
            raise ValueError(f"{name}: bad Huffman code in a DC coefficient")
        bits = (win[(pos - n) >> 3] >> (32 - ((pos - n) & 7) - size)) & ((1 << size) - 1)
        return size - n, _extend(bits, size)
    return n, diff


def _ac_symbol(win: list, pos: int, act: list, name: str) -> Tuple[int, int, int]:
    """(bits consumed, run, value) of the AC code at ``pos`` (see ``_huffman``)."""
    n, r, v = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if n <= 0:
        if n == 0:
            raise ValueError(f"{name}: bad Huffman code in an AC coefficient")
        size = r & 15
        bits = (win[(pos - n) >> 3] >> (32 - ((pos - n) & 7) - size)) & ((1 << size) - 1)
        return size - n, r >> 4, _extend(bits, size)
    return n, r, v


def _bits(win: list, pos: int, n: int) -> int:
    return (win[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


def _progressive_scan(coef, blocks, win: list, n_bits: int, ss: int, se: int, ah: int,
                      al: int, tabs: Dict, name: str, per: int = 1, cut: bool = False) -> int:
    """Decode one restart interval of a progressive scan (ITU T.81 G.1.2)
    into ``coef`` (zigzag order): DC first (``coef = (sum of differences) <<
    al``), DC refinement (one bit each), AC first (band ss..se, runs of
    empty blocks by EOBr) and AC refinement (a correction bit for each
    coefficient already nonzero, new coefficients of +-1 << al). ``tabs``:
    each component's Huffman table (none for a DC refinement); ``per``
    blocks an MCU. ``cut``: see ``_decode_interval``. Returns the number of
    MCUs decoded where the data ran out, else -1."""
    pos, j = 0, 0
    if ss == 0:
        if ah == 0:
            pred: Dict[int, int] = {}
            for j, (base, c) in enumerate(blocks):
                if pos > n_bits and j % per == 0:
                    break
                n, diff = _dc_symbol(win, pos, tabs[c], name)
                pos += n
                v = pred.get(c, 0) + diff
                pred[c] = v
                coef[base] = (((v << al) + 32768) & 0xFFFF) - 32768  # JCOEF
            else:
                j = len(blocks)
        else:
            bit = 1 << al
            for j, (base, _) in enumerate(blocks):
                if pos > n_bits and j % per == 0:
                    break
                if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                    coef[base] |= bit
                pos += 1
            else:
                j = len(blocks)
    elif ah == 0:
        (act,) = tabs.values()
        eobrun = 0
        for j, (base, _) in enumerate(blocks):
            if pos > n_bits:
                break
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                n, r, v = _ac_symbol(win, pos, act, name)
                pos += n
                if r >= _EOB:  # EOBr: this block and 2^r - 1 + (r bits) more
                    r -= _EOB
                    eobrun = (1 << r) - 1 + (_bits(win, pos, r) if r else 0)
                    pos += r
                    break
                k += r
                if v:  # past the band libjpeg writes on (jpeg_natural_order[k], 63 past 63)
                    coef[base + min(k, 63)] = (((v << al) + 32768) & 0xFFFF) - 32768
                k += 1
        else:
            j = len(blocks)
    else:
        (act,) = tabs.values()
        p1, m1 = 1 << al, -1 << al
        eobrun = 0
        for j, (base, _) in enumerate(blocks):
            if pos > n_bits:
                break
            k = ss
            if not eobrun:
                while k <= se:
                    n, r, v = _ac_symbol(win, pos, act, name)
                    pos += n
                    if r >= _EOB:
                        r -= _EOB
                        eobrun = (1 << r) + (_bits(win, pos, r) if r else 0)
                        pos += r
                        break
                    if v:  # libjpeg reads one sign bit, whatever size the symbol gives
                        pos += 1 - abs(v).bit_length()
                    new = p1 if v > 0 else (m1 if v < 0 else 0)
                    # correct the nonzero coefficients up to the r+1-th zero one
                    while k <= se:
                        c = coef[base + k]
                        if c:
                            if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                                coef[base + k] = c + (p1 if c >= 0 else m1)
                            pos += 1
                        elif r:
                            r -= 1
                        else:
                            break
                        k += 1
                    if new:
                        coef[base + min(k, 63)] = new
                    k += 1
            if eobrun:
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            coef[base + k] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    k += 1
                eobrun -= 1
        else:
            j = len(blocks)
    if pos <= n_bits:
        return -1
    if not cut:
        raise ValueError(f"{name}: truncated JPEG (the scan ends inside its data)")
    return -(-j // per)


def _restart_interval(body: bytes, name: str) -> int:
    """A DRI segment's interval (libjpeg takes a length of 4 only)."""
    if len(body) != 2:
        raise ValueError(f"{name}: bad restart interval segment")
    return struct.unpack(">H", body)[0]


def _next_scan(data: bytes, name: str, end: int, stop: Optional[int], quant: Dict, tables: Dict,
               restart: int):
    """The segments after a scan of a multi-scan file, up to the next scan
    or EOI (``stop``: see ``_segments``): tables and restart
    intervals redefined, others skipped. Returns (the next scan header or
    None, the offset of its data, the restart interval)."""
    scan, data_start = None, end
    for marker, body in _segments(data, name, end, stop):
        if marker in ("eoi", "data"):
            data_start = body
            break
        if marker in (0xDB, 0xC4):
            _table_segment(marker, body, quant, tables, name)
        elif marker == 0xDD:
            restart = _restart_interval(body, name)
        elif marker == 0xDA:
            scan = body
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"{name}: a second frame header")
    return scan, data_start, restart


def _progressive(data: bytes, scan: bytes, data_start: int, frame, quant: Dict, tables: Dict,
                 restart: int, name: str, from_file: bool = False, real_end: int = None):
    """Every scan of a progressive JPEG -> (zigzag coefficients, grids, the
    block smoothing's state or None). The scans run up to EOI, or (from a
    file) up to where the file ends: a scan cut short keeps what it decoded
    up to the MCU in which its data ran out (``_run_out``), and later scans
    are absent. ``smoothing`` holds what libjpeg-turbo's
    ``decompress_smooth_data`` reads (``_smooth``), where a coefficient of
    the first ten is left unknown or unrefined."""
    h, w, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    grids, total = _grids(comps, h, w, hmax, vmax)
    coef = array("h", bytes(2 * total))
    nc = len(comps)
    # libjpeg's coef_bits: each coefficient's successive-approximation bit
    # (-1: not yet sent), then the same as it stood before each component's
    # last scan
    coef_bits = np.full((2 * nc, 64), -1, np.int64)
    real_end = len(data) if real_end is None else real_end
    mcux, n_rows = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    n_scans, last_good = 0, n_rows - 1
    while True:
        members = _scan_components(scan, comps, name)
        ns = len(members)
        ss, se, ahal = scan[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahal >> 4, ahal & 15
        if ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and ns != 1) or al > 13:
            raise ValueError(f"{name}: bad progressive scan ({ss}-{se}, {ah}/{al})")
        n_scans += 1
        for ci, _ in members:
            band = coef_bits[ci, ss:se + 1]
            if (band != (-1 if ah == 0 else ah)).any():
                raise ValueError(f"{name}: a progressive scan out of order (component {ci}, "
                                 f"coefficients {ss}-{se}, bits {ah}/{al})")
            saved = slice(min(ss, 1), max(se, 9) + 1)
            coef_bits[nc + ci, saved] = coef_bits[ci, saved] if n_scans > 1 else 0
            band[:] = al
        tabs = {}
        if not (ss == 0 and ah):  # a DC refinement reads raw bits
            for ci, t in members:
                key = (0, t >> 4) if ss == 0 else (1, t & 15)
                if key not in tables:
                    raise ValueError(f"{name}: scan names a missing Huffman table")
                tabs[ci] = tables[key]
        order, kinds = _block_orders(comps, [ci for ci, _ in members], h, w, hmax, vmax, grids)
        chunks, end = _scan_chunks(data, data_start)
        if end is None and not from_file:  # libjpeg reads all scans before any row
            raise ValueError(f"{name}: truncated JPEG: a progressive scan runs to the end of "
                             "the data without EOI (cv2.imdecode refuses it)")
        cut = end is not None and end >= real_end
        per = len(kinds)
        # the MCUs of an iMCU row: an MCU row of an interleaved scan, v block
        # rows of a one-component scan
        row_mcus = mcux
        if ns == 1:
            ci = members[0][0]
            bw = -(-(-(-w * comps[ci][1] // hmax)) // 8) if nc > 1 else -(-w // 8)
            row_mcus = bw * comps[ci][2]
        last_good = n_rows - 1
        per_interval = restart if restart else order.shape[0]
        intervals = _intervals(order, kinds, restart, chunks, name, cut)
        for i, (blocks, chunk) in enumerate(intervals):
            done, _ = _run_out(chunk, lambda win, n_bits: _progressive_scan(
                coef, blocks, win, n_bits, ss, se, ah, al, tabs, name, per, cut),
                cut and i >= len(intervals) - 2, name)
            if done >= 0:  # the data ran out in this interval's MCU done - 1
                last_good = (i * per_interval + done - 1) // row_mcus
                break
        if end is None or cut:
            break
        scan, data_start, restart = _next_scan(data, name, end, real_end if from_file else None,
                                               quant, tables, restart)
        if scan is None:
            break
    smoothing = None
    if all(coef_bits[ci, 0] >= 0 for ci in range(nc)) and (coef_bits[:nc, 1:10] != 0).any():
        smoothing = {"bits": coef_bits[:nc, :10].copy(),
                     "prev": coef_bits[nc:, :10] if n_scans > 1 else np.full((nc, 10), -1),
                     "last_good": last_good}
    return coef, grids, smoothing


# ------------------------------------------------------ block smoothing
def _dc_weights(*terms) -> np.ndarray:
    """A 5x5 table of DC weights from (weight, n) pairs, where n numbers the
    window's DC values as ``jdcoefct.c`` does: DC01-DC05 the block row two
    above, from two blocks left to two right, down to DC21-DC25 the row two
    below."""
    out = np.zeros(25, np.int64)
    for weight, n in zip(terms[0::2], terms[1::2]):
        out[n - 1] += weight
    return out.reshape(5, 5)


#: ``decompress_smooth_data``'s estimates, in its order: (zigzag index,
#: weights when only DC is known (``change_dc``), weights otherwise, or
#: None where only the first estimates)
_SMOOTHING = (
    (1, _dc_weights(-1, 1, -1, 2, 1, 4, 1, 5, -3, 6, 13, 7, -13, 9, 3, 10, -3, 11, 38, 12,
                    -38, 14, 3, 15, -3, 16, 13, 17, -13, 19, 3, 20, -1, 21, -1, 22, 1, 24,
                    1, 25),
     _dc_weights(-7, 11, 50, 12, -50, 14, 7, 15)),
    (2, _dc_weights(-1, 1, -3, 2, -3, 3, -3, 4, -1, 5, -1, 6, 13, 7, 38, 8, 13, 9, -1, 10,
                    1, 16, -13, 17, -38, 18, -13, 19, 1, 20, 1, 21, 3, 22, 3, 23, 3, 24,
                    1, 25),
     _dc_weights(-7, 3, 50, 8, -50, 18, 7, 23)),
    (3, _dc_weights(1, 3, 2, 7, 7, 8, 2, 9, -5, 12, -14, 13, -5, 14, 2, 17, 7, 18, 2, 19,
                    1, 23),
     _dc_weights(-1, 3, 13, 8, -24, 13, 13, 18, -1, 23)),
    (4, _dc_weights(-1, 1, 1, 5, 9, 7, -9, 9, -9, 17, 9, 19, 1, 21, -1, 25),
     _dc_weights(1, 10, 1, 16, -10, 17, 10, 19, -1, 2, -1, 20, 1, 22, -1, 24, 1, 4, -1, 6,
                 10, 7, -10, 9)),
    (5, _dc_weights(2, 7, -5, 8, 2, 9, 1, 11, 7, 12, -14, 13, 7, 14, 1, 15, 2, 17, -5, 18,
                    2, 19),
     _dc_weights(-1, 11, 13, 12, -24, 13, 13, 14, -1, 15)),
    (6, _dc_weights(1, 7, -1, 9, 2, 12, -2, 14, 1, 17, -1, 19), None),
    (7, _dc_weights(1, 7, -3, 8, 1, 9, -1, 17, 3, 18, -1, 19), None),
    (8, _dc_weights(1, 7, -1, 9, -3, 12, 3, 14, 1, 17, -1, 19), None),
    (9, _dc_weights(1, 7, 2, 8, 1, 9, -1, 17, -2, 18, -1, 19), None),
    (0, _dc_weights(-2, 1, -6, 2, -8, 3, -6, 4, -2, 5, -6, 6, 6, 7, 42, 8, 6, 9, -6, 10,
                    -8, 11, 42, 12, 152, 13, 42, 14, -8, 15, -6, 16, 6, 17, 42, 18, 6, 19,
                    -6, 20, -2, 21, -6, 22, -8, 23, -6, 24, -2, 25), None),
)


def _window_rows(rows: int, v: int, n_imcu: int) -> np.ndarray:
    """(rows, 5) block rows of each block row's DC window (two above to two
    below), as ``decompress_smooth_data`` picks them: it counts block rows
    as (iMCU row) x (block rows of this iMCU row) + (row in it), so in the
    last iMCU row of a component with v > 1 the count can differ from the
    row's index, and the edge tests follow the count."""
    out = []
    for r in range(rows):
        imcu, b = divmod(r, v)
        block_rows = v if imcu < n_imcu - 1 else (rows % v or v)
        counted, counted_rows = imcu * block_rows + b, block_rows * n_imcu
        p = r - 1 if counted > 0 else r
        pp = r - 2 if counted > 1 else p
        n = r + 1 if counted < counted_rows - 1 else r
        nn = r + 2 if counted < counted_rows - 2 else n
        out.append([pp, p, r, n, nn])
    return np.array(out, np.int64)


def _smooth(blocks: List[np.ndarray], tables: List[np.ndarray], comps, h: int, w: int,
            state: dict) -> List[np.ndarray]:
    """libjpeg-turbo's block smoothing (``decompress_smooth_data``) of a
    progressive file's natural-order blocks: in each block, each of the
    coefficients 1-9 (zigzag) that is still zero and not known exactly
    (``coef_bits`` not 0) takes an estimate from the DC values of the 5x5
    blocks around it; where none of them is known yet (``change_dc``) the
    DC is replaced by a weighted mean of those DC values too. An estimate is
    ``(128 q + |num|) // (256 q)`` of ``num = Q00 x (weights . DC)`` with the
    sign of num, limited below ``2^Al`` for an unrefined one. The rows past
    the last iMCU row whose data the last scan read
    (``state['last_good']``) use each component's bits as they stood
    before its last scan."""
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    n_imcu = -(-h // (8 * vmax))
    out = []
    for ci, (b, q, c) in enumerate(zip(blocks, tables, comps)):
        v = c[2]
        rows = -(-(-(-h * v // vmax)) // 8)
        cols = -(-(-(-w * c[1] // hmax)) // 8)
        nat = b.reshape(b.shape[0], b.shape[1], 64).astype(np.int64)
        pad = n_imcu * v - nat.shape[0]
        dc = np.pad(nat[..., 0], ((0, max(pad, 0)), (0, 0)))
        window_cols = np.clip(np.arange(cols)[:, None] + np.arange(-2, 3), 0, cols - 1)
        win = dc[_window_rows(rows, v, n_imcu)[:, None, :, None],
                 window_cols[None, :, None, :]]  # (rows, cols, 5, 5); columns replicate
        late = (np.arange(rows) // v > state["last_good"])[:, None]
        bits = np.where(late, state["prev"][ci][None], state["bits"][ci][None])  # (rows, 10)
        change_dc = (bits[:, 1:] == -1).all(1)[:, None]
        ws = nat[:rows, :cols].copy()
        qz = q.reshape(-1)[ZIGZAG[:10]]
        for k, dc_only, with_ac in _SMOOTHING:
            weights = dc_only if with_ac is None else np.where(change_dc[..., None, None],
                                                               dc_only, with_ac)
            num = qz[0] * (win * weights).sum((2, 3))
            qk = qz[k]
            pred = ((qk << 7) + np.abs(num)) // (qk << 8)
            al = bits[:, k][:, None]
            if k:
                pred = np.where((al > 0) & (pred >= (1 << np.maximum(al, 0))),
                                (1 << np.maximum(al, 0)) - 1, pred)
            pred = np.where(num >= 0, pred, -pred)
            pos = ZIGZAG[k]
            use = (al != 0) & (ws[..., pos] == 0) if k else np.ones_like(late)
            if with_ac is None:
                use = use & change_dc
            ws[..., pos] = np.where(use, pred.astype(np.int16), ws[..., pos])
        smoothed = nat.copy()
        smoothed[:rows, :cols] = ws
        out.append(smoothed.astype(np.int16).reshape(b.shape))
    return out


def _colour_space(comps, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg's ``default_decompress_parms``: the colour space of the coded
    components ('grey', 'ycc', 'rgb', 'cmyk' or 'ycck')."""
    if len(comps) == 1:
        return "grey"
    if len(comps) == 4:
        return "cmyk" if adobe is None or adobe == 0 else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if [c[0] for c in comps] == [82, 71, 66] else "ycc"


#: what libjpeg's stdio source reads past the end of a file: each time it
#: finds no more bytes it warns and hands over an EOI marker (enough of them
#: for the longest segment)
_STDIO_END = b"\xff\xd9" * 32768


def _headers_whole(data: bytes, name: str) -> bool:
    """Whether ``data`` holds its headers up to the end of its first SOS."""
    try:
        return any(marker == "data" for marker, _ in _segments(data, name))
    except ValueError:
        return False


def _parse(data: bytes, name: str, from_file: bool = False):
    """A baseline or progressive JPEG -> (zigzag coefficients, grids, frame,
    quantization tables, EXIF orientation, colour space, block smoothing
    state or None). ``from_file``: see ``decode_jpeg``."""
    real_end = len(data)
    headers_cut = from_file and not _headers_whole(data, name)
    if from_file:  # cv2.imread's stdio source
        data += _STDIO_END
    try:
        return _parse_from(data, name, from_file, real_end)
    except (NotImplementedError, ValueError):
        if headers_cut:  # the stdio source's EOI read as header fields
            raise ValueError(f"{name}: truncated JPEG: the file ends inside its "
                             "headers") from None
        raise


def _parse_from(data: bytes, name: str, from_file: bool, real_end: int):
    quant: Dict[int, np.ndarray] = {}
    tables: Dict[Tuple[int, int], list] = {}
    frame = None
    progressive = False
    restart = 0
    orientation = None
    adobe = None
    jfif = False
    scan = None
    data_start = 0
    for marker, body in _segments(data, name, 2, real_end if from_file else None):
        if marker == "eoi":
            raise ValueError(f"{name}: JPEG ends before its scan")
        if marker == "data":
            data_start = body
            break
        if marker in (0xDB, 0xC4):
            _table_segment(marker, body, quant, tables, name)
        elif marker in (0xC0, 0xC1, 0xC2):
            frame = _frame(body, name)
            progressive = marker == 0xC2
        elif marker in _SOF_NAMES:
            raise NotImplementedError(f"{name}: {_SOF_NAMES[marker]} JPEG: only baseline, "
                                      "extended sequential and progressive Huffman (SOF0, "
                                      "SOF1, SOF2) are read")
        elif marker == 0xCC:
            raise NotImplementedError(f"{name}: arithmetic coding (DAC) is not read")
        elif marker == 0xDD:
            restart = _restart_interval(body, name)
        elif marker == 0xE0 and body.startswith(b"JFIF\0") and len(body) >= 14:
            jfif = True
        elif marker == 0xE1 and orientation is None:
            orientation = _orientation(body)
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            scan = body
    if frame is None or scan is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    h, w, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if any(hmax % c[1] or vmax % c[2] for c in comps):
        raise NotImplementedError(f"{name}: fractional sampling factors "
                                  f"{[(c[1], c[2]) for c in comps]}")
    if any(c[3] not in quant for c in comps):
        raise ValueError(f"{name}: missing quantization table")
    decode = _progressive if progressive else _sequential
    coef, grids, smoothing = decode(data, scan, data_start, frame, quant, tables, restart, name,
                                    from_file, real_end)
    return coef, grids, frame, quant, orientation, _colour_space(comps, jfif, adobe), smoothing


def _natural_blocks(coef, grids) -> List[np.ndarray]:
    """Zigzag coefficients -> each component's (block rows, block columns,
    8, 8) int16 blocks in natural order."""
    zig = np.frombuffer(coef, np.int16).reshape(-1, 64)
    nat = np.empty_like(zig)
    nat[:, ZIGZAG] = zig
    return [nat[off // 64:off // 64 + gy * gx].reshape(gy, gx, 8, 8) for gy, gx, off in grids]


def cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray) -> np.ndarray:
    """cv2's ``icvCvt_CMYK2BGR_8u_C4C3R`` on the samples libjpeg gives for
    ``JCS_CMYK``: each of red, green and blue is ``k - ((255 - s) * k >> 8)``
    of its ink sample s (an Adobe file's inverted inks, taken as written)."""
    k = k.astype(np.int64)
    return np.stack([k - (((255 - v.astype(np.int64)) * k) >> 8) for v in (c, m, y)],
                    -1).astype(np.uint8)


def _pixels(blocks: List[np.ndarray], tables: List[np.ndarray], factors, h: int,
            w: int, colour: str = "ycc") -> np.ndarray:
    """Each component's quantized blocks (natural order), its quantization
    table and (h, v) sampling factors -> (h, w, 3) uint8 RGB: the islow
    IDCT, fancy upsampling and colour conversion of libjpeg-turbo, for the
    colour space ``colour`` (``_colour_space``); CMYK and YCCK through cv2's
    own conversion."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    planes = []
    for b, q, (ch, cv) in zip(blocks, tables, factors):
        gy, gx = b.shape[:2]
        px = idct_islow(b.reshape(-1, 8, 8), q)
        px = px.reshape(gy, gx, 8, 8).transpose(0, 2, 1, 3).reshape(gy * 8, gx * 8)
        fh, fv = hmax // ch, vmax // cv
        dh, dw = -(-h // fv), -(-w // fh)  # downsampled_height, downsampled_width
        planes.append(upsample(px[:dh, :dw], fh, fv)[:h, :w])
    if colour == "grey":
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, 2)
    if colour == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    if colour == "ycc":
        return ycc_to_rgb(*planes)
    if colour == "ycck":  # jdcolor.c's ycck_cmyk_convert: inks 255 - RGB, K as coded
        inks = 255 - ycc_to_rgb(*planes[:3]).astype(np.int64)
        planes = [inks[..., 0], inks[..., 1], inks[..., 2], planes[3]]
    return cmyk_to_rgb(*planes)


def decode_jpeg(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """A JPEG -> (H, W, 3) uint8 RGB, equal to cv2's decode (see the
    module's docstring): of a file as ``cv2.imread`` reads it
    (``from_file``), else of bytes as ``cv2.imdecode`` reads them. The two
    differ on a file that runs to its end without an EOI, complete or cut
    short: libjpeg's stdio source, under ``imread``, supplies the EOI;
    cv2's memory source, under ``imdecode``, cannot, and libjpeg-turbo
    suspends wherever its bit reader asks for more data
    (``_memory_source_reaches_end``)."""
    coef, grids, (h, w, comps), quant, orientation, colour, smoothing = _parse(data, name,
                                                                                from_file)
    blocks = _natural_blocks(coef, grids)
    tables = [quant[c[3]] for c in comps]
    if smoothing is not None and all(t.reshape(-1)[ZIGZAG[:10]].all() for t in tables):
        blocks = _smooth(blocks, tables, comps, h, w, smoothing)
    img = _pixels(blocks, tables, [(c[1], c[2]) for c in comps], h, w, colour)
    return apply_orientation(img, orientation)


def decode_tiff_strip(data: bytes, tables: bytes = b"", ycc: bool = True,
                      name: str = "<bytes>") -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """One strip or tile of a JPEG-compressed TIFF (compression 7), as
    libtiff's JPEG codec hands it to libjpeg: the ``JPEGTables`` stream
    (SOI, tables, EOI) read first, so an abbreviated strip finds its
    tables, and libtiff's source inserting EOI markers past the data (as
    ``from_file``). ``ycc``: photometric YCbCr, which libtiff decodes to RGB
    (libjpeg's upsampling and colour conversion, ``JCS_YCbCr`` whatever the
    markers say); else the components as coded (``JCS_UNKNOWN``). No EXIF
    orientation. -> ((h, w, 3) uint8 RGB or (h, w, components) samples,
    each component's (h, v) sampling factors)."""
    if tables:
        body = tables[2:-2] if tables.endswith(b"\xff\xd9") else tables[2:]
        data = data[:2] + body + data[2:]
    coef, grids, (h, w, comps), quant, _, _, smoothing = _parse(data, name, True)
    blocks = _natural_blocks(coef, grids)
    qtables = [quant[c[3]] for c in comps]
    if smoothing is not None and all(t.reshape(-1)[ZIGZAG[:10]].all() for t in qtables):
        blocks = _smooth(blocks, qtables, comps, h, w, smoothing)
    factors = [(c[1], c[2]) for c in comps]
    if ycc:
        if len(comps) != 3:
            raise ValueError(f"{name}: TIFF YCbCr JPEG strip of {len(comps)} components")
        return _pixels(blocks, qtables, factors, h, w, "ycc"), factors
    if any(f != (1, 1) for f in factors):
        raise ValueError(f"{name}: subsampled JPEG strip in a TIFF that is not YCbCr")
    return _pixels(blocks, qtables, factors, h, w, "rgb"), factors  # 'rgb': as coded


def read_coefficients(data: bytes, name: str = "<bytes>") -> Dict[str, list]:
    """A JPEG's quantized coefficients as its file holds them:
    ``{"blocks": [(block rows, block columns, 8, 8) int16 in natural order,
    one a component, over the MCU grid], "quant": [(8, 8) table of each
    component], "factors": [(h, v) of each component]}``."""
    coef, grids, (h, w, comps), quant, _, _, _ = _parse(data, name)
    return {"blocks": _natural_blocks(coef, grids), "quant": [quant[c[3]] for c in comps],
            "factors": [(c[1], c[2]) for c in comps]}


def _sequential(data: bytes, scan: bytes, data_start: int, frame, quant: Dict, tables: Dict,
                restart: int, name: str, from_file: bool = False, real_end: int = None):
    """The scans of a sequential JPEG -> (zigzag coefficients, grids, None):
    one interleaved scan of every component, after which cv2 reads nothing
    more, or scans that each code some of them (libjpeg's buffered mode:
    every scan up to EOI, with any table, restart interval, comment or APPn
    segment between them). From a file cut short, a scan keeps what it
    decoded up to the MCU in which its data ran out (``_run_out``), and
    later scans are absent. libjpeg only warns about a sequential scan's
    spectral selection and successive approximation, so they are not read."""
    h, w, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    grids, total = _grids(comps, h, w, hmax, vmax)
    coef = array("h", bytes(2 * total))
    real_end = len(data) if real_end is None else real_end
    multi = scan[0] < len(comps)  # libjpeg's has_multiple_scans
    coded: List[int] = []
    while True:
        members = _scan_components(scan, comps, name)
        for ci, t in members:
            if (0, t >> 4) not in tables or (1, t & 15) not in tables:
                raise ValueError(f"{name}: scan names a missing component or Huffman table")
            if ci in coded:
                raise NotImplementedError(f"{name}: a sequential JPEG that codes component "
                                          f"{comps[ci][0]} in two scans")
        coded += [ci for ci, _ in members]
        order, kinds = _block_orders(comps, [ci for ci, _ in members], h, w, hmax, vmax, grids)
        tabs = {ci: (tables[0, t >> 4], tables[1, t & 15]) for ci, t in members}
        chunks, end = _scan_chunks(data, data_start)
        from_memory = end is None and not from_file
        if from_memory and multi:  # libjpeg reads all scans before any row
            raise ValueError(f"{name}: truncated JPEG: a scan of a multi-scan file runs to "
                             "the end of the data without EOI (cv2.imdecode refuses it)")
        cut = end is not None and end >= real_end
        intervals = _intervals(order, kinds, restart, chunks, name, cut)
        for i, (blocks, chunk) in enumerate(intervals):
            blocks = [(b,) + tabs[c] + (c,) for b, c in blocks]
            ran_out, win = _run_out(chunk, lambda win, n_bits: _decode_interval(
                win, n_bits, blocks, coef, name, len(kinds), cut),
                cut and i >= len(intervals) - 2, name)
            if ran_out:
                break
        if from_memory and not _memory_source_reaches_end(
                chunks[-1], _symbol_trace(win, blocks), len(kinds), not restart):
            raise ValueError(f"{name}: truncated JPEG: its scan runs to the end of the data "
                             "without EOI, and libjpeg-turbo's bit reader asks for more before "
                             "its last MCU (cv2.imdecode refuses it)")
        if end is None or cut or not multi:
            break
        scan, data_start, restart = _next_scan(data, name, end, real_end if from_file else None,
                                               quant, tables, restart)
        if scan is None:
            break
    return coef, grids, None


# --------------------------------------------------------------- the encoder
#: ``jcparam.c``'s standard tables (ITU T.81 K.1, natural order)
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)
STD_CHROMINANCE = np.full((8, 8), 99, np.int64)
STD_CHROMINANCE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                           [47, 66, 99, 99]]


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """``jpeg_set_quality(cinfo, quality, TRUE)``: the luminance and
    chrominance tables scaled by ``jpeg_quality_scaling`` and limited to
    1..255 (``force_baseline``)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMINANCE,
                                                                     STD_CHROMINANCE))


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def bgr_to_ycc(img: np.ndarray) -> List[np.ndarray]:
    """``jccolor.c``'s fixed-point RGB -> YCbCr (SCALEBITS 16) of (H, W, 3)
    uint8 BGR rows (cv2 hands libjpeg ``JCS_EXT_BGR``): three int64 planes."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    return [y, cb, cr]


def _fdct_1d(d: List[np.ndarray]):
    """``jpeg_fdct_islow``'s butterfly on 8 int64 arrays: (even outputs 0
    and 4 before their shift, the other six before their descale)."""
    f = _F
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    z1 = (t12 + t13) * f["f0_541"]
    out = [None] * 8
    out[0], out[4] = t10 + t11, t10 - t11
    out[2] = z1 + t13 * f["f0_765"]
    out[6] = z1 - t12 * f["f1_847"]
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * f["f1_175"]
    t4 = t4 * f["f0_298"]
    t5 = t5 * f["f2_053"]
    t6 = t6 * f["f3_072"]
    t7 = t7 * f["f1_501"]
    z1 = z1 * -f["f0_899"]
    z2 = z2 * -f["f2_562"]
    z3 = z3 * -f["f1_961"] + z5
    z4 = z4 * -f["f0_390"] + z5
    out[7] = t4 + z1 + z3
    out[5] = t5 + z2 + z4
    out[3] = t6 + z2 + z3
    out[1] = t7 + z1 + z4
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) samples 0-255 -> (N, 8, 8) int64, ``jpeg_fdct_islow`` on the
    samples less 128 (``CONST_BITS`` 13, ``PASS1_BITS`` 2; output 8x the
    DCT, as the divisors expect)."""
    x = blocks.astype(np.int64) - 128
    rows = _fdct_1d([x[:, :, k] for k in range(8)])  # pass 1: along each row
    rows = [v << 2 if k in (0, 4) else (v + (1 << 10)) >> 11 for k, v in enumerate(rows)]
    cols = _fdct_1d([np.stack(rows, 2)[:, k, :] for k in range(8)])  # pass 2: down columns
    cols = [(v + 2) >> 2 if k in (0, 4) else (v + (1 << 14)) >> 15 for k, v in enumerate(cols)]
    return np.stack(cols, 1)


def quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``jcdctmgr.c``'s ``quantize`` by the divisors 8 x ``table`` through
    ``compute_reciprocal`` (16-bit ``DCTELEM``): |c| + correction times the
    reciprocal, shifted right, the sign put back."""
    div = (np.asarray(table, np.int64) * 8).reshape(-1)
    recip, corr, shift = np.empty(64, np.int64), np.empty(64, np.int64), np.empty(64, np.int64)
    for i, d in enumerate(div.tolist()):
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    shape = coef.shape
    c = coef.reshape(-1, 64)
    q = ((np.abs(c) + corr) * recip) >> shift
    return np.where(c < 0, -q, q).reshape(shape)


def _replicate(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Extend a plane to (rows, cols) by repeating its last row and column."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).transpose(0, 2, 1, 3)


def encode_coefficients(img: np.ndarray, quality: int) -> Dict[str, list]:
    """The quantized coefficients of ``cv2.imencode('.jpg', img,
    [IMWRITE_JPEG_QUALITY, quality])`` for an (H, W, 3) uint8 BGR image, as
    libjpeg-turbo 3.1 computes them for cv2's defaults (baseline, YCbCr
    4:2:0, islow DCT): ``read_coefficients``' layout. The colour planes are
    extended by repeating their last column to the component's blocks (for
    chroma, twice its block columns) and their last row to an even height;
    chroma is ``h2v2_downsample``'s mean of each 2x2 with the bias 1, 2 in
    turn along a row; each plane's last row is repeated to whole MCU rows;
    the blocks past the picture that complete an MCU (luma only) are
    ``jccoefct.c``'s dummies: zero, with the DC of the block before."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_coefficients takes (H, W, 3) uint8 images, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    mcuy, mcux = -(-h // 16), -(-w // 16)
    luma, chroma = quality_tables(quality)
    y, cb, cr = bgr_to_ycc(img)
    he = h + (h & 1)
    by, bx = -(-h // 8), -(-w // 8)
    yq = quantize(fdct_islow(_blocks(_replicate(y, 8 * by, 8 * bx)).reshape(-1, 8, 8)), luma)
    yb = np.zeros((2 * mcuy, 2 * mcux, 8, 8), np.int64)
    yb[:by, :bx] = yq.reshape(by, bx, 8, 8)
    if bx < 2 * mcux:  # a dummy column: the DC of its left neighbour
        yb[:by, bx, 0, 0] = yb[:by, bx - 1, 0, 0]
    if by < 2 * mcuy:  # a dummy row: the DC of the MCU's block above right
        yb[by, :, 0, 0] = np.repeat(yb[by - 1, 1::2, 0, 0], 2)
    out = [yb.astype(np.int16)]
    for plane in (cb, cr):
        p = _replicate(plane, he, 16 * mcux)
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        s = (s + np.array([1, 2] * (s.shape[1] // 2))) >> 2
        q = quantize(fdct_islow(_blocks(_replicate(s, 8 * mcuy, 8 * mcux)).reshape(-1, 8, 8)),
                     chroma)
        out.append(q.reshape(mcuy, mcux, 8, 8).astype(np.int16))
    return {"blocks": out, "quant": [luma, chroma, chroma], "factors": [(2, 2), (1, 1), (1, 1)]}


def jpeg_round_trip(img: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY,
    quality])[1], IMREAD_COLOR)`` of an (H, W, 3) uint8 BGR image, without
    a bitstream: the encoder's quantized coefficients straight into the
    decoder's inverse path (the decode depends on nothing else)."""
    c = encode_coefficients(img, quality)
    h, w = img.shape[:2]
    return np.ascontiguousarray(_pixels(c["blocks"], c["quant"], c["factors"], h, w)[..., ::-1])

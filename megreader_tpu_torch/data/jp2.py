"""JPEG 2000 files as cv2 5 reads them through OpenJPEG 2.5: the JP2
container (ITU-T T.800 Annex I) or a raw codestream (``data/j2k.py``),
then cv2's step to 8-bit RGB.

* ``is_jpeg2000(data)``: the JP2 signature box (``00 00 00 0C 'jP  '
  0D 0A 87 0A``) or a codestream's SOC and SIZ (``FF 4F FF 51``), the two
  signatures cv2 tells JPEG 2000 by.
* ``decode_jpeg2000(data)``: -> (H, W, 3) uint8 RGB. The JP2 boxes read:
  signature, ``ftyp``, ``jp2h`` (``ihdr``, the first ``colr``: an
  enumerated colour space or an ICC profile, ``pclr`` with ``cmap``,
  ``cdef``; others such as ``bpcc`` and ``res `` are skipped), then
  ``jp2c``; boxes of 64-bit length (``XLBox``) and a last box that runs
  to the end of the file (``LBox`` 0). OpenJPEG applies the palette and
  the channel definitions (their order; alpha is kept apart) itself, so
  cv2 sees colour components.

cv2's step to 8 bits, found by probes of cv2 5.0.0:

* the codestream's components (before any palette) must number 1-4, be
  unsigned, and reach 8 bits in the widest; every sample is shifted
  right by the widest precision less 8 (16-bit grey gives ``v >> 8``) and
  cast to 8 bits, its higher bits dropped (a palette of 16-bit entries
  over 8-bit indices gives ``v & 255``);
* every component must be sampled at every grid point from the grid's
  origin (dx = dy = 1, no image offset), or cv2 refuses ("tiles are not
  supported");
* the colour space: sRGB, unspecified or unknown (a raw codestream, an
  ICC profile, an enumerated space OpenJPEG does not name) takes the
  first three components as R, G, B and needs them; grey takes the first
  component into all three channels, whatever follows it; sYCC takes the
  first three as Y, Cb, Cr through cv2's 8-bit YUV-to-RGB (14-bit fixed
  point, BT.601 analogue coefficients); CMYK and eYCC are refused.

Where cv2 returns None the reader raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from . import j2k

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_GREY, _SYCC, _EYCC, _CMYK = 17, 18, 24, 12
_SPACES = {16: "sRGB", 17: "grey", 18: "sYCC", 24: "eYCC", 12: "CMYK"}


def is_jpeg2000(data: bytes) -> bool:
    return data.startswith(JP2_SIGNATURE) or data.startswith(j2k.SIGNATURE)


class _Boxes:
    """What the JP2 header boxes say: the codestream's bytes, the colour
    space's enumeration (None where OpenJPEG names none), the palette,
    component mapping and channel definitions."""

    def __init__(self):
        self.codestream: Optional[bytes] = None
        self.enumcs: Optional[int] = None
        self.has_colr = False
        self.palette: Optional[Tuple[np.ndarray, List[int], List[bool]]] = None
        self.cmap: Optional[List[Tuple[int, int, int]]] = None
        self.cdef: Optional[List[List[int]]] = None
        self.size: Tuple[int, int] = (0, 0)  # ihdr's (height, width)


def _boxes(data: bytes, at: int, end: int, name: str, top: bool):
    """(type, body start, body end) of each box in data[at:end]."""
    while at < end:
        if at + 8 > end:
            raise ValueError(f"{name}: JP2 box header cut short")
        length, kind = struct.unpack_from(">I4s", data, at)
        head = 8
        if length == 1:
            if at + 16 > end:
                raise ValueError(f"{name}: JP2 box header cut short")
            length = struct.unpack_from(">Q", data, at + 8)[0]
            if length >> 32:
                raise ValueError(f"{name}: a JP2 box of 2^32 bytes or more")
            head = 16
        elif length == 0:
            if not top or kind != b"jp2c":
                raise ValueError(f"{name}: JP2 box {kind!r} of undefined size")
            length = end - at
        if length < head:
            raise ValueError(f"{name}: JP2 box {kind!r} of {length} bytes")
        if not top and at + length > end:
            raise ValueError(f"{name}: JP2 box {kind!r} runs past the box it is in")
        yield kind, at + head, at + length
        at += length


def _header(data: bytes, name: str) -> _Boxes:
    out = _Boxes()
    seen_jp2h = seen_ihdr = False
    for i, (kind, start, stop) in enumerate(_boxes(data, 0, len(data), name, True)):
        if i == 0 and kind != b"jP  ":
            raise ValueError(f"{name}: JP2 file without its signature box first")
        if i == 1 and kind != b"ftyp":
            raise ValueError(f"{name}: JP2 file whose second box is not ftyp")
        if kind == b"jp2c":
            if not seen_jp2h:
                raise ValueError(f"{name}: JP2 codestream before the jp2h box")
            out.codestream = data[start:]  # OpenJPEG reads on to EOC, past the box's length
            break
        if stop > len(data):
            raise ValueError(f"{name}: JP2 box {kind!r} runs past the end")
        if kind == b"jp2h":
            seen_jp2h = True
            for sub, s0, s1 in _boxes(data, start, stop, name, False):
                body = data[s0:s1]
                if sub == b"ihdr":
                    if len(body) != 14:
                        raise ValueError(f"{name}: bad ihdr box")
                    seen_ihdr = True
                    h, w, nc = struct.unpack_from(">IIH", body)
                    if not 1 <= nc <= 16384:
                        raise ValueError(f"{name}: ihdr box of {nc} components")
                    out.size = (h, w)
                elif sub == b"colr":
                    _colr(body, out, name)
                elif sub == b"pclr":
                    _pclr(body, out, name)
                elif sub == b"cmap":
                    _cmap(body, out, name)
                elif sub == b"cdef":
                    _cdef(body, out, name)
    if out.codestream is None:
        raise ValueError(f"{name}: JP2 file without a codestream box")
    if not seen_jp2h or not seen_ihdr:
        raise ValueError(f"{name}: JP2 file without its {'jp2h' if not seen_jp2h else 'ihdr'} box")
    return out


def _colr(body: bytes, out: _Boxes, name: str) -> None:
    if out.has_colr:
        return  # a JP2 reader takes the first colour specification only
    if len(body) < 3:
        raise ValueError(f"{name}: bad colr box")
    meth = body[0]
    if meth == 1:
        if len(body) < 7:
            raise ValueError(f"{name}: bad colr box")
        enumcs = struct.unpack_from(">I", body, 3)[0]
        out.enumcs = enumcs if enumcs in _SPACES else None
        out.has_colr = True
    elif meth == 2:
        out.has_colr = True  # an ICC profile: no colour space OpenJPEG names


def _pclr(body: bytes, out: _Boxes, name: str) -> None:
    if out.palette is not None:
        raise ValueError(f"{name}: a second pclr box")
    if len(body) < 3:
        raise ValueError(f"{name}: bad pclr box")
    entries, columns = struct.unpack_from(">HB", body)
    if not 1 <= entries <= 1024 or columns == 0 or len(body) < 3 + columns:
        raise ValueError(f"{name}: bad pclr box ({entries} entries, {columns} columns)")
    sizes = [(b & 0x7F) + 1 for b in body[3:3 + columns]]
    signs = [bool(b & 0x80) for b in body[3:3 + columns]]
    table = np.zeros((entries, columns), np.int64)
    at = 3 + columns
    for j in range(entries):
        for i, bits in enumerate(sizes):
            n = min((bits + 7) >> 3, 4)
            if at + n > len(body):
                raise ValueError(f"{name}: pclr box cut short")
            table[j, i] = int.from_bytes(body[at:at + n], "big")
            at += n
    out.palette = (table, sizes, signs)


def _cmap(body: bytes, out: _Boxes, name: str) -> None:
    if out.palette is None:
        raise ValueError(f"{name}: a cmap box before the pclr box")
    if out.cmap is not None:
        raise ValueError(f"{name}: a second cmap box")
    n = out.palette[0].shape[1]
    if len(body) < 4 * n:
        raise ValueError(f"{name}: cmap box cut short")
    out.cmap = [struct.unpack_from(">HBB", body, 4 * i) for i in range(n)]


def _cdef(body: bytes, out: _Boxes, name: str) -> None:
    if out.cdef is not None:
        raise ValueError(f"{name}: a second cdef box")
    if len(body) < 2:
        raise ValueError(f"{name}: bad cdef box")
    n = struct.unpack_from(">H", body)[0]
    if n == 0 or len(body) < 2 + 6 * n:
        raise ValueError(f"{name}: bad cdef box ({n} channels)")
    out.cdef = [list(struct.unpack_from(">HHH", body, 2 + 6 * i)) for i in range(n)]


def _check_colour(boxes: _Boxes, ncomp: int, name: str) -> None:
    """OpenJPEG's ``opj_jp2_check_color``."""
    pclr = boxes.palette is not None and boxes.cmap is not None
    if boxes.cdef is not None:
        n = boxes.palette[0].shape[1] if pclr else ncomp
        for cn, _typ, asoc in boxes.cdef:
            if cn >= n or (asoc not in (0, 65535) and asoc - 1 >= n):
                raise ValueError(f"{name}: cdef names component {cn} or {asoc - 1} of {n}")
        for c in range(n):
            if not any(cn == c for cn, _, _ in boxes.cdef):
                raise ValueError(f"{name}: cdef leaves component {c} undefined")
    if pclr:
        n = boxes.palette[0].shape[1]
        used = [False] * n
        for i, (cmp, mtyp, pcol) in enumerate(boxes.cmap):
            if cmp >= ncomp or mtyp > 1 or pcol >= n or (mtyp == 1 and used[pcol]) \
                    or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                raise ValueError(f"{name}: bad component mapping {i}: ({cmp}, {mtyp}, {pcol})")
            used[pcol] = True
        if any(not used[i] and boxes.cmap[i][1] != 0 for i in range(n)):
            raise ValueError(f"{name}: a palette column without a component mapping")
        if ncomp == 1 and not all(used):
            boxes.cmap = [(c, 1, i) for i, (c, _, _) in enumerate(boxes.cmap)]


def _apply(boxes: _Boxes, comps: list) -> list:
    """OpenJPEG's palette (``opj_jp2_apply_pclr``) and channel definitions
    (``opj_jp2_apply_cdef``): comps are [dx, dy, prec, signed, samples,
    alpha]."""
    if boxes.palette is not None and boxes.cmap is not None:
        table, sizes, signs = boxes.palette
        new = []
        for i, (cmp, mtyp, pcol) in enumerate(boxes.cmap):
            dx, dy, _, _, src, _ = comps[cmp]
            if mtyp == 0:
                v = src.copy()
            else:
                v = table[np.clip(src, 0, table.shape[0] - 1), pcol]
            new.append([dx, dy, sizes[i], signs[i], v, 0])
        comps = new
    if boxes.cdef is not None:
        info = [list(e) for e in boxes.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            if cn >= len(comps):
                continue
            if asoc in (0, 65535):
                comps[cn][5] = typ
                continue
            acn = asoc - 1
            if acn >= len(comps):
                continue
            if cn != acn and typ == 0:
                comps[cn], comps[acn] = comps[acn], comps[cn]
                for later in info[i + 1:]:
                    if later[0] == cn:
                        later[0] = acn
                    elif later[0] == acn:
                        later[0] = cn
            comps[cn][5] = typ
    return comps


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2's 8-bit ``COLOR_YUV2RGB``: 14-bit fixed-point coefficients,
    each term rounded to nearest, saturated."""
    def descale(x):
        return (x + (1 << 13)) >> 14

    u, v = u - 128, v - 128
    r = y + descale(v * 18678)
    g = y + descale(u * -6472 + v * -9519)
    b = y + descale(u * 33292)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg2000(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JP2 file or J2K codestream -> (H, W, 3) uint8 RGB as cv2 5 reads it."""
    data = bytes(data)
    boxes = _header(data, name) if data.startswith(JP2_SIGNATURE) else None
    stream = boxes.codestream if boxes is not None else data
    head = j2k.read_header(stream, name)
    h, w = head.y1 - head.y0, head.x1 - head.x0
    if boxes is not None and boxes.size != (h, w):
        raise ValueError(f"{name}: JP2 header of {boxes.size[1]}x{boxes.size[0]}, codestream of "
                         f"{w}x{h}")
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise ValueError(f"{name}: a JPEG 2000 image of {w}x{h} (cv2 reads up to 2^20 a side "
                         "and 2^30 pixels)")
    precs = [prec for _, _, prec, _ in head.comps]
    if not 1 <= len(head.comps) <= 4:
        raise ValueError(f"{name}: JPEG 2000 image of {len(head.comps)} components "
                         "(cv2 reads 1-4)")
    if any(signed for _, _, _, signed in head.comps):
        raise ValueError(f"{name}: JPEG 2000 image with signed components (cv2 refuses them)")
    if max(precs) < 8:
        raise ValueError(f"{name}: JPEG 2000 image of {max(precs)}-bit components "
                         "(cv2 reads 8 bits and more)")
    if boxes is not None:
        _check_colour(boxes, len(head.comps), name)
    image = j2k.decode_codestream(stream, name)
    comps = [[dx, dy, prec, signed, v, 0] for dx, dy, prec, signed, v in image.comps]
    if boxes is not None:
        comps = _apply(boxes, comps)
    if image.x0 or image.y0 or any(c[0] != 1 or c[1] != 1 for c in comps):
        raise ValueError(f"{name}: JPEG 2000 image with an offset or subsampled components "
                         "(cv2 refuses them)")
    shift = max(precs) - 8
    planes = [(c[4] >> shift) & 0xFF for c in comps]  # cv2 casts, it does not saturate
    space = boxes.enumcs if boxes is not None else None
    if space == _GREY:
        return np.repeat(planes[0][..., None], 3, -1).astype(np.uint8)
    if space in (_EYCC, _CMYK):
        raise ValueError(f"{name}: JPEG 2000 image in the {_SPACES[space]} colour space "
                         "(cv2 refuses it)")
    if len(planes) < 3:
        raise ValueError(f"{name}: JPEG 2000 image of {len(planes)} components in an "
                         f"{'sYCC' if space == _SYCC else 'RGB'} colour space (cv2 refuses it)")
    if space == _SYCC:
        return _yuv_to_rgb(*planes[:3])
    return np.stack(planes[:3], -1).astype(np.uint8)

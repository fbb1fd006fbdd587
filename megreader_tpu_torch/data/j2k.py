"""A JPEG 2000 codestream (ITU-T T.800 Annex A and B) decoded as OpenJPEG
2.5 decodes it: its markers, tile-parts and tier-2 packets, then tier-1
(``data/ebcot.py``), dequantisation and the inverse transforms
(``data/dwt.py``).

``decode_codestream(data)`` returns the image OpenJPEG hands its callers
(cv2 among them): the reference grid's extent and, for each component,
its sampling, precision, signedness and samples (int64, clamped to the
component's range).

What is read: SIZ (image and tile offsets, component subsampling, 1-38
bit precisions, signed or not), COD/COC (every progression order, layers,
the reversible component transform, 1-33 resolutions, code-blocks from
4x4 to 1024 samples, precincts, SOP and EPH, every code-block style but
HT), QCD/QCC (none, scalar derived and expounded, guard bits), RGN (ROI
max-shift), POC in the main and tile-part headers, COM, CRG, TLM, PLM and
PLT (skipped), several tile-parts a tile, in any order, and EOC.

Refused by name with ``NotImplementedError``: packed packet headers (PPM,
PPT), HTJ2K's HT code-blocks (its CAP and CPF markers alone are read past,
as OpenJPEG reads them) and Part 2's multi-component and wavelet markers.
A file OpenJPEG refuses raises ``ValueError``: a marker out of its place, a
tile-part cut short or out of order, a segment longer than its packet, a
missing EPH, fewer than two bytes after the last tile-part (OpenJPEG
accepts two bytes other than EOC at the very end, and stops reading once
every tile has all its tile-parts).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import dwt, ebcot

SOT, SOD, EOC = 0xFF90, 0xFF93, 0xFFD9
SIGNATURE = b"\xff\x4f\xff\x51"
# where OpenJPEG takes each marker it knows: "M" the main header, "T" a
# tile-part header (its ``j2k_memory_marker_handler_tab``); a marker found
# elsewhere is refused, and one it does not know is skipped
_PLACES = {0xFF52: "MT", 0xFF53: "MT", 0xFF5E: "MT", 0xFF5C: "MT", 0xFF5D: "MT", 0xFF5F: "MT",
           0xFF51: "", 0xFF55: "M", 0xFF57: "M", 0xFF58: "T", 0xFF60: "M", 0xFF61: "T",
           0xFF91: "", 0xFF63: "M", 0xFF64: "MT", 0xFF74: "MT", 0xFF78: "M", 0xFF50: "M",
           0xFF59: "M", 0xFF75: "MT", 0xFF77: "MT", SOT: "M"}
_REFUSED = {0xFF60: "PPM (packed packet headers in the main header)",
            0xFF61: "PPT (packed packet headers in a tile-part header)",
            0xFF74: "MCT (Part 2 multi-component transform)",
            0xFF75: "MCC (Part 2 multi-component collection)",
            0xFF77: "MCO (Part 2 multi-component ordering)",
            0xFF78: "CBD (Part 2 component bit depth)",
            0xFF76: "NLT (Part 2 non-linearity)", 0xFF79: "ADS (Part 2 arbitrary decomposition)",
            0xFF7A: "DFS (Part 2 arbitrary decomposition)", 0xFF7B: "ATK (Part 2 wavelet kernel)"}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Coding:
    """One component's coding style (COD/COC) and quantisation (QCD/QCC)."""

    __slots__ = ("levels", "xcb", "ycb", "style", "reversible", "precincts", "qstyle", "guard",
                 "steps", "roishift")

    def copy(self) -> "Coding":
        c = Coding()
        for k in self.__slots__:
            setattr(c, k, list(getattr(self, k)) if isinstance(getattr(self, k), list)
                    else getattr(self, k))
        return c


class TileCoding:
    """A tile's (or the main header's default) COD fields and components."""

    def __init__(self, ncomp: int):
        self.csty = 0
        self.progression = 0
        self.layers = 1
        self.mct = 0
        self.comps: List[Coding] = []
        for _ in range(ncomp):
            c = Coding()
            c.levels, c.xcb, c.ycb, c.style, c.reversible = 5, 6, 6, 0, True
            c.precincts = [(15, 15)] * 6
            c.qstyle, c.guard, c.steps, c.roishift = 0, 2, [(0, 0)] * 97, 0
            self.comps.append(c)
        self.pocs: List[tuple] = []

    def copy(self) -> "TileCoding":
        """A tile's coding, from the main header's: a tile-part's POC
        entries follow the main header's, as OpenJPEG appends them."""
        t = TileCoding(0)
        t.csty, t.progression, t.layers, t.mct = self.csty, self.progression, self.layers, self.mct
        t.comps = [c.copy() for c in self.comps]
        t.pocs = list(self.pocs)
        return t


class _Image:
    def __init__(self):
        self.x0 = self.y0 = self.x1 = self.y1 = 0
        self.tx0 = self.ty0 = self.tdx = self.tdy = 0
        self.comps: List[Tuple[int, int, int, bool]] = []  # (dx, dy, prec, signed)


def _body(data: bytes, at: int, name: str) -> Tuple[int, bytes, int]:
    """The marker segment at ``at`` -> (marker, body, offset after it)."""
    if at + 4 > len(data):
        raise ValueError(f"{name}: JPEG 2000 codestream cut inside its headers")
    marker, length = struct.unpack_from(">HH", data, at)
    if marker >> 8 != 0xFF:
        raise ValueError(f"{name}: JPEG 2000 codestream: expected a marker at byte {at}, "
                         f"found 0x{marker:04x}")
    if length < 2 or at + 2 + length > len(data):
        raise ValueError(f"{name}: JPEG 2000 marker 0x{marker:04x} runs past the end")
    return marker, data[at + 4:at + 2 + length], at + 2 + length


def _siz(body: bytes, name: str) -> _Image:
    if len(body) < 36:
        raise ValueError(f"{name}: bad SIZ marker")
    x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc = struct.unpack_from(">IIIIIIIIH", body, 2)
    if len(body) < 36 + 3 * nc or nc == 0 or nc > 16384:
        raise ValueError(f"{name}: bad SIZ marker ({nc} components)")
    if not (x0 < x1 and y0 < y1 and tdx and tdy and tx0 <= x0 and ty0 <= y0
            and tx0 + tdx > x0 and ty0 + tdy > y0):
        raise ValueError(f"{name}: JPEG 2000 image or tile extent is inconsistent")
    if _ceil_div(x1 - tx0, tdx) * _ceil_div(y1 - ty0, tdy) > 65535:
        raise ValueError(f"{name}: more than 65535 JPEG 2000 tiles")
    img = _Image()
    img.x0, img.y0, img.x1, img.y1 = x0, y0, x1, y1
    img.tx0, img.ty0, img.tdx, img.tdy = tx0, ty0, tdx, tdy
    for c in range(nc):
        ssiz, dx, dy = body[36 + 3 * c:39 + 3 * c]
        prec = (ssiz & 0x7F) + 1
        if prec > 31:
            raise ValueError(f"{name}: component {c} of {prec} bits (OpenJPEG reads up to 31)")
        if not dx or not dy:
            raise ValueError(f"{name}: component {c} with a zero sampling step")
        img.comps.append((dx, dy, prec, bool(ssiz & 0x80)))
    return img


def _sp_cod(body: bytes, at: int, c: Coding, precincts: bool, name: str) -> None:
    if at + 5 > len(body):
        raise ValueError(f"{name}: bad COD/COC marker")
    levels, xcb, ycb, style, transform = body[at:at + 5]
    if levels > 32:
        raise ValueError(f"{name}: {levels} decomposition levels (at most 32)")
    xcb, ycb = xcb + 2, ycb + 2
    if xcb > 10 or ycb > 10 or xcb + ycb > 12:
        raise ValueError(f"{name}: code-blocks of 2^{xcb} x 2^{ycb}")
    if style & 0x80 or transform > 1:  # OpenJPEG refuses mixed HT and other wavelets
        raise ValueError(f"{name}: code-block style {style} or wavelet {transform}")
    if style & ebcot.HT:
        raise NotImplementedError(f"{name}: HT code-blocks (HTJ2K, Part 15)")
    c.levels, c.xcb, c.ycb, c.style, c.reversible = levels, xcb, ycb, style, transform == 1
    if precincts:
        if at + 5 + levels + 1 > len(body):
            raise ValueError(f"{name}: bad precinct sizes")
        sizes = body[at + 5:at + 6 + levels]
        c.precincts = [(s & 15, s >> 4) for s in sizes]
        if any((pw == 0 or ph == 0) and r > 0 for r, (pw, ph) in enumerate(c.precincts)):
            raise ValueError(f"{name}: a precinct of size 1 at a resolution above the lowest")
    else:
        c.precincts = [(15, 15)] * (levels + 1)


def _sq(body: bytes, at: int, c: Coding, name: str) -> None:
    if at >= len(body):
        raise ValueError(f"{name}: bad QCD/QCC marker")
    sq = body[at]
    c.qstyle, c.guard = sq & 31, sq >> 5
    rest = body[at + 1:]
    if c.qstyle == 0:
        steps = [(b >> 3, 0) for b in rest]
    else:  # OpenJPEG reads any other style as expounded steps
        if len(rest) % 2 or not rest or (c.qstyle == 1 and len(rest) != 2):
            raise ValueError(f"{name}: bad QCD/QCC marker")
        vals = [struct.unpack_from(">H", rest, 2 * i)[0] for i in range(len(rest) // 2)]
        steps = [(v >> 11, v & 0x7FF) for v in vals]
        if c.qstyle == 1:
            e0, m0 = steps[0]
            steps = [steps[0]] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, 97)]
    c.steps = (steps + [(0, 0)] * 97)[:97]


class _Codestream:
    """The main header, then each tile's coding and its tile-parts' data."""

    def __init__(self, data: bytes, name: str):
        self.name = name
        if not data.startswith(SIGNATURE):
            raise ValueError(f"{name}: not a JPEG 2000 codestream")
        marker, body, at = _body(data, 2, name)
        self.image = img = _siz(body, name)
        self.ncomp = len(img.comps)
        self.ntx = _ceil_div(img.x1 - img.tx0, img.tdx)
        self.nty = _ceil_div(img.y1 - img.ty0, img.tdy)
        self.default = TileCoding(self.ncomp)
        self.tiles: Dict[int, TileCoding] = {}
        self.parts: Dict[int, List[bytes]] = {}
        seen_cod = seen_qcd = False
        while True:
            at = self._known_marker(data, at, "M")
            if struct.unpack_from(">H", data, at)[0] == SOT:
                break
            marker, body, at = _body(data, at, name)
            seen_cod |= marker == 0xFF52
            seen_qcd |= marker == 0xFF5C
            self._marker(marker, body, self.default)
        if not seen_cod or not seen_qcd:
            raise ValueError(f"{name}: JPEG 2000 main header without "
                             f"{'COD' if not seen_cod else 'QCD'}")
        self._tile_parts(data, at)

    def _known_marker(self, data: bytes, at: int, place: str) -> int:
        """The offset of the next marker OpenJPEG reads at ``at``: one it
        does not know is passed over as its ``opj_j2k_read_unk`` does, two
        bytes at a time up to a marker it knows; a known marker out of its
        place is refused."""
        marker = struct.unpack_from(">H", data, at)[0] if at + 2 <= len(data) else None
        if marker is None:
            raise ValueError(f"{self.name}: JPEG 2000 codestream cut inside its headers")
        if marker < 0xFF00:
            raise ValueError(f"{self.name}: JPEG 2000: a marker expected at byte {at}, found "
                             f"0x{marker:04x}")
        while marker not in _PLACES:
            at += 2
            if at + 2 > len(data):
                raise ValueError(f"{self.name}: JPEG 2000 codestream cut after an unknown marker")
            marker = struct.unpack_from(">H", data, at)[0]
        if place not in _PLACES[marker]:
            raise ValueError(f"{self.name}: JPEG 2000 marker 0x{marker:04x} out of its place")
        return at

    def _comp(self, body: bytes) -> Tuple[int, int]:
        if self.ncomp < 257:
            return body[0], 1
        return struct.unpack_from(">H", body)[0], 2

    def _marker(self, marker: int, body: bytes, t: TileCoding) -> None:
        name = self.name
        if marker in _REFUSED:
            raise NotImplementedError(f"{name}: JPEG 2000 marker {_REFUSED[marker]}")
        if marker == 0xFF52:  # COD
            if len(body) < 5:
                raise ValueError(f"{name}: bad COD marker")
            t.csty, t.progression = body[0], body[1]
            t.layers, t.mct = struct.unpack_from(">HB", body, 2)
            if t.csty & ~7 or t.progression > 4 or t.layers == 0 or t.mct > 1:
                raise ValueError(f"{name}: bad COD marker (Scod {t.csty}, progression "
                                 f"{t.progression}, {t.layers} layers, MCT {t.mct})")
            c0 = t.comps[0]
            _sp_cod(body, 5, c0, bool(t.csty & 1), name)
            for c in t.comps[1:]:
                c.levels, c.xcb, c.ycb, c.style, c.reversible = (
                    c0.levels, c0.xcb, c0.ycb, c0.style, c0.reversible)
                c.precincts = list(c0.precincts)
        elif marker == 0xFF53:  # COC
            comp, n = self._comp(body)
            if comp >= self.ncomp or len(body) < n + 1:
                raise ValueError(f"{name}: bad COC marker")
            _sp_cod(body, n + 1, t.comps[comp], bool(body[n] & 1), name)
        elif marker == 0xFF5C:  # QCD
            c0 = t.comps[0]
            _sq(body, 0, c0, name)
            for c in t.comps[1:]:
                c.qstyle, c.guard, c.steps = c0.qstyle, c0.guard, list(c0.steps)
        elif marker == 0xFF5D:  # QCC
            comp, n = self._comp(body)
            if comp >= self.ncomp:
                raise ValueError(f"{name}: bad QCC marker")
            _sq(body, n, t.comps[comp], name)
        elif marker == 0xFF5E:  # RGN
            comp, n = self._comp(body)
            if comp >= self.ncomp or len(body) < n + 2 or body[n] != 0:
                raise ValueError(f"{name}: bad RGN marker")
            t.comps[comp].roishift = body[n + 1]
        elif marker == 0xFF5F:  # POC
            n = 2 if self.ncomp >= 257 else 1
            size = 5 + 2 * n
            if len(body) < size or len(body) % size:
                raise ValueError(f"{name}: bad POC marker")
            for i in range(len(body) // size):
                e = body[i * size:(i + 1) * size]
                rs = e[0]
                cs = e[1] if n == 1 else struct.unpack_from(">H", e, 1)[0]
                le = struct.unpack_from(">H", e, 1 + n)[0]
                re = e[3 + n]
                ce = e[4 + n] if n == 1 else struct.unpack_from(">H", e, 4 + n)[0]
                pr = e[4 + 2 * n]
                if pr > 4:
                    raise ValueError(f"{name}: bad POC progression {pr}")
                t.pocs.append((rs, cs, le, re, min(ce if ce else 256 * n, self.ncomp), pr))
        elif marker in (0xFF55, 0xFF57, 0xFF58):  # TLM, PLM, PLT: lengths, not needed
            if len(body) < 1:
                raise ValueError(f"{name}: bad pointer marker 0x{marker:04x}")
        # COM and CRG are read past

    def _tile_parts(self, data: bytes, at: int) -> None:
        name = self.name
        n_tiles = self.ntx * self.nty
        self.counts: Dict[int, int] = {}  # tile -> its tile-parts, where TNsot gives them
        while True:
            marker = struct.unpack_from(">H", data, at)[0]
            if marker == EOC:
                break
            if marker != SOT:
                raise ValueError(f"{name}: JPEG 2000: expected SOT or EOC at byte {at}, "
                                 f"found 0x{marker:04x}")
            start = at
            marker, body, at = _body(data, at, name)
            if len(body) != 8:
                raise ValueError(f"{name}: bad SOT marker")
            tile, psot, tpsot, tnsot = struct.unpack(">HIBB", body)
            if tile >= n_tiles:
                raise ValueError(f"{name}: tile {tile} of a codestream of {n_tiles} tiles")
            if 0 < psot < 14:
                raise ValueError(f"{name}: a tile-part of {psot} bytes")
            done = len(self.parts.get(tile, ()))
            if tpsot != done or (tnsot and tpsot >= tnsot):
                raise ValueError(f"{name}: tile {tile}'s tile-part {tpsot} of {tnsot} where "
                                 f"{done} came before")
            if psot and start + psot > len(data):
                raise ValueError(f"{name}: tile-part of {psot} bytes runs past the end "
                                 "(a cut file)")
            end = start + psot if psot else len(data) - 2
            first = tile not in self.tiles
            if first:
                self.tiles[tile] = self.default.copy()
                self.parts[tile] = []
            t = self.tiles[tile]
            while True:
                if at + 2 > end:
                    raise ValueError(f"{name}: tile-part header without SOD")
                marker = struct.unpack_from(">H", data, at)[0]
                if marker == SOD:
                    at += 2
                    break
                if marker in _PLACES and "T" not in _PLACES[marker]:
                    raise ValueError(f"{name}: JPEG 2000 marker 0x{marker:04x} out of its place")
                marker, body, at = _body(data, at, name)
                if at > end:
                    raise ValueError(f"{name}: tile-part header runs past its tile-part")
                if not first and marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E):
                    raise ValueError(f"{name}: marker 0x{marker:04x} in a tile-part after the "
                                     "first")
                self._marker(marker, body, t)
            self.parts[tile].append(data[at:end])
            if tnsot:
                self.counts[tile] = tnsot
            at = end
            # OpenJPEG reads two bytes after each tile-part: EOC ends the
            # codestream, SOT goes on unless every tile has all its parts,
            # anything else is refused unless it is the last two bytes
            if at + 2 > len(data):
                raise ValueError(f"{name}: JPEG 2000 codestream ends without EOC")
            marker = struct.unpack_from(">H", data, at)[0]
            if marker == SOT and len(self.counts) == n_tiles and all(
                    len(self.parts[k]) == n for k, n in self.counts.items()):
                break
            if marker != SOT and at + 2 == len(data):
                break


# ---------------------------------------------------------------- tier-2
class _Bits:
    """T.800 B.10.1: packet-header bits, a 0 bit stuffed after each 0xFF;
    past the end it reads zeros, as OpenJPEG's reader does."""

    __slots__ = ("data", "pos", "end", "buf", "ct")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end, self.buf, self.ct = data, pos, end, 0, 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if self.buf & 0xFF == 0xFF:
            self._bytein()
        self.ct = 0


class _TagTree:
    """T.800 B.10.2 as OpenJPEG's ``opj_tgt_decode`` reads it."""

    def __init__(self, w: int, h: int):
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = [[999] * (lw * lh) for lw, lh in self.levels]
        self.low = [[0] * (lw * lh) for lw, lh in self.levels]

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        w0 = self.levels[0][0]
        x, y = leaf % w0, leaf // w0
        path = []
        for k, (lw, _) in enumerate(self.levels):
            path.append((k, (y >> k) * lw + (x >> k)))
        low = 0
        for k, i in reversed(path):
            if low > self.low[k][i]:
                self.low[k][i] = low
            else:
                low = self.low[k][i]
            while low < threshold and low < self.value[k][i]:
                if bits.bit():
                    self.value[k][i] = low
                else:
                    low += 1
            self.low[k][i] = low
        k, i = path[0]
        return self.value[k][i] < threshold


class _Block:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs", "included")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.numlenbits = 0
        self.segs: List[list] = []  # [maxpasses, passes, [chunks]]
        self.included = False


class _Band:
    def __init__(self, orient, x0, y0, x1, y1, step, numbps):
        self.orient, self.x0, self.y0, self.x1, self.y1 = orient, x0, y0, x1, y1
        self.step, self.numbps = step, numbps  # the step size, Mb
        self.precincts: List[Tuple[int, int, List[_Block], _TagTree, _TagTree]] = []

    @property
    def empty(self) -> bool:
        return self.x1 == self.x0 or self.y1 == self.y0


class _Resolution:
    def __init__(self):
        self.x0 = self.y0 = self.x1 = self.y1 = 0
        self.pdx = self.pdy = 15
        self.pw = self.ph = 0
        self.bands: List[_Band] = []


class _TileComp:
    def __init__(self, tx0, ty0, tx1, ty1, dx, dy, prec, signed, coding: Coding):
        self.x0, self.y0 = _ceil_div(tx0, dx), _ceil_div(ty0, dy)
        self.x1, self.y1 = _ceil_div(tx1, dx), _ceil_div(ty1, dy)
        self.dx, self.dy, self.prec, self.signed, self.coding = dx, dy, prec, signed, coding
        nres = coding.levels + 1
        self.res: List[_Resolution] = []
        for r in range(nres):
            level = nres - 1 - r
            res = _Resolution()
            res.x0, res.y0 = _ceil_div(self.x0, 1 << level), _ceil_div(self.y0, 1 << level)
            res.x1, res.y1 = _ceil_div(self.x1, 1 << level), _ceil_div(self.y1, 1 << level)
            res.pdx, res.pdy = coding.precincts[r] if r < len(coding.precincts) else (15, 15)
            px0 = (res.x0 >> res.pdx) << res.pdx
            py0 = (res.y0 >> res.pdy) << res.pdy
            px1 = _ceil_div(res.x1, 1 << res.pdx) << res.pdx
            py1 = _ceil_div(res.y1, 1 << res.pdy) << res.pdy
            res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> res.pdx
            res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> res.pdy
            if r == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, res.pdx, res.pdy
                orients = [0]
            else:
                cbgx0, cbgy0 = _ceil_div(px0, 2), _ceil_div(py0, 2)
                cbgw, cbgh = res.pdx - 1, res.pdy - 1
                orients = [1, 2, 3]
            cbw, cbh = min(coding.xcb, cbgw), min(coding.ycb, cbgh)
            for orient in orients:
                if r == 0:
                    bx0, by0, bx1, by1 = res.x0, res.y0, res.x1, res.y1
                    step_index = 0
                else:
                    xo, yo = orient & 1, orient >> 1
                    d = 1 << (level + 1)
                    bx0 = _ceil_div(self.x0 - (xo << level), d)
                    by0 = _ceil_div(self.y0 - (yo << level), d)
                    bx1 = _ceil_div(self.x1 - (xo << level), d)
                    by1 = _ceil_div(self.y1 - (yo << level), d)
                    step_index = 3 * (r - 1) + orient
                expn, mant = coding.steps[step_index]
                numbps = expn + coding.guard - 1
                if coding.reversible:
                    step = 1.0
                else:
                    step = float(np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn)))
                band = _Band(orient, bx0, by0, bx1, by1, step, numbps)
                for pno in range(res.pw * res.ph):
                    gx0 = cbgx0 + (pno % res.pw) * (1 << cbgw)
                    gy0 = cbgy0 + (pno // res.pw) * (1 << cbgh)
                    qx0, qy0 = max(gx0, bx0), max(gy0, by0)
                    qx1, qy1 = min(gx0 + (1 << cbgw), bx1), min(gy0 + (1 << cbgh), by1)
                    bxs = (qx0 >> cbw) << cbw
                    bys = (qy0 >> cbh) << cbh
                    cw = max(0, (_ceil_div(qx1, 1 << cbw) << cbw) - bxs) >> cbw
                    ch = max(0, (_ceil_div(qy1, 1 << cbh) << cbh) - bys) >> cbh
                    blocks = []
                    for b in range(cw * ch):
                        x = bxs + (b % cw) * (1 << cbw)
                        y = bys + (b // cw) * (1 << cbh)
                        blocks.append(_Block(max(x, qx0), max(y, qy0), min(x + (1 << cbw), qx1),
                                             min(y + (1 << cbh), qy1)))
                    band.precincts.append((cw, ch, blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
                res.bands.append(band)
            self.res.append(res)


def _packets(t: TileCoding, comps: List[_TileComp], tx0, ty0, tx1, ty1,
             name: str) -> Iterator[Tuple[int, int, int, int]]:
    """(layer, resolution, component, precinct) in the order OpenJPEG's
    packet iterator gives them, POC entries in turn, each packet once."""
    done = set()
    max_res = max(len(c.res) for c in comps)
    if t.pocs:
        entries = [(rs, cs, min(le, t.layers), re, ce, pr) for rs, cs, le, re, ce, pr in t.pocs]
    else:
        entries = [(0, 0, t.layers, max_res, len(comps), t.progression)]
    for rs, cs, le, re, ce, pr in entries:
        if cs >= len(comps) or ce > len(comps):
            raise ValueError(f"{name}: POC components {cs}-{ce} of {len(comps)}")
        for key in _order(pr, rs, cs, le, re, ce, comps, tx0, ty0, tx1, ty1):
            if key not in done:
                done.add(key)
                yield key


def _order(pr, rs, cs, le, re, ce, comps, tx0, ty0, tx1, ty1):
    if pr == 0:  # LRCP
        for l in range(le):
            for r in range(rs, re):
                for c in range(cs, ce):
                    if r < len(comps[c].res):
                        res = comps[c].res[r]
                        for p in range(res.pw * res.ph):
                            yield l, r, c, p
    elif pr == 1:  # RLCP
        for r in range(rs, re):
            for l in range(le):
                for c in range(cs, ce):
                    if r < len(comps[c].res):
                        res = comps[c].res[r]
                        for p in range(res.pw * res.ph):
                            yield l, r, c, p
    elif pr in (2, 3):  # RPCL, PCRL
        dx, dy = _steps(comps, range(len(comps)))
        if pr == 2:
            for r in range(rs, re):
                for y in _positions(ty0, ty1, dy):
                    for x in _positions(tx0, tx1, dx):
                        for c in range(cs, ce):
                            p = _precinct_at(comps[c], r, x, y, tx0, ty0, tx1, ty1)
                            if p is not None:
                                for l in range(le):
                                    yield l, r, c, p
        else:
            for y in _positions(ty0, ty1, dy):
                for x in _positions(tx0, tx1, dx):
                    for c in range(cs, ce):
                        for r in range(rs, min(re, len(comps[c].res))):
                            p = _precinct_at(comps[c], r, x, y, tx0, ty0, tx1, ty1)
                            if p is not None:
                                for l in range(le):
                                    yield l, r, c, p
    else:  # CPRL
        for c in range(cs, ce):
            dx, dy = _steps(comps, [c])
            for y in _positions(ty0, ty1, dy):
                for x in _positions(tx0, tx1, dx):
                    for r in range(rs, min(re, len(comps[c].res))):
                        p = _precinct_at(comps[c], r, x, y, tx0, ty0, tx1, ty1)
                        if p is not None:
                            for l in range(le):
                                yield l, r, c, p


def _steps(comps, which) -> Tuple[int, int]:
    dx = dy = 0
    for c in which:
        comp = comps[c]
        n = len(comp.res)
        for r, res in enumerate(comp.res):
            sx = comp.dx << (res.pdx + n - 1 - r)
            sy = comp.dy << (res.pdy + n - 1 - r)
            dx = sx if not dx else min(dx, sx)
            dy = sy if not dy else min(dy, sy)
    return dx, dy


def _positions(a: int, b: int, step: int) -> Iterator[int]:
    v = a
    while v < b:
        yield v
        v += step - v % step


def _precinct_at(comp: _TileComp, r: int, x: int, y: int, tx0, ty0, tx1, ty1) -> Optional[int]:
    """OpenJPEG's test of whether the grid point (x, y) starts a precinct
    of resolution r, and that precinct's number."""
    if r >= len(comp.res):
        return None
    res = comp.res[r]
    level = len(comp.res) - 1 - r
    rx0 = _ceil_div(tx0, comp.dx << level)
    ry0 = _ceil_div(ty0, comp.dy << level)
    rx1 = _ceil_div(tx1, comp.dx << level)
    ry1 = _ceil_div(ty1, comp.dy << level)
    rpx, rpy = res.pdx + level, res.pdy + level
    if not (y % (comp.dy << rpy) == 0 or (y == ty0 and (ry0 << level) % (1 << rpy))):
        return None
    if not (x % (comp.dx << rpx) == 0 or (x == tx0 and (rx0 << level) % (1 << rpx))):
        return None
    if res.pw == 0 or res.ph == 0 or rx0 == rx1 or ry0 == ry1:
        return None
    pi = (_ceil_div(x, comp.dx << level) >> res.pdx) - (rx0 >> res.pdx)
    pj = (_ceil_div(y, comp.dy << level) >> res.pdy) - (ry0 >> res.pdy)
    return pi + pj * res.pw


def _passes(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


def _new_segment(block: _Block, style: int) -> None:
    if style & ebcot.TERMALL:
        maxpasses = 1
    elif style & ebcot.BYPASS:
        if not block.segs:
            maxpasses = 10
        else:
            maxpasses = 2 if block.segs[-1][0] in (1, 10) else 1
    else:
        maxpasses = 109
    block.segs.append([maxpasses, 0, []])


def _read_packet(data: bytes, at: int, end: int, t: TileCoding, comp: _TileComp, r: int,
                 p: int, layer: int, name: str) -> int:
    """One packet's header and body; returns the offset after it."""
    style = comp.coding.style
    if t.csty & 2 and at + 6 <= end and data[at] == 0xFF and data[at + 1] == 0x91:
        at += 6
    bits = _Bits(data, at, end)
    res = comp.res[r]
    new: List[Tuple[_Block, List[Tuple[int, int]]]] = []
    if bits.bit():
        for band in res.bands:
            if band.empty:
                continue
            cw, ch, blocks, incl, imsb = band.precincts[p]
            for i, block in enumerate(blocks):
                if not block.included:
                    included = incl.decode(bits, i, layer + 1)
                else:
                    included = bits.bit()
                if not included:
                    continue
                if not block.included:
                    zbp = 0
                    while not imsb.decode(bits, i, zbp):
                        zbp += 1
                    block.numbps = band.numbps + 1 - zbp
                    block.numlenbits = 3
                n = _passes(bits)
                while bits.bit():
                    block.numlenbits += 1
                if not block.segs or block.segs[-1][1] == block.segs[-1][0]:
                    _new_segment(block, style)
                k = len(block.segs) - 1
                pieces = []
                pending = [s[1] for s in block.segs]
                while True:
                    take = min(block.segs[k][0] - pending[k], n)
                    nbits = block.numlenbits + take.bit_length() - 1
                    if nbits > 32:
                        raise ValueError(f"{name}: a code-block length of {nbits} bits")
                    pieces.append((k, take, bits.bits(nbits)))
                    pending[k] += take
                    n -= take
                    if n <= 0:
                        break
                    _new_segment(block, style)
                    pending.append(0)
                    k += 1
                block.included = True
                new.append((block, pieces))
        bits.align()
        at = bits.pos
    else:
        bits.align()
        at = bits.pos
    if t.csty & 4:
        if at + 2 > end or data[at] != 0xFF or data[at + 1] != 0x92:
            raise ValueError(f"{name}: a packet header without its EPH marker")
        at += 2
    for block, pieces in new:
        for k, take, length in pieces:
            if at + length > end:
                raise ValueError(f"{name}: a code-block segment runs past its tile-part data "
                                 "(a cut file)")
            seg = block.segs[k]
            seg[1] += take
            seg[2].append(data[at:at + length])
            at += length
    return at


def _decode_tile(cs: _Codestream, tile: int) -> List[Tuple[int, int, np.ndarray]]:
    """A tile -> for each component (x offset, y offset in the component,
    samples)."""
    img, t, name = cs.image, cs.tiles[tile], cs.name
    p, q = tile % cs.ntx, tile // cs.ntx
    tx0 = max(img.tx0 + p * img.tdx, img.x0)
    ty0 = max(img.ty0 + q * img.tdy, img.y0)
    tx1 = min(img.tx0 + (p + 1) * img.tdx, img.x1)
    ty1 = min(img.ty0 + (q + 1) * img.tdy, img.y1)
    comps = [_TileComp(tx0, ty0, tx1, ty1, dx, dy, prec, signed, t.comps[c])
             for c, (dx, dy, prec, signed) in enumerate(img.comps)]
    data = b"".join(cs.parts[tile])
    at, end = 0, len(data)
    for layer, r, c, pno in _packets(t, comps, tx0, ty0, tx1, ty1, name):
        at = _read_packet(data, at, end, t, comps[c], r, pno, layer, name)
    planes = []
    for comp in comps:
        planes.append(_component(comp, name))
    if t.mct:
        if len(comps) < 3:
            pass  # OpenJPEG warns and skips the transform
        elif len({(c.x1 - c.x0, c.y1 - c.y0, len(c.res)) for c in comps[:3]}) > 1:
            raise ValueError(f"{name}: a component transform over components of different sizes")
        elif len({c.coding.reversible for c in comps[:3]}) > 1:
            raise NotImplementedError(f"{name}: a component transform over components of "
                                      "different wavelets")
        elif comps[0].coding.reversible:
            planes[0], planes[1], planes[2] = dwt.inverse_rct(*planes[:3])
        else:
            planes[0], planes[1], planes[2] = dwt.inverse_ict(*planes[:3])
    out = []
    for comp, plane in zip(comps, planes):
        if comp.signed:
            lo, hi, shift = -(1 << (comp.prec - 1)), (1 << (comp.prec - 1)) - 1, 0
        else:
            lo, hi, shift = 0, (1 << comp.prec) - 1, 1 << (comp.prec - 1)
        if plane.dtype == np.float32:
            big = plane > np.float32(2 ** 31 - 1)
            small = plane < -2.0 ** 31
            v = np.rint(np.where(big | small, 0, plane)).astype(np.int64) + shift
            v = np.where(big, hi, np.where(small, lo, v))
        else:
            v = plane + shift
        out.append((comp.x0, comp.y0, np.clip(v, lo, hi)))
    return out


def _component(comp: _TileComp, name: str) -> np.ndarray:
    """Tier-1 of every code-block, dequantised into the tile-component,
    then the inverse wavelet transform."""
    coding = comp.coding
    w, h = comp.x1 - comp.x0, comp.y1 - comp.y0
    a = np.zeros((h, w), np.int64 if coding.reversible else np.float32)
    for r, res in enumerate(comp.res):
        for band in res.bands:
            if band.empty:
                continue
            ox = oy = 0
            if r:
                prev = comp.res[r - 1]
                ox = prev.x1 - prev.x0 if band.orient & 1 else 0
                oy = prev.y1 - prev.y0 if band.orient & 2 else 0
            half_step = np.float32(0.5) * np.float32(band.step)
            for _, _, blocks, _, _ in band.precincts:
                for block in blocks:
                    if not block.segs:
                        continue
                    segs = [(b"".join(s[2]), s[1]) for s in block.segs]
                    v = ebcot.decode_block(segs, block.x1 - block.x0, block.y1 - block.y0,
                                           band.orient, block.numbps, coding.roishift,
                                           coding.style, name)
                    y, x = block.y0 - band.y0 + oy, block.x0 - band.x0 + ox
                    if coding.reversible:
                        v = np.sign(v) * (np.abs(v) >> 1)
                    else:
                        v = v.astype(np.float32) * half_step
                    a[y:y + v.shape[0], x:x + v.shape[1]] = v
    levels = []
    for r in range(1, len(comp.res)):
        res, prev = comp.res[r], comp.res[r - 1]
        levels.append((res.x1 - res.x0, res.y1 - res.y0, prev.x1 - prev.x0, prev.y1 - prev.y0,
                       res.x0 % 2, res.y0 % 2))
    return (dwt.idwt53 if coding.reversible else dwt.idwt97)(a, levels)


class Decoded:
    """The image as OpenJPEG leaves it: the grid's extent and, for each
    component, (dx, dy, precision, signed, samples (h, w) int64)."""

    def __init__(self, x0, y0, x1, y1, comps):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.comps = comps


def read_header(data: bytes, name: str = "<bytes>") -> _Image:
    """The SIZ marker's image (extent and components), for header checks."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a JPEG 2000 codestream")
    return _siz(_body(data, 2, name)[1], name)


def decode_codestream(data: bytes, name: str = "<bytes>") -> Decoded:
    cs = _Codestream(bytes(data), name)
    img = cs.image
    planes = []
    for dx, dy, prec, signed in img.comps:
        w = _ceil_div(img.x1, dx) - _ceil_div(img.x0, dx)
        h = _ceil_div(img.y1, dy) - _ceil_div(img.y0, dy)
        planes.append(np.zeros((h, w), np.int64))
    for tile in sorted(cs.tiles):
        for c, (x0, y0, v) in enumerate(_decode_tile(cs, tile)):
            dx, dy = img.comps[c][:2]
            cx0, cy0 = _ceil_div(img.x0, dx), _ceil_div(img.y0, dy)
            planes[c][y0 - cy0:y0 - cy0 + v.shape[0], x0 - cx0:x0 - cx0 + v.shape[1]] = v
    return Decoded(img.x0, img.y0, img.x1, img.y1,
                   [(dx, dy, prec, signed, planes[c])
                    for c, (dx, dy, prec, signed) in enumerate(img.comps)])

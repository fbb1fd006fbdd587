"""JPEG 2000 tier-1 (ITU-T T.800 Annex C and D): the MQ decoder and the
three coding passes of a code-block, as OpenJPEG 2.5 decodes them.

``decode_block`` takes a code-block's codeword segments (their bytes and
pass counts, from tier-2) and returns its coefficients in OpenJPEG's
representation: sign and magnitude with one extra low bit, the magnitude
set to the middle of the interval the decoded bits leave (``oneplushalf``
when a coefficient becomes significant, then ``+-half`` at each
refinement). ``data/j2k.py`` turns them into subband samples (halved for
the 5/3 wavelet, times half the step size for the 9/7).

The typed tables (the MQ coder's 47 states, and the zero-coding and
sign-coding context tables in OpenJPEG's neighbourhood layout) are checked
against libopenjp2 by ``scripts/check_mq_tables.py``.

Each coefficient's state lives in flat lists over the block padded by one
on every side: ``nbr`` holds a bit for each significant neighbour (the
3x3 layout OpenJPEG's context tables index: 0 NW, 1 N, 2 NE, 3 W, 5 E,
6 SW, 7 S, 8 SE), ``sgn`` the signs of the four direct neighbours that are
significant and negative (bits 0 W, 2 E, 4 N, 6 S, as OpenJPEG's sign
table indexes them), ``st`` whether the coefficient is significant (1) or
has been refined (4), and ``vis`` the bit-plane in which the significance
pass last visited it. The vertically causal style (VSC) is kept as
OpenJPEG keeps it: a coefficient on the first row of a stripe does not
tell the row above it that it became significant.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# T.800 Table C.2: Qe, next state after an MPS, after an LPS, and whether
# an LPS switches the MPS sense
MQ_STATES = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
_QE = [s[0] for s in MQ_STATES]
_NMPS = [s[1] for s in MQ_STATES]
_NLPS = [s[2] for s in MQ_STATES]
_SWITCH = [s[3] for s in MQ_STATES]

# contexts: 0-8 zero coding, 9-13 sign coding, 14-16 magnitude refinement,
# 17 run-length (aggregation), 18 uniform
CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 9, 14, 17, 18
N_CONTEXTS = 19

# code-block styles (COD/COC SPcod/SPcoc, T.800 Table A.19)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
HT = 64


def _zc(f: int, orient: int) -> int:
    """T.800 Table D.1: the zero-coding context of a neighbourhood ``f``
    (3x3 bits, centre excluded) in a subband of OpenJPEG's orientation
    (0 LL, 1 HL: horizontally high-pass, 2 LH, 3 HH)."""
    h = (f >> 3 & 1) + (f >> 5 & 1)
    v = (f >> 1 & 1) + (f >> 7 & 1)
    d = (f & 1) + (f >> 2 & 1) + (f >> 6 & 1) + (f >> 8 & 1)
    if orient == 1:  # HL: the table with H and V exchanged
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d == 0:
            return min(hv, 2)
        if d == 1:
            return 3 + min(hv, 2)
        if d == 2:
            return 6 + min(hv, 1)
        return 8
    if h == 0:
        if v == 0:
            return min(d, 2)
        return 2 + min(v, 2)
    if h == 1:
        if v == 0:
            return 5 + min(d, 1)
        return 7
    return 8


def _sc(lu: int) -> Tuple[int, int]:
    """T.800 Tables D.2 and D.3: (sign context, sign prediction bit) of
    the four direct neighbours in OpenJPEG's layout (bits 0 W negative,
    1 N significant, 2 E negative, 3 W significant, 4 N negative, 5 E
    significant, 6 S negative, 7 S significant)."""
    def contribution(sig, neg):
        return (1 if sig and not neg else 0), (1 if sig and neg else 0)

    e, w = contribution(lu >> 5 & 1, lu >> 2 & 1), contribution(lu >> 3 & 1, lu & 1)
    n, s = contribution(lu >> 1 & 1, lu >> 4 & 1), contribution(lu >> 7 & 1, lu >> 6 & 1)
    hc = min(e[0] + w[0], 1) - min(e[1] + w[1], 1)
    vc = min(n[0] + s[0], 1) - min(n[1] + s[1], 1)
    spb = 0 if hc == 0 and vc == 0 else int(not (hc > 0 or (hc == 0 and vc > 0)))
    if hc < 0:
        hc, vc = -hc, -vc
    ctx = (0 if vc == 0 else 1) if hc == 0 else 3 + vc
    return CTX_SC + ctx, spb


#: zero-coding context by orientation * 512 + the 3x3 significance bits
ZC_TABLE = bytes(_zc(i & ~16, o) for o in range(4) for i in range(512))
SC_TABLE = bytes(_sc(lu)[0] for lu in range(256))
SPB_TABLE = bytes(_sc(lu)[1] for lu in range(256))
_ZC = [list(ZC_TABLE[o * 512:(o + 1) * 512]) for o in range(4)]
_SC = list(SC_TABLE)
_SPB = list(SPB_TABLE)


def _reset(index: List[int], mps: List[int]) -> None:
    for k in range(N_CONTEXTS):
        index[k], mps[k] = 0, 0
    index[CTX_UNI], index[CTX_AGG], index[0] = 46, 3, 4


_SCANS: dict = {}


def _scan(w: int, h: int):
    """The stripe scan of a w x h block over the padded grid: for each
    stripe, (number of rows, [index of the stripe's top row in each
    column])."""
    key = (w, h)
    if key not in _SCANS:
        w2 = w + 2
        _SCANS[key] = [(min(4, h - y0), [(y0 + 1) * w2 + x + 1 for x in range(w)])
                       for y0 in range(0, h, 4)]
    return _SCANS[key]


def decode_block(segments: Sequence[Tuple[bytes, int]], w: int, h: int, orient: int,
                 numbps: int, roishift: int, style: int, name: str = "") -> np.ndarray:
    """One code-block's coefficients (OpenJPEG's doubled sign-magnitude
    ints, (h, w) int64) from its segments ``[(bytes, passes), ...]``.

    ``numbps`` is the block's number of magnitude bit-planes (the band's
    Mb less the zero bit-planes tier-2 read), ``roishift`` the RGN
    max-shift, ``style`` the code-block style bits."""
    if roishift + numbps >= 31:
        raise ValueError(f"{name}: a code-block of {roishift + numbps} bit-planes (OpenJPEG "
                         "decodes fewer than 31)")
    w2 = w + 2
    size = w2 * (h + 2)
    nbr = [0] * size
    sgn = [0] * size
    st = [0] * size
    vis = [-1] * size
    val = [0] * size
    zc = _ZC[orient]
    index, mps = [0] * N_CONTEXTS, [0] * N_CONTEXTS
    _reset(index, mps)
    # the MQ decoder (T.800 C.3) over one segment, its registers in this
    # frame's cells; OpenJPEG puts two 0xFF bytes after each segment, so the
    # decoder reads 1-bits past its end
    buf, bp, a, c, ct = b"", 0, 0, 0, 0
    qe_of, nmps_of, nlps_of, switch_of = _QE, _NMPS, _NLPS, _SWITCH

    def bytein():
        nonlocal bp, c, ct
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                c += 0xFF00
                ct = 8
            else:
                bp += 1
                c += buf[bp] << 9
                ct = 7
        else:
            bp += 1
            c += buf[bp] << 8
            ct = 8

    def start(data: bytes) -> None:
        nonlocal buf, bp, a, c, ct
        buf = bytes(data) + b"\xff\xff"
        bp, c = 0, buf[0] << 16
        bytein()
        c <<= 7
        ct -= 7
        a = 0x8000

    def start_raw(data: bytes) -> None:
        nonlocal buf, bp, c, ct
        buf = bytes(data) + b"\xff\xff"
        bp, c, ct = 0, 0, 0

    def decode(cx: int) -> int:
        nonlocal a, c, ct
        i = index[cx]
        qe = qe_of[i]
        a -= qe
        if (c >> 16) & 0xFFFF < qe:  # LPS exchange
            if a < qe:
                d = mps[cx]
                index[cx] = nmps_of[i]
            else:
                d = 1 - mps[cx]
                if switch_of[i]:
                    mps[cx] = d
                index[cx] = nlps_of[i]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                return mps[cx]
            if a < qe:  # MPS exchange
                d = 1 - mps[cx]
                if switch_of[i]:
                    mps[cx] = d
                index[cx] = nlps_of[i]
            else:
                d = mps[cx]
                index[cx] = nmps_of[i]
        while True:  # renormalise
            if ct == 0:
                bytein()
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a & 0x8000:
                return d

    def raw() -> int:  # the bypass reader (T.800 D.6): 7 bits after each 0xFF
        nonlocal bp, c, ct
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    c, ct = 0xFF, 8
                else:
                    c, bp, ct = buf[bp], bp + 1, 7
            else:
                c, bp, ct = buf[bp], bp + 1, 8
        ct -= 1
        return (c >> ct) & 1

    vsc = bool(style & VSC)
    scan = _scan(w, h)
    w2x2, w2x3 = 2 * w2, 3 * w2
    n_w, n_n, n_ne, n_nw = -1, -w2, -w2 + 1, -w2 - 1
    s_s, s_sw, s_se = w2, w2 - 1, w2 + 1

    def significant(p: int, neg: int, top: bool) -> None:
        st[p] |= 1
        nbr[p - 1] |= 32
        nbr[p + 1] |= 8
        if neg:
            sgn[p - 1] |= 4
            sgn[p + 1] |= 1
        if not (top and vsc):
            nbr[p + n_nw] |= 256
            nbr[p + n_n] |= 128
            nbr[p + n_ne] |= 64
            if neg:
                sgn[p + n_n] |= 64
        nbr[p + s_sw] |= 4
        nbr[p + s_s] |= 2
        nbr[p + s_se] |= 1
        if neg:
            sgn[p + s_s] |= 16

    bpno = roishift + numbps
    passtype = 2
    for data, npasses in segments:
        is_raw = (bpno <= numbps - 4) and passtype < 2 and bool(style & BYPASS)
        if is_raw:
            start_raw(data)
        else:
            start(data)
        for _ in range(npasses):
            if bpno < 1:
                break
            one = 1 << bpno
            half = one >> 1
            oph = one | half
            # each MQ decision below first tries the decoder's commonest case
            # inline (an MPS that needs no renormalisation), else calls decode
            if passtype == 0:  # significance propagation
                for rows, tops in scan:
                    for p0 in tops:
                        p = p0
                        for r in range(rows):
                            f = nbr[p]
                            if f and not st[p] & 1:
                                if is_raw:
                                    if raw():
                                        neg = raw()
                                        val[p] = -oph if neg else oph
                                        significant(p, neg, r == 0)
                                else:
                                    cx = zc[f]
                                    q = qe_of[index[cx]]
                                    if a - q >= 0x8000 and (c >> 16) & 0xFFFF >= q:
                                        a -= q
                                        c -= q << 16
                                        bit = mps[cx]
                                    else:
                                        bit = decode(cx)
                                    if bit:
                                        lu = (f & 0xAA) | sgn[p]
                                        neg = decode(_SC[lu]) ^ _SPB[lu]
                                        val[p] = -oph if neg else oph
                                        significant(p, neg, r == 0)
                                vis[p] = bpno
                            p += w2
            elif passtype == 1:  # magnitude refinement
                for rows, tops in scan:
                    for p0 in tops:
                        p = p0
                        for _r in range(rows):
                            s = st[p]
                            if s & 1 and vis[p] != bpno:
                                if is_raw:
                                    bit = raw()
                                else:
                                    cx = CTX_MAG + 2 if s & 4 else (CTX_MAG + 1 if nbr[p]
                                                                    else CTX_MAG)
                                    q = qe_of[index[cx]]
                                    if a - q >= 0x8000 and (c >> 16) & 0xFFFF >= q:
                                        a -= q
                                        c -= q << 16
                                        bit = mps[cx]
                                    else:
                                        bit = decode(cx)
                                v = val[p]
                                val[p] = v + half if bit ^ (v < 0) else v - half
                                st[p] = s | 4
                            p += w2
            else:  # cleanup
                for rows, tops in scan:
                    for p0 in tops:
                        p = p0
                        first = 0
                        # a run of four: none significant and no significant
                        # neighbour (then the significance pass did not visit them)
                        if rows == 4 and not (st[p0] | st[p0 + w2] | st[p0 + w2x2]
                                              | st[p0 + w2x3] | nbr[p0] | nbr[p0 + w2]
                                              | nbr[p0 + w2x2] | nbr[p0 + w2x3]):
                            q = qe_of[index[CTX_AGG]]
                            if a - q >= 0x8000 and (c >> 16) & 0xFFFF >= q:
                                a -= q
                                c -= q << 16
                                bit = mps[CTX_AGG]
                            else:
                                bit = decode(CTX_AGG)
                            if not bit:
                                continue
                            first = decode(CTX_UNI) << 1
                            first |= decode(CTX_UNI)
                            p = p0 + first * w2
                            lu = (nbr[p] & 0xAA) | sgn[p]
                            neg = decode(_SC[lu]) ^ _SPB[lu]
                            val[p] = -oph if neg else oph
                            significant(p, neg, first == 0)
                            first += 1
                            p += w2
                        for r in range(first, rows):
                            if not st[p] & 1 and vis[p] != bpno:
                                cx = zc[nbr[p]]
                                q = qe_of[index[cx]]
                                if a - q >= 0x8000 and (c >> 16) & 0xFFFF >= q:
                                    a -= q
                                    c -= q << 16
                                    bit = mps[cx]
                                else:
                                    bit = decode(cx)
                                if bit:
                                    lu = (nbr[p] & 0xAA) | sgn[p]
                                    neg = decode(_SC[lu]) ^ _SPB[lu]
                                    val[p] = -oph if neg else oph
                                    significant(p, neg, r == 0)
                            p += w2
                if style & SEGSYM:
                    for _k in range(4):
                        decode(CTX_UNI)
            if style & RESET and not is_raw:
                _reset(index, mps)
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.array(val, dtype=np.int64).reshape(h + 2, w2)[1:-1, 1:-1]
    if roishift:
        mag = np.abs(out)
        big = mag >= (1 << roishift)
        out = np.where(big, np.sign(out) * (mag >> roishift), out)
    return out

"""CCITT fax (T.4 and T.6) strips in Python and numpy, decoded as libtiff
4.7 decodes them for ``cv2.imread`` / ``cv2.imdecode``.

TIFF compressions 2 (modified Huffman: 1-D rows, each starting on a byte,
no EOLs), 3 (T.4: each row after an EOL, 1-D, or with T4Options bit 0 a
tag bit after the EOL choosing 1-D or 2-D) and 4 (T.6: 2-D rows against a
white first reference line, no EOLs). ``strip_decoder`` copies libtiff's
``tif_fax3.c`` step for step, its recovery from damaged data included, as
probed on cv2 5.0.0 (libtiff 4.7.1):

* a bad code ends its row; the rest of the row is white and decoding goes
  on at the next row: in T.4 after the next EOL, in T.6 from the very next
  bit, so one bad code usually garbles the rest of a T.6 strip;
* a row too long is cut back to the runs that fit, a row too short is
  filled with white;
* at the end of the data libtiff reads zero bits for a code it has begun,
  then stops; the row it was in is finished as above, and the rows after
  it stay as the strip's buffer was: zero bits (white under WhiteIsZero);
* T.6 stops at an EOL (the EOFB) and otherwise needs none; T.4 reads an
  EOL before every row, searching past anything else for it, and reads
  the rows of an RTC as white. Where the data runs out after the search
  has begun (after the EOL's 11 zero bits, or at once after an EOL code),
  libtiff starts the strip again from its first bit and reads it without
  EOLs, this row included, and so every later strip of the image; where
  no bit is left when the search begins, it stops;
* runs are kept in libtiff's two run arrays (current and reference line,
  swapped after each row and kept from strip to strip), since damaged 2-D
  data reads the reference line past its last change.

A row's bits are 0 for white and 1 for black, whatever the photometric
interpretation, which ``tiff.py`` applies afterwards. Codes are looked up
in tables of 7 (mode), 12 (white) and 13 (black) bits built from T.4's code
lists below; ``scripts/check_fax_tables.py`` finds them, laid out as
libtiff's own tables, in a libtiff library.
"""

from __future__ import annotations

from typing import List

import numpy as np

COMPRESSIONS = (2, 3, 4)  # TIFF's modified Huffman, T.4 and T.6

# T.4's codes, as (run, code) strings, first the terminating codes 0..63
WHITE_CODES = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
BLACK_CODES = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 "
    "000011010011 000011010100 000011010101 000011010110 000011010111 000001101100 "
    "000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 "
    "000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111").split()
# make-up codes for 64, 128, ..., 1728
WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
# the make-up codes both colours share, for 1792, 1856, ..., 2560
SHARED_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111").split()

# libtiff's table states
_NULL, _PASS, _HORIZ, _V0, _VR, _VL, _EXT, _TERM, _MAKEUP, _EOL = range(10)
# the 2-D mode codes: (code, state, parameter)
MODE_CODES = (("0001", _PASS, 0), ("001", _HORIZ, 0), ("1", _V0, 0), ("011", _VR, 1),
              ("000011", _VR, 2), ("0000011", _VR, 3), ("010", _VL, 1), ("000010", _VL, 2),
              ("0000010", _VL, 3), ("0000001", _EXT, 0), ("0000000", _EOL, 0))


def _table(bits: int, codes) -> List[tuple]:
    """A lookup table of 2^bits entries, indexed by the next ``bits`` bits
    most significant first: (state, code width, parameter); _NULL where no
    code begins."""
    table = [(_NULL, 0, 0)] * (1 << bits)
    for code, state, param in codes:
        lo = int(code, 2) << (bits - len(code))
        table[lo:lo + (1 << (bits - len(code)))] = [(state, len(code), param)] * (
            1 << (bits - len(code)))
    return table


def _run_codes(term, makeup):
    return ([(c, _TERM, n) for n, c in enumerate(term)]
            + [(c, _MAKEUP, 64 * (n + 1)) for n, c in enumerate(makeup)]
            + [(c, _MAKEUP, 1792 + 64 * n) for n, c in enumerate(SHARED_MAKEUP)]
            + [("0" * 11, _EOL, 0)])  # 11 zeros: libtiff's EOL entry


MODE_TABLE = _table(7, MODE_CODES)
WHITE_TABLE = _table(12, _run_codes(WHITE_CODES, WHITE_MAKEUP))
BLACK_TABLE = _table(13, _run_codes(BLACK_CODES, BLACK_MAKEUP))


class _Stop(Exception):
    """libtiff's decoder returns: the current row is not filled."""


def strip_decoder(compression: int, options: int, width: int):
    """A decoder of one strip or tile of CCITT data (bits most significant
    first: undo FillOrder 2 before) with the signature of
    ``tiff._DECODERS``' entries: ``decode(data, size, path)`` -> ``size`` bytes of packed 1-bit rows of
    ``width`` pixels, each padded to a byte, as libtiff leaves its buffer
    (see the module's docstring). ``compression``: 2, 3 or 4; ``options``:
    T4Options (tag 292) for 3. The decoder keeps libtiff's run arrays from
    one strip to the next, as libtiff does for one image."""
    mode = {2: "rle", 4: "g4"}.get(compression, "2d" if options & 1 else "1d")
    nruns = -(-(width + 1) // 32) * 32
    arrays = [0] * (2 * nruns if mode in ("2d", "g4") else nruns)
    no_eol = [mode in ("rle", "g4")]  # libtiff's FAXMODE_NOEOL, kept for the image

    def decode(data: bytes, size: int, path: str = "<bytes>") -> bytes:
        rowbytes = -(-width // 8)
        bits = np.zeros((size // rowbytes, rowbytes * 8), np.uint8)
        for y, runs in enumerate(_rows(data, len(bits), width, mode, arrays, nruns, no_eol,
                                       path)):
            row = np.repeat(np.arange(len(runs)) & 1, runs)  # white, black, white, ...
            bits[y, :len(row)] = row
        return np.packbits(bits, 1).tobytes()[:size]

    return decode


def _rows(data: bytes, rows: int, lastx: int, mode: str, arrays: list, nruns: int,
          no_eol: list, path: str):
    """Yields each row's runs (white first), as libtiff's fill routine
    clips them to ``lastx`` pixels, until the rows are done or libtiff
    stops (``Fax3DecodeRLE``, ``Fax3Decode1D``, ``Fax3Decode2D``,
    ``Fax4Decode``). ``no_eol[0]``: T.4 rows are read without looking for
    an EOL, as libtiff does once a search for one ran out of data."""
    n_bits = 8 * len(data)
    pad = np.frombuffer(data + bytes(8), np.uint8).astype(np.int64)
    # the 32 bits from each byte on: up to 13 bits at any bit position
    win = (pad[:-3] << 24 | pad[1:-2] << 16 | pad[2:-1] << 8 | pad[3:]).tolist()
    n_win = len(win)
    two_d = mode in ("2d", "g4")
    cur, ref = 0, nruns  # offsets of the current and the reference line
    if two_d:
        arrays[ref], arrays[ref + 1] = lastx, 0  # a white reference line
    # bits consumed, bits loaded (data, then zero padding), an EOL just read
    p = loaded = eol = 0
    pa = a0 = run_length = b1 = pb = 0

    def need(n):
        """libtiff's NeedBits8/NeedBits16: False at the end of the data."""
        nonlocal loaded
        if loaded - p >= n:
            return True
        if loaded >= n_bits:
            if loaded == p:
                return False
            loaded = p + n  # zero bits past the end
            return True
        loaded += 8
        if loaded - p < n:
            loaded = p + n if loaded >= n_bits else loaded + 8
        return True

    def peek(n):  # zero bits past the data, as far as libtiff's padding goes
        i = p >> 3
        return (win[i] >> (32 - n - (p & 7))) & ((1 << n) - 1) if i < n_win else 0

    def sync_eol():
        """SYNC_EOL: past 11 zero bits (unless an EOL was just read), past
        zero bytes, past zero bits, then the EOL's 1 bit -> False where no
        bit is left to search. Where the data runs out after the 11 zero
        bits (or, an EOL just read, at once), libtiff goes back to the
        strip's first bit and reads on without EOLs, this row included,
        for the rest of the image."""
        nonlocal p, loaded, eol
        if no_eol[0]:
            return True
        if not eol:
            if not need(11):
                return False
            while peek(11):
                p += 1
                need(11)  # zero bits past the end: never fails here
        while need(8):
            if peek(8):
                while not peek(1):
                    p += 1
                p += 1
                eol = 0
                return True
            p += 8
        no_eol[0] = True
        p = loaded = eol = 0
        return True

    def setvalue(x):
        nonlocal pa, a0, run_length
        if pa >= cur + nruns:
            raise _Stop
        arrays[pa] = run_length + x
        pa += 1
        a0 += x
        run_length = 0

    def cleanup():
        """CLEANUP_RUNS: a row that is not ``lastx`` long cut back or filled
        with white."""
        nonlocal pa, a0
        if run_length:
            setvalue(0)
        if a0 != lastx:
            while a0 > lastx and pa > cur:
                pa -= 1
                a0 -= arrays[pa]
            if a0 < lastx:
                a0 = max(a0, 0)
                if (pa - cur) & 1:
                    setvalue(0)
                setvalue(lastx - a0)
            elif a0 > lastx:
                setvalue(lastx)
                setvalue(0)

    def run(table, width, eol_ends):
        """Make-up codes, then a terminating code, of one colour -> True;
        False at a bad code (or an EOL, which sets the EOL flag where
        ``eol_ends``); None at the end of the data."""
        nonlocal p, a0, run_length, eol
        while True:
            if not need(width):
                return None
            kind, size, param = table[peek(width)]
            p += size
            if kind == _TERM:
                setvalue(param)
                return True
            if kind != _MAKEUP:
                eol |= eol_ends and kind == _EOL
                return False
            a0 += param
            run_length += param

    def check_b1():
        nonlocal b1, pb
        if pa != cur:
            while b1 <= a0 and b1 < lastx:
                if pb + 1 >= ref + nruns:
                    raise _Stop
                b1 += arrays[pb] + arrays[pb + 1]
                pb += 2

    def expand_1d():
        """EXPAND1D -> whether the data ran out."""
        nonlocal pa
        while True:
            got = run(WHITE_TABLE, 12, True)
            if got and a0 < lastx:
                got = run(BLACK_TABLE, 13, True)
                if got and a0 < lastx:
                    if arrays[pa - 1] == 0 and arrays[pa - 2] == 0:
                        pa -= 2
                    continue
            return got is None

    def expand_2d():
        """EXPAND2D -> whether the data ran out."""
        nonlocal p, pa, a0, run_length, b1, pb, eol
        while a0 < lastx:
            if pa >= cur + nruns:
                raise _Stop
            if not need(7):
                return True
            kind, size, param = MODE_TABLE[peek(7)]
            p += size
            if kind == _PASS:
                check_b1()
                if pb + 1 >= ref + nruns:
                    raise _Stop
                b1 += arrays[pb]
                run_length += b1 - a0
                a0 = b1
                b1 += arrays[pb + 1]
                pb += 2
            elif kind == _HORIZ:
                order = [(WHITE_TABLE, 12, False), (BLACK_TABLE, 13, False)]
                for args in order[::-1] if (pa - cur) & 1 else order:
                    got = run(*args)
                    if not got:
                        return got is None
                check_b1()
            elif kind in (_V0, _VR):
                check_b1()
                setvalue(b1 - a0 + param)
                if pb >= ref + nruns:
                    raise _Stop
                b1 += arrays[pb]
                pb += 1
            elif kind == _VL:
                check_b1()
                if b1 < a0 + param:
                    return False
                setvalue(b1 - a0 - param)
                pb -= 1
                if pb < 0:
                    raise ValueError(f"{path}: fax data reads before libtiff's run arrays")
                b1 -= arrays[pb]
            else:  # an extension (uncompressed mode) or an EOL
                arrays[pa] = lastx - a0
                pa += 1
                if kind == _EOL:
                    if not need(4):
                        return True
                    p += 4
                    eol = 1
                return False
        if run_length:
            if run_length + a0 < lastx:  # a final V0 expected
                if not need(1):
                    return True
                if not peek(1):
                    return False
                p += 1
            setvalue(0)
        return False

    try:
        for _ in range(rows):
            pa, a0, run_length = cur, 0, 0
            # ended: the data ran out in this row (it is still finished)
            ended = not sync_eol() or (mode == "2d" and not need(1))
            one_d = mode in ("rle", "1d")
            if mode == "2d" and not ended:
                one_d = bool(peek(1))  # the tag bit after the EOL
                p += 1
            if not ended and one_d:
                ended = expand_1d()
            elif not ended:
                pb = ref + 1
                b1 = arrays[ref]
                ended = expand_2d()
            cleanup()
            if mode == "rle":  # each row starts on a byte
                p += (loaded - p) % 8
            yield _filled(arrays, cur, pa, lastx, path)
            if ended or (mode == "g4" and eol):
                return
            if two_d:
                if mode == "g4" or pa < cur + nruns:
                    setvalue(0)  # an imaginary change for the reference line
                cur, ref = ref, cur
    except _Stop:  # libtiff returns without filling the row
        return


def _filled(arrays: list, start: int, end: int, lastx: int, path: str) -> List[int]:
    """libtiff's ``_TIFFFax3fillruns``: the runs from ``start`` to ``end``
    (and a 0 after them if odd), each clipped to what is left of the row and
    written back clipped; -> the runs."""
    if (end - start) & 1:
        if end >= len(arrays):
            raise ValueError(f"{path}: fax data writes past libtiff's run arrays")
        arrays[end] = 0
        end += 1
    x = 0
    for i in range(start, end):
        r = arrays[i]
        if r < 0 or r > lastx or x + r > lastx:
            arrays[i] = r = lastx - x
        x += r
    return arrays[start:end]

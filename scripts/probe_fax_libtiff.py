#!/usr/bin/env python3
"""Hold the port's CCITT decoder (``megreader_tpu_torch/data/fax.py``) to
libtiff's own, strip by strip, on seeded damaged and random data.

cv2 reads a TIFF through libtiff's RGBA interface, which hides the rows
libtiff left untouched (they read as zero) and costs a decode of the whole
image. This script reads the raw strips instead: it opens each file with
the libtiff that PIL's encoder loads (``TIFFOpen``, then
``TIFFReadEncodedStrip`` into a zeroed buffer, as the RGBA reader's is),
and compares them with ``fax.strip_decoder``'s output. (To see which rows
libtiff left untouched, fill the buffer with 0xAA: ``raw_strips(...,
fill=0xAA)``.) The files are

* libtiff's own T.4/T.6 strips of seeded pages (through PIL), damaged by bit
  flips, zeroed or random bytes, cuts and insertions, several strips an
  image; and
* streams of random valid codes (modes, runs, make-up codes, EOLs, tag
  bits, junk), which reach the decoder's rarer paths.

It prints the count of strips compared and of strips that differ, writes
the first few that differ under ``--out``, and exits 1 if any differs:

    python3 scripts/probe_fax_libtiff.py [--seed 1] [--seconds 60] [--out DIR]

It needs PIL with libtiff (Linux: the library is found in the process's
maps).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import make_port_image_assets as assets  # noqa: E402
from megreader_tpu_torch.data import fax  # noqa: E402

EOL = "000000000001"
_MODES = [code for code, _, _ in fax.MODE_CODES]


def libtiff() -> ctypes.CDLL:
    """The libtiff PIL's encoder loaded, its strip reader bound."""
    assets.fax_strip(np.ones((1, 8), np.uint8), 4)
    with open("/proc/self/maps") as f:
        path = sorted({ln.split()[-1] for ln in f if "libtiff" in ln.split()[-1]})[0]
    lib = ctypes.CDLL(path)
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                         ctypes.c_ssize_t]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    for name in ("TIFFSetWarningHandler", "TIFFSetErrorHandler"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_void_p
        getattr(lib, name)(None)
    return lib


def raw_strips(lib, data: bytes, sizes, scratch: str, fill: int = 0):
    """libtiff's decode of each strip of ``data`` into a buffer of ``fill``
    bytes."""
    path = os.path.join(scratch, "strips.tif")
    with open(path, "wb") as f:
        f.write(data)
    tif = lib.TIFFOpen(path.encode(), b"r")
    out = []
    for k, size in enumerate(sizes):
        buf = (ctypes.c_uint8 * size)(*([fill] * size))
        lib.TIFFReadEncodedStrip(tif, k, buf, size)
        out.append(bytes(buf))
    lib.TIFFClose(tif)
    return out


def _bits(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)) or b"\0"


def _run(rng, white: bool) -> str:
    term = fax.WHITE_CODES if white else fax.BLACK_CODES
    makeup = fax.WHITE_MAKEUP if white else fax.BLACK_MAKEUP
    code = makeup[int(rng.integers(0, 27))] if rng.random() < 0.2 else ""
    code += fax.SHARED_MAKEUP[int(rng.integers(0, 13))] if rng.random() < 0.05 else ""
    return code + term[int(rng.integers(0, 64 if rng.random() < 0.3 else 8))]


def random_stream(rng, compression: int, options: int, rows: int) -> bytes:
    """Codes of ``rows`` rows picked at random, valid one by one."""
    out = ""
    for _ in range(rows):
        if compression == 3 and rng.random() < 0.9:
            out += "0" * int(rng.integers(0, 9)) * bool(options & 4) + EOL
        two_d = compression == 4 or (compression == 3 and options & 1 and rng.random() < 0.6)
        if compression == 3 and options & 1:
            out += "0" if two_d else "1"
        white = True
        for _ in range(int(rng.integers(1, 12))):
            if two_d:
                mode = _MODES[int(rng.integers(0, 9 if rng.random() < 0.97 else 11))]
                out += mode + (_run(rng, True) + _run(rng, False) if mode == "001" else "")
            else:
                out += _run(rng, white)
                white = not white
        if compression == 2:
            out += "0" * (-len(out) % 8)
        if rng.random() < 0.05:
            out += "".join(rng.choice(["0", "1"], int(rng.integers(1, 20))))
    if compression == 4 and rng.random() < 0.3:
        out += EOL + EOL
    return _bits(out)


def damaged_strips(rng, compression: int, options: int, bits: np.ndarray, rows: int):
    """libtiff's strips of ``bits``, ``rows`` rows each, damaged."""
    chunks = [bytearray(assets.fax_strip(bits[y:y + rows], compression, options))
              for y in range(0, len(bits), rows)]
    for _ in range(int(rng.integers(0, 4))):
        c = chunks[int(rng.integers(0, len(chunks)))]
        if not c:
            continue
        at = int(rng.integers(0, len(c)))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            c[at] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:
            c[at:at + 7] = bytes(len(c[at:at + 7]))
        elif kind == 2:
            del c[at:]
        elif kind == 3:
            c[at:at + 4] = rng.integers(0, 256, 4).astype(np.uint8).tobytes()
        else:
            c[at:at] = rng.integers(0, 256, int(rng.integers(1, 4))).astype(np.uint8).tobytes()
    return [bytes(c) or b"\0" for c in chunks]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", default=None, help="where to write the strips that differ")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    lib = libtiff()
    codings = [(2, 0), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0)]
    compared = differ = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as scratch:
        while time.perf_counter() - t0 < args.seconds:
            compression, options = codings[int(rng.integers(0, len(codings)))]
            h = int(rng.integers(1, 30))
            w = int(rng.choice([1, 2, 5, 8, 13, 33, 64, 200, 1800]))
            rows = int(rng.integers(1, h + 1))
            if rng.random() < 0.5:
                page = np.zeros((h, w), np.uint8)
                for _ in range(max(1, h * w // 150)):
                    y, x = rng.integers(0, h), rng.integers(0, w)
                    page[y:y + rng.integers(1, 6), x:x + rng.integers(1, 40)] = 1
                chunks = damaged_strips(rng, compression, options, page, rows)
            else:
                chunks = [random_stream(rng, compression, options,
                                        min(rows, h - y) + int(rng.integers(-1, 2)))
                          for y in range(0, h, rows)]
            data = assets.fax_tiff(np.zeros((h, w), np.uint8), compression, options,
                                   rows_per_strip=rows, chunks=chunks)
            rowbytes = -(-w // 8)
            sizes = [min(rows, h - y) * rowbytes for y in range(0, h, rows)]
            decode = fax.strip_decoder(compression, options, w)
            for k, want in enumerate(raw_strips(lib, data, sizes, scratch)):
                compared += 1
                try:
                    got = decode(chunks[k], sizes[k])
                except ValueError:
                    got = None
                if got != want:
                    differ += 1
                    if args.out and differ <= 5:
                        os.makedirs(args.out, exist_ok=True)
                        with open(os.path.join(args.out, f"differ_{differ}.tif"), "wb") as f:
                            f.write(data)
                    break
    print(f"seed {args.seed}: {compared} strips compared with libtiff, {differ} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check the CCITT code lists typed into the port's fax decoder against a
libtiff shared library.

``megreader_tpu_torch/data/fax.py`` holds T.4's white and black terminating
and make-up codes, the shared make-up codes 1792-2560 and the 2-D mode
codes. libtiff decodes with three tables built from the same lists by its
``mkg3states``: ``TIFFFaxMainTable`` (7 bits), ``TIFFFaxWhiteTable`` (12)
and ``TIFFFaxBlackTable`` (13), each entry ``{state, width, param}`` (8
bytes with padding), indexed by the next bits least significant first. This
script builds those three tables from the port's lists, byte for byte as
libtiff stores them, looks for each in the library file, and exits 1 if one
is missing. Nothing is read from the library at run time.

    python3 scripts/check_fax_tables.py [--lib PATH]

Without ``--lib`` it loads the library ``ctypes.util.find_library("tiff")``
names and reads the file the process mapped (Linux).
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from megreader_tpu_torch.data import fax  # noqa: E402

# libtiff's states (tif_fax3.h)
_STATES = {fax._PASS: 1, fax._HORIZ: 2, fax._V0: 3, fax._VR: 4, fax._VL: 5, fax._EXT: 6,
           fax._EOL: 12}
_ENTRY = np.dtype([("state", "u1"), ("width", "u1"), ("pad", "u2"), ("param", "<u4")])


def _mapped_path(name: str) -> str:
    """The file of the shared library ``name`` as this process maps it."""
    ctypes.CDLL(name)
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith(name.split(".so")[0] + ".so"):
                return path
    raise SystemExit(f"{name} is not mapped")


def _table(bits: int, codes) -> bytes:
    """libtiff's table of 2^bits entries for ``codes`` ((code, state,
    param)): every index whose low bits, read first to last, are the code."""
    table = np.zeros(1 << bits, _ENTRY)
    for code, state, param in codes:
        n = len(code)
        idx = int(code[::-1], 2) | (np.arange(1 << (bits - n)) << n)
        table[idx] = (state, n, 0, param)
    return table.tobytes()


def _runs(term, makeup, white: bool):
    return ([(c, 7 if white else 8, n) for n, c in enumerate(term)]
            + [(c, 9 if white else 10, 64 * (n + 1)) for n, c in enumerate(makeup)]
            + [(c, 11, 1792 + 64 * n) for n, c in enumerate(fax.SHARED_MAKEUP)]
            + [("0" * 11, 12, 0)])


def tables() -> dict:
    return {
        "TIFFFaxMainTable": _table(7, [(c, _STATES[s], p) for c, s, p in fax.MODE_CODES]),
        "TIFFFaxWhiteTable": _table(12, _runs(fax.WHITE_CODES, fax.WHITE_MAKEUP, True)),
        "TIFFFaxBlackTable": _table(13, _runs(fax.BLACK_CODES, fax.BLACK_MAKEUP, False)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", help="the libtiff shared library file")
    args = ap.parse_args(argv)
    path = args.lib
    if path is None:
        name = ctypes.util.find_library("tiff")
        if name is None:
            raise SystemExit("no libtiff found; pass --lib")
        path = _mapped_path(name)
    with open(path, "rb") as f:
        lib = f.read()
    missing = 0
    for name, data in tables().items():
        at = lib.find(data)
        print(f"{name}: {len(data)} bytes " + (f"found at {at}" if at >= 0 else "NOT FOUND"))
        missing += at < 0
    print(f"{path}: {len(tables()) - missing} of {len(tables())} tables found")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())

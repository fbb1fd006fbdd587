#!/usr/bin/env python3
"""Check the constant tables typed into the port's WebP decoders against a
libwebp shared library.

``megreader_tpu_torch/data/vp8.py`` holds RFC 6386's default and update
coefficient probabilities, the key-frame 4x4 mode probabilities (in
libwebp's order of the modes) and the DC and AC quantizer lookups;
``data/vp8l.py`` holds RFC 9649's 120-entry distance map. A table with one
wrong entry decodes most files wrongly, so this script looks for each table,
byte for byte as libwebp stores it (uint8, the AC lookup as little-endian
uint16), in the library file, and exits 1 if one is missing. Nothing is read
from the library at run time.

    python3 scripts/check_vp8_tables.py [--lib PATH]

Without ``--lib`` it loads the library ``ctypes.util.find_library("webp")``
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

from megreader_tpu_torch.data import vp8, vp8l  # noqa: E402


def _mapped_path(name: str) -> str:
    """The file of the shared library ``name`` as this process maps it."""
    ctypes.CDLL(name)
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith(name.split(".so")[0] + ".so"):
                return path
    raise SystemExit(f"{name} is not mapped")


def tables() -> dict:
    return {
        "coefficient probabilities": np.asarray(vp8._COEF_PROBS, np.uint8).tobytes(),
        "coefficient update probabilities": np.asarray(vp8._COEF_UPDATE_PROBS,
                                                       np.uint8).tobytes(),
        "4x4 mode probabilities": np.asarray(vp8._BMODE_PROBS, np.uint8).tobytes(),
        "DC quantizer lookup": np.asarray(vp8._DC_TABLE, np.uint8).tobytes(),
        "AC quantizer lookup": np.asarray(vp8._AC_TABLE, "<u2").tobytes(),
        "zigzag order": bytes(vp8.ZIGZAG),
        "coefficient bands": bytes(vp8.BANDS),
        "VP8L distance map": vp8l._DISTANCE_MAP,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", help="the libwebp shared library file")
    args = ap.parse_args(argv)
    path = args.lib
    if path is None:
        name = ctypes.util.find_library("webp")
        if name is None:
            raise SystemExit("no libwebp found; pass --lib")
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

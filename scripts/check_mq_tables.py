#!/usr/bin/env python3
"""Check the tier-1 tables typed into the port's JPEG 2000 decoder
(``megreader_tpu_torch/data/ebcot.py``) against libopenjp2.

* The MQ coder's 47 states (T.800 Table C.2: Qe, the next state after an
  MPS and after an LPS, the switch flag): OpenJPEG keeps them as an array
  of structs with pointers to the next states, which no byte search can
  match, so the script reads the array from the loaded library's memory
  (``scripts/openjpeg_ctypes.py::mq_states``: ``opj_mqc_setstate`` points
  a context at each entry, and the entries' pointers name the next states).
* The zero-coding contexts (512 neighbourhoods for each of 4 orientations,
  2,048 bytes), the sign-coding contexts and the sign predictions (256
  bytes each) in OpenJPEG's neighbourhood layout: each must appear byte
  for byte in the library file, as OpenJPEG's generated ``t1_luts.h``
  stores it.
* Then the decoder itself: code-blocks that libopenjp2 encodes in every
  code-block style, decoded by the port, against libopenjp2's decode.

Exits 1 if a table or a decode differs. Runs where the library is (Pillow
bundles one, which exports the MQ functions the first check needs):

    python3 scripts/check_mq_tables.py [--lib PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import openjpeg_ctypes  # noqa: E402
from megreader_tpu_torch.data import ebcot, j2k  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", default=None, help="libopenjp2 to check against")
    args = ap.parse_args(argv)
    path = args.lib or openjpeg_ctypes.candidates()[0]
    lib = openjpeg_ctypes.library(path)
    bad = 0
    if hasattr(lib, "opj_mqc_setstate"):
        states = openjpeg_ctypes.mq_states(lib)
        ok = states == [tuple(s) for s in ebcot.MQ_STATES]
        bad += not ok
        print(f"MQ states (47): {'equal' if ok else 'DIFFER'} ({path})")
    else:
        print(f"MQ states: {path} does not export opj_mqc_setstate; not checked")
    with open(path, "rb") as f:
        blob = f.read()
    for name, table in (("zero-coding contexts", ebcot.ZC_TABLE),
                        ("sign-coding contexts", ebcot.SC_TABLE),
                        ("sign predictions", ebcot.SPB_TABLE)):
        found = blob.count(table)
        bad += found == 0
        print(f"{name} ({len(table)} bytes): {'found' if found else 'NOT FOUND'} in the library")
    rng = np.random.default_rng(0)
    y, x = np.mgrid[:40, :52]
    img = np.clip(128 + 60 * np.sin(x / 5) * np.cos(y / 7) + rng.normal(0, 12, (40, 52)), 0, 255)
    styles = (0, ebcot.BYPASS, ebcot.RESET, ebcot.TERMALL, ebcot.VSC, ebcot.PTERM, ebcot.SEGSYM,
              63)
    for style in styles:
        for kw in ({}, {"irreversible": 1, "rates": [12, 4]}):
            data = openjpeg_ctypes.encode([img.astype(np.int64)], lib=lib, numresolution=3,
                                          mode=style, cblockw_init=16, cblockh_init=8, **kw)
            want = openjpeg_ctypes.decode(data, lib=lib)["comps"][0]["plane"]
            got = j2k.decode_codestream(data).comps[0][4]
            ok = np.array_equal(want, got)
            bad += not ok
            print(f"code-block style {style:2d} {'9/7 lossy' if kw else '5/3 lossless'}: "
                  f"{'equal' if ok else 'DIFFER'}")
    print("all equal" if not bad else f"{bad} checks differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

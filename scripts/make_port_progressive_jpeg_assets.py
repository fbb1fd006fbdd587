#!/usr/bin/env python3
"""Write ``assets/jpeg/progressive/``: progressive JPEG files (SOF2) and
their baseline twins, which the port's decoder is held to.

``cv2.imencode(..., IMWRITE_JPEG_PROGRESSIVE=1)`` writes a progressive file
(10 scans for colour, 6 for grey: DC first and refinement, AC bands by
successive approximation, EOB runs); without the flag, at the same quality
and sampling, it writes the baseline twin. libjpeg-turbo decodes the two to
the same pixels (a complete progressive file leaves no coefficient bit
unknown, so no block smoothing): this script checks that with cv2 and
records, for each file, the SHA-256 of cv2's decode (``cv2.imdecode(buf,
IMREAD_COLOR)`` then ``BGR2RGB``, C-order uint8 bytes) and its twin's name
in ``manifest.json``. Files, each ``<name>.jpg`` with ``<name>.base.jpg``:

* ``s<sampling>_<h>x<w>``: every sampling cv2 writes (4:4:4, 4:2:2, 4:2:0,
  4:1:1, 4:4:0) at 1x1, 7x13, 33x50 and 100x37, quality 95;
* ``q50_41x67``, restart intervals (``rst1_s420_70x90``, ``rst3_s444_33x50``),
  optimized tables (``optimized_s420_100x37``, ``optimized_s422_q100_33x50``),
  ``grey_33x50``;
* ``page_1280x720``: a page of ICDAR 2015's size drawn by
  ``chip_smoke.TextPages`` (dark noise below 8), quality 95, 4:2:0.

It runs where cv2 is installed (not on the card's machine) and is
deterministic:

    python3 scripts/make_port_progressive_jpeg_assets.py [--out assets/jpeg/progressive]

``scripts/make_port_jpeg_assets.py`` rewrites ``assets/jpeg/`` from scratch:
run this script again after it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_port_jpeg_assets import SAMPLINGS, cv2_digest, encode, smooth  # noqa: E402


def images(rng):
    """name -> (RGB or grey image, cv2 parameters besides the progressive flag)."""
    out = {}
    for s, flag in SAMPLINGS.items():
        for h, w in ((1, 1), (7, 13), (33, 50), (100, 37)):
            out[f"s{s}_{h}x{w}"] = (smooth(rng, h, w), [
                cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    out["q50_41x67"] = (smooth(rng, 41, 67), [cv2.IMWRITE_JPEG_QUALITY, 50])
    out["rst1_s420_70x90"] = (smooth(rng, 70, 90), [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    out["rst3_s444_33x50"] = (smooth(rng, 33, 50), [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 3, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS["444"]])
    out["optimized_s420_100x37"] = (smooth(rng, 100, 37), [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    out["optimized_s422_q100_33x50"] = (smooth(rng, 33, 50), [
        cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 100,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS["422"]])
    out["grey_33x50"] = (smooth(rng, 33, 50, grey=True), [])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "assets", "jpeg", "progressive"))
    args = ap.parse_args(argv)
    import chip_smoke as cs

    cases = images(np.random.default_rng(19))
    cases["page_1280x720"] = (cs.TextPages(1, 19, hw=(720, 1280), noise=8)[0]["image"], [])
    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    os.makedirs(args.out)
    files = {}
    for name, (img, params) in cases.items():
        prog = encode(img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] + params)
        base = encode(img, params)
        assert b"\xff\xc2" in prog and b"\xff\xc2" not in base, name
        for rel, data in ((f"{name}.jpg", prog), (f"{name}.base.jpg", base)):
            with open(os.path.join(args.out, rel), "wb") as f:
                f.write(data)
            digest, shape = cv2_digest(data)
            files[rel] = {"sha256": digest, "shape": shape, "bytes": len(data)}
        assert files[f"{name}.jpg"]["sha256"] == files[f"{name}.base.jpg"]["sha256"], name
        files[f"{name}.jpg"]["twin"] = f"{name}.base.jpg"
        files[f"{name}.jpg"]["scans"] = prog.count(b"\xff\xda")
    build = [line.strip() for line in cv2.getBuildInformation().splitlines() if "JPEG:" in line]
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"made_by": "scripts/make_port_progressive_jpeg_assets.py",
                   "decoder": f"cv2 {cv2.__version__} ({'; '.join(build)})",
                   "digest": "sha256 of cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), "
                             "cv2.COLOR_BGR2RGB) as C-order uint8 bytes",
                   "files": files}, f, indent=1, sort_keys=True)
    total = sum(v["bytes"] for v in files.values())
    print(f"wrote {len(files)} JPEG files, {total} bytes, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Write ``assets/jpeg/``: the JPEG files the port's decoder is held to.

The card's machine has no JPEG encoder (no cv2, no PIL), so the files the
port decodes there are committed; this script makes them with cv2 (it runs
where cv2 is installed, not on the card's machine) and records, for each,
the SHA-256 of cv2's decode (``cv2.imdecode(buf, IMREAD_COLOR)`` then
``BGR2RGB``, as C-order uint8 bytes) in ``manifest.json``:

* ``pages/images/page_XXXXX.jpg`` + ``pages/gts/gt_page_XXXXX.txt``: 8 pages
  at ICDAR 2015's 1280x720 drawn by ``chip_smoke.TextPages`` (dark noise
  below 8 keeps a page near 150 KB), ICDAR GT lines ``x1,y1,...,x4,y4,text``
  (corners rounded, ``###`` for a don't-care word);
* ``crops/word_XXXXX.jpg`` + ``crops/list.txt``: 256 tight word crops drawn
  by ``chip_smoke.WordCrops``, listed as ``word_XXXXX.jpg<TAB>text``;
* ``cases/*.jpg``: small files in every sampling cv2 writes (4:4:4, 4:2:2,
  4:2:0, 4:1:1, 4:4:0), grey, qualities 50/75/100, restart intervals,
  optimized Huffman tables, sizes that are not a multiple of the MCU, and
  an EXIF Orientation tag (6) put in by hand.

Every file is ``cv2.imencode``'s, at quality 95 and 4:2:0 unless its case
says otherwise.

    python3 scripts/make_port_jpeg_assets.py [--out assets/jpeg]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def encode(rgb: np.ndarray, params=()) -> bytes:
    img = rgb if rgb.ndim == 2 else cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".jpg", img, [int(p) for p in params])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def cv2_digest(data: bytes):
    """(SHA-256 of cv2's RGB decode, its shape)."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    rgb = np.ascontiguousarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return hashlib.sha256(rgb.tobytes()).hexdigest(), list(rgb.shape)


def with_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 Exif segment whose IFD0 holds only Orientation."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def smooth(rng, h: int, w: int, grey: bool = False) -> np.ndarray:
    """A smooth random image with some noise (the blocks' DC and AC terms
    both matter)."""
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int64)
    img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def cases(rng):
    """name -> encoded bytes of the small cases."""
    out = {}
    for s, flag in SAMPLINGS.items():
        for h, w in ((1, 1), (7, 13), (33, 50), (100, 37)):
            out[f"s{s}_{h}x{w}"] = encode(smooth(rng, h, w), [
                cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    for q in (50, 75, 100):
        out[f"q{q}_41x67"] = encode(smooth(rng, 41, 67), [cv2.IMWRITE_JPEG_QUALITY, q])
    out["grey_33x50"] = encode(smooth(rng, 33, 50, grey=True))
    out["grey_q50_9x17"] = encode(smooth(rng, 9, 17, grey=True), [cv2.IMWRITE_JPEG_QUALITY, 50])
    for rst in (1, 3):
        out[f"rst{rst}_s420_70x90"] = encode(smooth(rng, 70, 90), [
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    out["rst2_grey_30x45"] = encode(smooth(rng, 30, 45, grey=True),
                                    [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    out["optimized_s420_100x37"] = encode(smooth(rng, 100, 37), [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    out["optimized_s444_q100_33x50"] = encode(smooth(rng, 33, 50), [
        cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 100,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS["444"]])
    out["noise_s420_64x80"] = encode(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8))
    out["exif6_20x30"] = with_orientation(encode(smooth(rng, 20, 30)), 6)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "assets", "jpeg"))
    args = ap.parse_args(argv)
    import chip_smoke as cs

    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    files = {}

    def put(rel: str, data: bytes) -> None:
        path = os.path.join(args.out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        digest, shape = cv2_digest(data)
        files[rel] = {"sha256": digest, "shape": shape, "bytes": len(data)}

    pages = cs.TextPages(8, 18, hw=(720, 1280), noise=8)
    for i in range(len(pages)):
        item = pages[i]
        name = f"page_{i:05d}"
        put(f"pages/images/{name}.jpg", encode(item["image"]))
        lines = [",".join(str(int(round(v))) for v in np.asarray(poly).reshape(-1))
                 + f",{'###' if ign else text}"
                 for poly, ign, text in zip(item["polygons"], item["ignore"], item["texts"])]
        os.makedirs(os.path.join(args.out, "pages", "gts"), exist_ok=True)
        with open(os.path.join(args.out, "pages", "gts", f"gt_{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    words = cs.WordCrops(256, 18)
    lines = []
    for i in range(len(words)):
        item = words[i]
        h, w = (int(v) for v in item["size"])
        put(f"crops/word_{i:05d}.jpg", encode(item["image"][:h, :w]))
        lines.append(f"word_{i:05d}.jpg\t{item['text']}")
    with open(os.path.join(args.out, "crops", "list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for name, data in cases(np.random.default_rng(18)).items():
        put(f"cases/{name}.jpg", data)
    build = [line.strip() for line in cv2.getBuildInformation().splitlines() if "JPEG:" in line]
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"made_by": "scripts/make_port_jpeg_assets.py",
                   "decoder": f"cv2 {cv2.__version__} ({'; '.join(build)})",
                   "digest": "sha256 of cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), "
                             "cv2.COLOR_BGR2RGB) as C-order uint8 bytes",
                   "files": files}, f, indent=1, sort_keys=True)
    total = sum(v["bytes"] for v in files.values())
    print(f"wrote {len(files)} JPEG files, {total} bytes, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

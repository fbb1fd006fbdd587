#!/usr/bin/env python3
"""Write ``assets/glyphs/simplex_t2_aa.npz``, the glyph table that
``megreader_tpu_torch/data/text_render.py`` replays, and
``assets/synth/manifest.json``, the digests of the JAX package's first
synthetic items.

The synthetic datasets draw with ``cv2.putText(img, text, org,
FONT_HERSHEY_SIMPLEX, scale, (235, 235, 235), 2, LINE_AA)`` and size with
``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, 2)``, scale in
[0.8, 2.0]. The card's machine has no cv2, so this script (run where cv2 is
installed) records what those calls do, for each of the 33 pixel heights
22-54, and checks again on each run what the replay rests on; it fails if
one of these no longer holds:

* the pixel height is ``text_render.pixel_height(scale)``: each of the 32
  boundaries in [0.8, 2.0] is bisected to the last float64 bit and both
  neighbouring floats are checked, with their renders;
* a glyph's advance is its ``getTextSize`` width less 1, and its descent
  its ``getTextSize`` baseline; a string's width is the sum of its
  advances plus 1, its height the pixel height, its baseline the largest
  descent;
* a glyph changes each pixel it covers by ``(b (255 - a) + 235 a + 127)
  // 255`` of the value b before, for one coverage a a pixel, at every b;
* a string's render is its glyphs blended one after another at those
  advances (pairs of glyphs, every word of the datasets, random strings,
  on the datasets' noise and on full-range noise), moved by whole pixels
  with its origin, and clipped at every edge without changing what lies
  inside; a string whose origin lies at or right of the right edge draws
  nothing.

Arrays: ``chars`` (95,) int32 codes 32-126; ``advance``, ``descent`` (33,
95) int32; ``box`` (33, 95, 4) int32 = (row and column of the coverage box
relative to the baseline and the pen, height, width); ``start`` (33, 95)
int64 offsets into ``alpha``, the flat uint8 coverage of each box
(row-major); ``empty_baseline`` (33,) int32, the baseline of "".

The manifest holds, for the first 16 items of
``SyntheticRecognitionDataset(seed=0)``, ``SyntheticDetectionDataset()`` and
``SyntheticDetectionDataset(max_rotate=15, max_persp=0.05)`` of the JAX
package, the sha256 of each of the item's arrays
(``chip_smoke.item_digests``, which phase synth checks them with).

    python3 scripts/make_port_text_assets.py [--out assets]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import item_digests  # noqa: E402
from megreader_tpu_torch.data import text_render  # noqa: E402

CHARS = [chr(c) for c in range(32, 127)]
HEIGHTS = list(range(text_render.HEIGHTS[0], text_render.HEIGHTS[1] + 1))
ALNUM = [c for c in CHARS if c.isalnum()]
SYNTH = [("recognition", "SyntheticRecognitionDataset", {"seed": 0}),
         ("detection", "SyntheticDetectionDataset", {}),
         ("detection_warped", "SyntheticDetectionDataset",
          {"max_rotate": 15.0, "max_persp": 0.05})]
N_ITEMS = 16


def blend(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    return (b.astype(np.int64) * (255 - a) + 235 * a + 127) // 255


def main():
    import cv2

    FONT, THICK, LINE = cv2.FONT_HERSHEY_SIMPLEX, 2, cv2.LINE_AA
    assert (FONT, LINE) == (text_render.FONT_HERSHEY_SIMPLEX, text_render.LINE_AA)
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "assets"))
    args = ap.parse_args()

    def size(text, s):
        return cv2.getTextSize(text, FONT, s, THICK)

    def draw(img, text, org, s):
        cv2.putText(img, text, org, FONT, s, (235, 235, 235), THICK, LINE)
        return img

    # -- the rule from scale to pixel height, at each boundary's two floats
    def height(s):
        return size("a", s)[0][1]

    lo_s, hi_s = text_render.SCALE_RANGE
    assert height(lo_s) == HEIGHTS[0] and height(hi_s) == HEIGHTS[-1]
    bounds = []
    for k in HEIGHTS[:-1]:
        lo, hi = (k - 0.3) * 0.037, (k + 1.3) * 0.037
        lo, hi = max(lo, lo_s), min(hi, hi_s)
        assert height(lo) == k and height(hi) == k + 1, k
        while math.nextafter(lo, hi) != hi:
            mid = (lo + hi) / 2
            if height(mid) == k:
                lo = mid
            else:
                hi = mid
        for s, want in ((lo, k), (hi, k + 1)):
            assert text_render.pixel_height(s) == want, (k, s)
        bounds.append((lo, hi))

    # -- each glyph alone: advance, descent, coverage
    table = {h: {} for h in HEIGHTS}
    T = blend(np.arange(256)[None, :], np.arange(256)[:, None])  # (a, b)
    first = np.full((256, 256), -1, np.int64)  # (after at b 0, after at b 255) -> a
    for a in range(255, -1, -1):
        first[T[a, 0], T[a, 255]] = a
    for h in HEIGHTS:
        s = h * 0.037
        assert text_render.pixel_height(s) == h
        canvas, org = (4 * h, 3 * h), (h, 3 * h)
        for c in CHARS:
            (w, th), bl = size(c, s)
            assert th == h, (h, c)
            after = np.empty((258,) + canvas, np.uint8)
            img = np.empty(canvas + (3,), np.uint8)
            for j in range(86):
                img[...] = [min(3 * j + q, 255) for q in range(3)]
                after[3 * j:3 * j + 3] = draw(img, c, org, s).transpose(2, 0, 1)
            after = after[:256]
            touched = (after != np.arange(256, dtype=np.uint8)[:, None, None]).any(0)
            if not touched.any():
                table[h][c] = (w - 1, bl, (0, 0, 0, 0), np.zeros(0, np.uint8))
                continue
            rows, cols = np.nonzero(touched)
            r0, r1, c0, c1 = rows.min(), rows.max() + 1, cols.min(), cols.max() + 1
            assert r0 > 0 and c0 > 0 and r1 < canvas[0] and c1 < canvas[1], (h, c)
            m = after[:, rows, cols].astype(np.int64)  # (256 b, pixels)
            a = first[m[0], m[255]]
            assert (a >= 0).all() and np.array_equal(T[a].T, m), (h, c)
            alpha = np.zeros((r1 - r0, c1 - c0), np.uint8)
            alpha[rows - r0, cols - c0] = a
            table[h][c] = (w - 1, bl, (r0 - org[1], c0 - org[0], r1 - r0, c1 - c0),
                           alpha.reshape(-1))

    chars = np.array([ord(c) for c in CHARS], np.int32)
    advance = np.array([[table[h][c][0] for c in CHARS] for h in HEIGHTS], np.int32)
    descent = np.array([[table[h][c][1] for c in CHARS] for h in HEIGHTS], np.int32)
    box = np.array([[table[h][c][2] for c in CHARS] for h in HEIGHTS], np.int32)
    flat = [table[h][c][3] for h in HEIGHTS for c in CHARS]
    start = np.cumsum([0] + [len(f) for f in flat[:-1]]).astype(np.int64).reshape(len(HEIGHTS),
                                                                                    len(CHARS))
    empty = np.array([size("", h * 0.037)[1] for h in HEIGHTS], np.int32)
    os.makedirs(os.path.join(args.out, "glyphs"), exist_ok=True)
    path = os.path.join(args.out, "glyphs", "simplex_t2_aa.npz")
    np.savez_compressed(path, chars=chars, advance=advance, descent=descent, box=box,
                        start=start, alpha=np.concatenate(flat).astype(np.uint8),
                        empty_baseline=empty)
    text_render.TABLE = path
    text_render._table.cache_clear()

    # -- the replay against cv2
    rng = np.random.default_rng(0)
    from megreader_tpu.data.datasets import _WORDS

    def same(text, s, shape, org, hi=50):
        img = rng.integers(0, hi, shape + (3,), dtype=np.uint8)
        want = draw(img.copy(), text, org, s)
        got = text_render.put_text(img.copy(), text, org, s)
        assert np.array_equal(want, got), (text, s, shape, org)
        assert text_render.text_size(text, s) == size(text, s), (text, s)

    checks = 0
    for hi_val in (50, 256):
        for h in HEIGHTS:
            s = float(rng.uniform(h - 0.45, h + 0.45) * 0.037)
            s = min(max(s, lo_s), hi_s)
            pairs = [p + c for p in ALNUM for c in ALNUM] if hi_val == 50 else \
                [p + c for p in CHARS for c in CHARS[::7]]
            for t in pairs + list(_WORDS):
                same(t, s, (h + 40, 2 * h + 40), (10, h + 12), hi_val)
                checks += 1
    for lo, hi in bounds:
        for s in (lo, hi):
            for t in _WORDS:
                same(t, s, (80, 320), (5, 60))
                checks += 1
    for s in list(rng.uniform(lo_s, hi_s, 200)) + [lo_s, math.nextafter(hi_s, 0), hi_s]:
        s = float(s)
        n = int(rng.integers(1, 12))
        t = "".join(CHARS[int(i)] for i in rng.integers(0, len(CHARS), n))
        for text in (t, _WORDS[int(rng.integers(len(_WORDS)))]):
            (tw, th), _ = size(text, s)
            same(text, s, (th + 30, tw + 30), (int(rng.integers(0, 20)), th + 10))
            for org in ((-tw // 2, th), (tw // 2 + 10, th), (5, th // 2), (5, th + 28),
                        (-tw - 3, th), (5, -5), (tw + 40, th), (5, th * 3), (tw + 29, th),
                        (tw + 30, th), (tw + 31, th)):
                same(text, s, (th + 30, tw + 30), org, 256)
                same("j" + text, s, (th + 30, tw + 30), org, 256)
            checks += 23
    print(f"{path}: {os.path.getsize(path)} bytes, {len(bounds)} boundaries, {checks} renders "
          f"equal to cv2's")

    # -- the JAX package's items
    from megreader_tpu.data import datasets as jd

    manifest = {"digest": "sha256 of each array's C-order bytes (chip_smoke.py::item_digests)",
                "cv2": cv2.__version__, "items": {}}
    for name, cls, kw in SYNTH:
        ds = getattr(jd, cls)(**kw)
        manifest["items"][name] = {"class": cls, "kwargs": kw,
                                   "digests": [item_digests(ds[i]) for i in range(N_ITEMS)]}
    os.makedirs(os.path.join(args.out, "synth"), exist_ok=True)
    mpath = os.path.join(args.out, "synth", "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{mpath}: {sum(len(v['digests']) for v in manifest['items'].values())} items")


if __name__ == "__main__":
    main()

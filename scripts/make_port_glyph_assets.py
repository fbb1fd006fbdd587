#!/usr/bin/env python3
"""Write ``assets/glyphs/simplex_050.npz``: the label glyphs the port's
visualizer stamps where the JAX package calls ``cv2.putText``.

The JAX visualizer labels each polygon with ``cv2.putText(canvas, text, org,
FONT_HERSHEY_SIMPLEX, 0.5, (255, 64, 64), 1, LINE_AA)``. The card's machine
has no cv2 and no glyph data, so this script (run where cv2 is installed)
records what that call does, and the port replays it. What it found in
cv2 5.0.0, and checks again each time it runs:

* cv2 5 draws the Hershey font constants with filled, anti-aliased glyphs,
  not Hershey strokes. At scale 0.5 every printable ASCII character
  (32-126) advances the pen by a whole number of pixels, the same after any
  other character (no kerning), so each glyph has one pen phase: a string's
  glyph i lies at the org plus the sum of the advances before it, and is
  the glyph drawn alone, shifted;
* a glyph changes each pixel it touches by a function of that pixel's value
  before: the script draws each glyph on uniform canvases of every value
  0-255 and keeps, for each pixel it touches, the map from the value before
  to the value after, for the label's two channel values (255 in channel 0,
  64 in channels 1 and 2). The distinct maps are stored once;
* a character below 32 or at 127 is drawn as '?'. One above 127 is drawn
  from a Unicode font that the table does not hold (the port draws '?').

Arrays: ``advance`` (95,) int32 pixels; ``box`` (95, 4) int32 = (row and
column of the glyph's box relative to the org and the pen, height, width);
``start`` (95,) int64 offsets into ``index``, a flat int32 array of each
box's pixels (row-major; -1 where the glyph leaves the pixel as it is)
indexing ``luts`` (U, 2, 256) uint8 (the map for value 255, the map for
value 64); ``color`` (3,) = (255, 64, 64).

    python3 scripts/make_port_glyph_assets.py [--out assets/glyphs]
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT, SCALE, COLOR, THICKNESS, LINE = cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 64, 64), 1, cv2.LINE_AA
CHARS = [chr(c) for c in range(32, 127)]
ORG = (24, 40)
CANVAS = (64, 96)


def draw(text: str, value: int, org=ORG, width: int = CANVAS[1]) -> np.ndarray:
    img = np.full((CANVAS[0], width, 3), value, np.uint8)
    cv2.putText(img, text, org, FONT, SCALE, COLOR, THICKNESS, LINE)
    return img


def advance(c: str) -> int:
    """Pixels from c's pen to the next glyph's: where cv2 puts a following 'l'."""
    ref = draw("l", 0)[..., 0].astype(int)
    got = draw(c + "l", 0)[..., 0].astype(int) - draw(c, 0)[..., 0].astype(int)
    for shift in range(CANVAS[1] - ORG[0]):
        moved = np.roll(ref, shift, 1)
        if np.array_equal(got * (moved > 0), moved):
            return shift
    raise AssertionError(f"no advance found for {c!r}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "assets", "glyphs"))
    args = ap.parse_args()
    adv = np.array([advance(c) for c in CHARS], np.int32)
    values = np.arange(256, dtype=np.uint8)
    luts, lut_ids, index = [], {}, []
    box = np.zeros((len(CHARS), 4), np.int32)
    start = np.zeros(len(CHARS), np.int64)
    n_index = 0
    for ci, c in enumerate(CHARS):
        after = np.stack([draw(c, v) for v in range(256)])  # (256, H, W, 3)
        assert (after[..., 1] == after[..., 2]).all()
        touched = (after != values[:, None, None, None]).any(axis=(0, 3))
        start[ci] = n_index
        if not touched.any():
            continue
        rows, cols = np.nonzero(touched)
        r0, r1, c0, c1 = rows.min(), rows.max() + 1, cols.min(), cols.max() + 1
        assert r0 > 0 and c0 > 0 and r1 < CANVAS[0] and c1 < CANVAS[1], c
        idx = np.full((r1 - r0, c1 - c0), -1, np.int32)
        for r, k in zip(rows, cols):
            key = after[:, r, k, 0].tobytes() + after[:, r, k, 1].tobytes()
            if key not in lut_ids:
                lut_ids[key] = len(luts)
                luts.append(np.stack([after[:, r, k, 0], after[:, r, k, 1]]))
            idx[r - r0, k - c0] = lut_ids[key]
        box[ci] = (r0 - ORG[1], c0 - ORG[0], r1 - r0, c1 - c0)
        index.append(idx.reshape(-1))
        n_index += idx.size
    # one phase: the glyph after any other character is the glyph alone, moved
    for ci, c in enumerate(CHARS):
        for p in CHARS[1:]:
            first = draw(p, 0, width=160)[..., 0]
            got = draw(p + c, 0, width=160)[..., 0]
            alone = np.roll(draw(c, 0, width=160)[..., 0], int(adv[CHARS.index(p)]), 1)
            clear = first == 0  # pixels that only c touches
            assert np.array_equal(got[clear], alone[clear]), (p, c)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "simplex_050.npz")
    np.savez_compressed(path, advance=adv, box=box, start=start,
                        index=np.concatenate(index).astype(np.int32),
                        luts=np.stack(luts).astype(np.uint8), color=np.array(COLOR, np.int32))
    print(f"{path}: {len(luts)} maps, {n_index} pixels, {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()

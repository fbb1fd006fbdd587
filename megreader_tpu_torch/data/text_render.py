"""The synthetic datasets' text, drawn as cv2 5.0.0 draws it, without cv2.

The synthetic datasets size each word with ``cv2.getTextSize(text,
FONT_HERSHEY_SIMPLEX, scale, 2)`` and draw it with ``cv2.putText(img, text,
org, FONT_HERSHEY_SIMPLEX, scale, (235, 235, 235), 2, LINE_AA)``, the scale
in [0.8, 2.0]. cv2 5 draws the Hershey font constants with filled,
anti-aliased glyphs, and in that range, at thickness 2, it draws one of 33
fonts, one for each pixel height 22-54 that ``getTextSize`` reports
(``pixel_height``). In each of them:

* every printable ASCII character moves the pen by a whole number of
  pixels, the same after any character (no kerning), and the render moves
  by whole pixels with its origin;
* a glyph changes each pixel it covers by the blend
  ``(b (255 - a) + 235 a + 127) // 255`` of the value ``b`` before and its
  coverage ``a``, in each channel; a string is its glyphs blended one after
  another, and a glyph that leaves the image loses only the pixels outside,
  but a string whose origin lies at or right of the image's right edge
  draws nothing (even a first glyph that reaches back left, as 'j' does);
* ``getTextSize`` gives the width as the sum of the advances plus 1, the
  height as the pixel height, and the baseline as the largest descent of
  the string's glyphs.

``scripts/make_port_text_assets.py`` records each glyph's advance, descent
and coverage with cv2 into ``assets/glyphs/simplex_t2_aa.npz`` and checks
each of these findings again; this module replays the table. Anything the
table does not cover raises ``ValueError``. The table loads on first use.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "assets", "glyphs", "simplex_t2_aa.npz")
#: cv2's ``FONT_HERSHEY_SIMPLEX`` and ``LINE_AA``
FONT_HERSHEY_SIMPLEX = 0
LINE_AA = 16
THICKNESS = 2
COLOR = (235, 235, 235)
SCALE_RANGE = (0.8, 2.0)
HEIGHTS = (22, 54)


def pixel_height(scale: float) -> int:
    """The pixel height cv2 5 gives ``FONT_HERSHEY_SIMPLEX`` at thickness 2:
    ``scale * 100 / 3.7`` in float64, rounded half to even. Each of the 32
    boundaries in [0.8, 2.0] holds to the last float64 bit."""
    return int(np.rint(float(scale) * 100 / 3.7))


@functools.lru_cache(maxsize=1)
def _table():
    with np.load(TABLE) as z:
        t = {k: z[k] for k in z.files}
    t["code"] = {chr(int(c)): i for i, c in enumerate(t["chars"])}
    return t


def _check(text: str, scale: float, font: int, thickness: int) -> int:
    if font != FONT_HERSHEY_SIMPLEX:
        raise ValueError(f"text_render: font {font} is not in the table (only "
                         f"FONT_HERSHEY_SIMPLEX = {FONT_HERSHEY_SIMPLEX})")
    if thickness != THICKNESS:
        raise ValueError(f"text_render: thickness {thickness} is not in the table (only "
                         f"{THICKNESS})")
    if not SCALE_RANGE[0] <= float(scale) <= SCALE_RANGE[1]:
        raise ValueError(f"text_render: scale {scale} is outside {list(SCALE_RANGE)}")
    code = _table()["code"]
    for ch in text:
        if ch not in code:
            raise ValueError(f"text_render: character {ch!r} is not in the table")
    return pixel_height(scale) - HEIGHTS[0]


def text_size(text: str, scale: float, font: int = FONT_HERSHEY_SIMPLEX,
              thickness: int = THICKNESS) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, font, scale, thickness)``: ((width, height),
    baseline)."""
    k = _check(text, scale, font, thickness)
    t = _table()
    idx = [t["code"][ch] for ch in text]
    width = int(t["advance"][k, idx].sum()) + 1
    baseline = int(t["descent"][k, idx].max()) if idx else int(t["empty_baseline"][k])
    return (width, HEIGHTS[0] + k), baseline


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], scale: float,
             color=COLOR, font: int = FONT_HERSHEY_SIMPLEX, thickness: int = THICKNESS,
             line_type: int = LINE_AA) -> np.ndarray:
    """``cv2.putText(img, text, org, font, scale, color, thickness,
    line_type)`` on an (H, W, 3) uint8 image, in place, clipped at every
    edge; returns ``img``."""
    k = _check(text, scale, font, thickness)
    if tuple(int(c) for c in color) != COLOR:
        raise ValueError(f"text_render: colour {tuple(color)} is not in the table (only "
                         f"{COLOR})")
    if line_type != LINE_AA:
        raise ValueError(f"text_render: line type {line_type} is not in the table (only "
                         f"LINE_AA = {LINE_AA})")
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"text_render: takes (H, W, 3) uint8 images, got {img.dtype} "
                         f"{img.shape}")
    t = _table()
    H, W = img.shape[:2]
    pen, base = int(org[0]), int(org[1])
    if pen >= W:
        return img
    for ch in text:
        ci = t["code"][ch]
        dy, dx, h, w = (int(v) for v in t["box"][k, ci])
        y0, x0 = base + dy, pen + dx
        pen += int(t["advance"][k, ci])
        ys, xs = slice(max(y0, 0), min(y0 + h, H)), slice(max(x0, 0), min(x0 + w, W))
        if ys.start >= ys.stop or xs.start >= xs.stop:
            continue
        s = int(t["start"][k, ci])
        a = t["alpha"][s:s + h * w].reshape(h, w)
        a = a[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0].astype(np.int32)[..., None]
        region = img[ys, xs]
        region[...] = (region * (255 - a) + COLOR[0] * a + 127) // 255
    return img

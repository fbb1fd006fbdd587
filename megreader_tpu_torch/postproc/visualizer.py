"""Visualizers: polygons, transcriptions and heatmaps drawn over a page.

A port of the JAX package's ``postproc/visualizer.py``, which draws with
cv2; the card's machine has no cv2, so this module draws in numpy what cv2
5.0.0 draws, and writes PNGs through ``data/imageio.py``:

* ``polylines`` is ``cv2.polylines(img, [pts], closed, color, thickness)``
  (LINE_8, integer points), pixel for pixel. A thickness of 2 or more: each
  segment is first clipped (``clipLine``) to the image grown by the
  thickness on every side, then filled as the convex quadrilateral of its
  two ends moved by half the thickness along the normal (``FillConvexPoly``
  in 16-bit fixed point, its edges drawn by ``Line2`` and its rows scanned
  between two edge walkers), and its end gets a filled disc of radius
  thickness / 2 (``Circle``: the joints are round). A thickness of 1 (or 0,
  which cv2 draws alike): each segment clipped to the image, then walked by
  the 8-connected ``LineIterator`` from its left end (``Line``);
* the JET table of ``cv2.applyColorMap`` (RGB order);
* labels: ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5, (255, 64, 64), 1,
  LINE_AA)`` replayed from the glyph table that
  ``scripts/make_port_glyph_assets.py`` records with cv2
  (``assets/glyphs/simplex_050.npz``): each glyph's per-pixel maps from the
  value before to the value after, placed at the sum of the advances before
  it. A character below 32 or at 127 is drawn as '?', as cv2 draws it; one
  above 127 is drawn as '?' too, where cv2 5 draws it from a Unicode font
  the table does not hold.
"""

from __future__ import annotations

import functools
import math
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

from ..data.imageio import write_png

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
GLYPHS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "assets", "glyphs", "simplex_050.npz")
LABEL_COLOR = (255, 64, 64)


# ------------------------------------------------------------------ lines
def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` to [0, w-1] x [0, h-1]: (inside, x1, y1, x2, y2),
    the moved coordinates truncated toward zero."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(canvas: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    H, W = canvas.shape[:2]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    canvas[ys[ok], xs[ok]] = color


def _line2(canvas: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """cv2's ``Line2``: an 8-connected line between two 16-bit fixed-point
    points, one pixel a step along the major axis."""
    H, W = canvas.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(W << XY_SHIFT, H << XY_SHIFT, *p1, *p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if major_x:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        step = _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        step = _cdiv(dx << XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    half = XY_ONE >> 1
    _put(canvas, np.array([(x2 + half) >> XY_SHIFT]), np.array([(y2 + half) >> XY_SHIFT]), color)
    k = np.arange(max(count + 1, 0), dtype=np.int64)
    if major_x:
        _put(canvas, (x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT, color)
    else:
        _put(canvas, (x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k, color)


def _fill_convex(canvas: np.ndarray, v: Sequence[Tuple[int, int]], color) -> None:
    """cv2's ``FillConvexPoly`` of 16-bit fixed-point points (LINE_8): the
    edges by ``_line2``, then each row between the two edge walkers."""
    H, W = canvas.shape[:2]
    n = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(canvas, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + half) >> XY_SHIFT, (xmax + half) >> XY_SHIFT
    ymin, ymax = (ymin + half) >> XY_SHIFT, (ymax + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymin >= H or xmin >= W:
        return
    ymax = min(ymax, H - 1)
    edges = n
    idx_of, di = [imin, imin], [1, n - 1]
    ex, edx, eye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    y = ymin
    while True:
        for i in range(2):
            if y < eye[i]:
                continue
            idx0 = idx_of[i]
            idx = (idx0 + di[i]) % n
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    eye[i] = ty
                    edx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    ex[i] = xs
                    idx_of[i] = idx
                    break
                idx0 = idx
                idx = (idx + di[i]) % n
            else:
                edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1 = (ex[left] + half) >> XY_SHIFT
            xx2 = (ex[right] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < W:
                canvas[y, max(xx1, 0):min(xx2, W - 1) + 1] = color
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _hline(canvas: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    canvas[y, x1:x2 + 1] = color


def _disc(canvas: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """cv2's filled ``Circle``: the midpoint circle's rows."""
    H, W = canvas.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < W - radius and radius <= cy < H - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for yy, a, b in ((y11, x11, x12), (y12, x11, x12), (y21, x21, x22), (y22, x21, x22)):
                _hline(canvas, yy, a, b, color)
        elif x11 < W and x12 >= 0 and y21 < H and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, W - 1)
            for yy in (y11, y12):
                if 0 <= yy < H:
                    _hline(canvas, yy, x11, x12, color)
            if x21 < W and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, W - 1)
                for yy in (y21, y22):
                    if 0 <= yy < H:
                        _hline(canvas, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(canvas: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color,
                thickness: int, cap_start: bool) -> None:
    H, W = canvas.shape[:2]
    m = thickness
    ok, x0, y0, x1, y1 = _clip_line(W + 2 * m, H + 2 * m, p0[0] + m, p0[1] + m,
                                    p1[0] + m, p1[1] + m)
    if not ok:
        return
    a = ((x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT)
    b = ((x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT)
    dx = (a[0] - b[0]) / XY_ONE
    dy = (b[1] - a[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(round(dy * r)), int(round(dx * r))  # cvRound: half to even
        _fill_convex(canvas, [(a[0] + dpx, a[1] + dpy), (a[0] - dpx, a[1] - dpy),
                              (b[0] - dpx, b[1] - dpy), (b[0] + dpx, b[1] + dpy)], color)
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    for end, draw in ((a, cap_start), (b, True)):
        if draw:
            _disc(canvas, (end[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                  (end[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


def _line(canvas: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color) -> None:
    """cv2's ``Line`` (LINE_8): the segment clipped to the image
    (``clipLine``, only when an end lies outside), then the 8-connected
    ``LineIterator`` from its left end: ``dx + 1`` pixels along the major
    axis, the minor one stepping where the error ``dx - 2 dy (i + 1) +
    2 dx m`` falls below 0, i.e. ``m_i = ceil((2 dy i - dx) / (2 dx))``."""
    H, W = canvas.shape[:2]
    x1, y1, x2, y2 = p0[0], p0[1], p1[0], p1[1]
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        ok, x1, y1, x2, y2 = _clip_line(W, H, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // max(2 * major, 1))
    if dy > dx:
        canvas[y1 + sy * k, x1 + m] = color
    else:
        canvas[y1 + sy * m, x1 + k] = color


def polylines(canvas: np.ndarray, pts: np.ndarray, closed: bool, color,
              thickness: int = 2) -> np.ndarray:
    """Draw integer points (N, 2) as cv2.polylines does, in place; returns
    ``canvas``. A negative thickness raises, as cv2's assertion does."""
    if thickness < 0:
        raise ValueError(f"polylines: thickness {thickness} < 0")
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    if not pts:
        return canvas
    color = np.asarray(color, canvas.dtype)
    p0 = pts[-1] if closed else pts[0]
    for i in range(0 if closed else 1, len(pts)):
        if thickness <= 1:
            _line(canvas, p0, pts[i], color)
        else:
            _thick_line(canvas, p0, pts[i], color, thickness, cap_start=not closed and i == 1)
        p0 = pts[i]
    return canvas


# ----------------------------------------------------------------- colour
def jet_table() -> np.ndarray:
    """(256, 3) uint8: ``cv2.applyColorMap(v, COLORMAP_JET)`` in RGB. Each
    channel is clip(min(4v - lo, hi - 4v), 0, 255); cv2's float
    interpolation makes blue 1 (not 2) at v = 159."""
    v = np.arange(256)
    lut = np.stack([np.clip(np.minimum(4 * v - lo, hi - 4 * v), 0, 255)
                    for lo, hi in ((382, 1148), (128, 892), (-128, 638))], 1)
    lut[159, 2] = 1
    return lut.astype(np.uint8)


def heatmap_overlay(image: np.ndarray, prob_map: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """The page blended with the JET colours of ``prob_map`` (clipped to
    [0, 1], truncated to 0-255), truncated to uint8."""
    hm = jet_table()[(np.clip(prob_map, 0, 1) * 255).astype(np.uint8)]
    return (image.astype(np.float32) * (1 - alpha) + hm.astype(np.float32) * alpha
            ).astype(np.uint8)


# ----------------------------------------------------------------- labels
@functools.lru_cache(maxsize=1)
def _glyphs():
    with np.load(GLYPHS) as z:
        return {k: z[k] for k in z.files}


def put_label(canvas: np.ndarray, text: str, org: Tuple[int, int]) -> np.ndarray:
    """``cv2.putText(canvas, text, org, FONT_HERSHEY_SIMPLEX, 0.5, (255, 64,
    64), 1, LINE_AA)`` on an RGB uint8 canvas, in place; returns it."""
    g = _glyphs()
    H, W = canvas.shape[:2]
    pen = int(org[0])
    for ch in str(text):
        c = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
        ci = c - 32
        dy, dx, h, w = (int(v) for v in g["box"][ci])
        y0, x0 = int(org[1]) + dy, pen + dx
        ys, xs = slice(max(y0, 0), min(y0 + h, H)), slice(max(x0, 0), min(x0 + w, W))
        if ys.start < ys.stop and xs.start < xs.stop:
            idx = g["index"][g["start"][ci]:g["start"][ci] + h * w].reshape(h, w)
            sub = idx[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
            hit = sub >= 0
            if hit.any():
                region = canvas[ys, xs]
                lut = g["luts"][sub[hit]]  # (n, 2, 256)
                px = region[hit]
                n = np.arange(len(px))
                px[:, 0] = lut[n, 0, px[:, 0]]
                px[:, 1] = lut[n, 1, px[:, 1]]
                px[:, 2] = lut[n, 1, px[:, 2]]
                region[hit] = px
        pen += int(g["advance"][ci])
    return canvas


# ---------------------------------------------------------------- drawing
def draw_polygons(image: np.ndarray, polygons: Sequence[np.ndarray],
                  texts: Optional[Sequence[str]] = None, color=(0, 255, 0),
                  thickness: int = 2) -> np.ndarray:
    """A uint8 copy of ``image`` with each polygon outlined (its points
    truncated to integers) and, where ``texts`` has one, its label above it
    in (255, 64, 64)."""
    canvas = np.ascontiguousarray(image.astype(np.uint8).copy())
    if texts is not None and tuple(LABEL_COLOR) != tuple(_glyphs()["color"]):
        raise ValueError("the glyph table was recorded for another label colour")
    for i, poly in enumerate(polygons):
        poly = np.asarray(poly)
        polylines(canvas, np.asarray(poly, np.int32), True, color, thickness)
        if texts is not None and i < len(texts):
            org = (int(poly[:, 0].min()), max(12, int(poly[:, 1].min()) - 4))
            put_label(canvas, str(texts[i]), org)
    return canvas


class DetectionVisualizer:
    """Writes ``<workspace>/<name>.png``: the page with its polygons and
    texts, and the heatmap overlay beside it where a prob map is given.
    Without a ``workspace`` it writes into a new temporary directory (the
    JAX package's default is a fixed path under /tmp, which two checkouts
    would share)."""

    def __init__(self, workspace: Optional[str] = None):
        self.dir = workspace if workspace is not None else tempfile.mkdtemp(prefix="vis_")
        os.makedirs(self.dir, exist_ok=True)

    def visualize(self, name: str, image: np.ndarray, polygons: Sequence[np.ndarray],
                  texts: Optional[Sequence[str]] = None,
                  prob_map: Optional[np.ndarray] = None) -> str:
        canvas = draw_polygons(image, polygons, texts)
        if prob_map is not None:
            canvas = np.concatenate([canvas, heatmap_overlay(image, prob_map)], axis=1)
        path = os.path.join(self.dir, f"{name}.png")
        write_png(path, canvas)
        return path

"""Host-side detection ground truth: ICDAR parsing, polygon offset, maps.

A port of ``megreader_tpu/data/processes.py``: the shrink distance d = A (1 -
r^2) / perimeter, the convex edge-offset of a polygon (the C++ route of
``native/`` where ``g++`` is on the path, else numpy), and the rasterization of
the shrunk text maps and the border maps by ``raster.py``, cv2's fill, lines
and distance transform copied bit for bit. These are the host reference that
``ops/gt_maps.make_detection_gt`` is held against, and the maps of
``Experiment(device_gt=False)``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .raster import distance_transforms_l2_3, fill_poly, polylines


def polygon_area_signed(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def polygon_perimeter(poly: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.roll(poly, -1, axis=0) - poly, axis=1)))


def offset_polygon(poly: np.ndarray, distance: float) -> np.ndarray:
    """Offset a polygon by ``distance`` (negative: shrink) as float32: the
    C++ route (``native.offset_polygon``) where ``g++`` is on the path, else
    ``offset_polygon_numpy``."""
    poly = np.asarray(poly, np.float64)
    if len(poly) < 3:
        return poly
    from .. import native

    fast = native.offset_polygon(poly, distance)
    return fast if fast is not None else offset_polygon_numpy(poly, distance)


def offset_polygon_numpy(poly: np.ndarray, distance: float) -> np.ndarray:
    """Each edge moves along its outward normal and adjacent moved edges are
    intersected. Exact for convex polygons; nearly parallel neighbours
    (cross product under 1e-9) keep the moved vertex."""
    poly = np.asarray(poly, np.float64)
    n = len(poly)
    if n < 3:
        return poly
    ccw = polygon_area_signed(poly) > 0
    out = np.zeros_like(poly)
    shifted_a = np.zeros_like(poly)
    shifted_b = np.zeros_like(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        e = b - a
        L = np.linalg.norm(e)
        if L < 1e-9:
            normal = np.zeros(2)
        else:
            normal = np.array([e[1], -e[0]]) / L  # outward for a CCW polygon
            if not ccw:
                normal = -normal
        shifted_a[i] = a + normal * distance
        shifted_b[i] = b + normal * distance
    for i in range(n):
        p1, p2 = shifted_a[(i - 1) % n], shifted_b[(i - 1) % n]
        p3, p4 = shifted_a[i], shifted_b[i]
        d1 = p2 - p1
        d2 = p4 - p3
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-9:
            out[i] = p3
        else:
            t = ((p3[0] - p1[0]) * d2[1] - (p3[1] - p1[1]) * d2[0]) / denom
            out[i] = p1 + t * d1
    return out.astype(np.float32)


def shrink_distance(poly: np.ndarray, ratio: float = 0.4) -> float:
    """d = A (1 - r^2) / P."""
    A = abs(polygon_area_signed(np.asarray(poly, np.float64)))
    P = polygon_perimeter(np.asarray(poly, np.float64))
    return A * (1.0 - ratio**2) / max(P, 1e-6)


def make_seg_maps(
    polygons: Sequence[np.ndarray],
    ignore_flags: Sequence[bool],
    hw: Tuple[int, int],
    shrink_ratio: float = 0.4,
    min_text_size: int = 4,
) -> Dict[str, np.ndarray]:
    """Polygons -> {gt, mask}: shrunk text regions and valid pixels. Ignored
    texts, texts smaller than ``min_text_size`` and empty shrinks are masked
    out."""
    H, W = hw
    gt = np.zeros((H, W), np.float32)
    mask = np.ones((H, W), np.float32)
    for poly, ignore in zip(polygons, ignore_flags):
        poly = np.asarray(poly, np.float32)
        h = poly[:, 1].max() - poly[:, 1].min()
        w = poly[:, 0].max() - poly[:, 0].min()
        if ignore or min(h, w) < min_text_size:
            fill_poly(mask, poly.astype(np.int32), 0.0)
            continue
        shrunk = offset_polygon(poly, -shrink_distance(poly, shrink_ratio))
        if not np.all(np.isfinite(shrunk)) or \
                abs(polygon_area_signed(shrunk.astype(np.float64))) < 1.0:
            fill_poly(mask, poly.astype(np.int32), 0.0)
            continue
        fill_poly(gt, shrunk.astype(np.int32), 1.0)
    return {"gt": gt, "mask": mask}


def make_border_maps(
    polygons: Sequence[np.ndarray],
    ignore_flags: Sequence[bool],
    hw: Tuple[int, int],
    shrink_ratio: float = 0.4,
    thresh_min: float = 0.3,
    thresh_max: float = 0.7,
) -> Dict[str, np.ndarray]:
    """Threshold-map target: the distance falloff in the band around each
    non-ignored text's border, and the band itself."""
    H, W = hw
    canvas = np.zeros((H, W), np.float32)
    mask = np.zeros((H, W), np.float32)
    windows = []
    for poly, ignore in zip(polygons, ignore_flags):
        if ignore:
            continue
        poly = np.asarray(poly, np.float32)
        d = shrink_distance(poly, shrink_ratio)
        dilated = offset_polygon(poly, d)
        if not np.all(np.isfinite(dilated)):
            continue
        # work inside the dilated polygon's box (+1 px) only
        x0 = max(0, int(np.floor(dilated[:, 0].min())) - 1)
        y0 = max(0, int(np.floor(dilated[:, 1].min())) - 1)
        x1 = min(W, int(np.ceil(dilated[:, 0].max())) + 2)
        y1 = min(H, int(np.ceil(dilated[:, 1].max())) + 2)
        if x1 <= x0 or y1 <= y0:
            continue
        wh, ww = y1 - y0, x1 - x0
        off = np.array([x0, y0], np.float32)
        band = np.zeros((wh, ww), np.uint8)
        fill_poly(band, (dilated - off).astype(np.int32), 1)
        border = np.zeros((wh, ww), np.uint8)
        polylines(border, (poly - off).astype(np.int32), True, 1, thickness=1)
        windows.append((y0, y1, x0, x1, d, band, (1 - border).astype(np.uint8)))
    dists = distance_transforms_l2_3([w[-1] for w in windows])
    for (y0, y1, x0, x1, d, band, _), dist in zip(windows, dists):
        falloff = np.clip(1.0 - dist / max(d, 1e-6), 0.0, 1.0)
        canvas[y0:y1, x0:x1] = np.maximum(canvas[y0:y1, x0:x1], falloff * band)
        mask[y0:y1, x0:x1] = np.maximum(mask[y0:y1, x0:x1], band.astype(np.float32))
    thresh_map = canvas * (thresh_max - thresh_min) + thresh_min
    return {"thresh_map": thresh_map.astype(np.float32), "thresh_mask": mask}


def parse_icdar_gt(lines: Sequence[str]) -> Tuple[List[np.ndarray], List[bool], List[str]]:
    """ICDAR15 lines 'x1,y1,...,x4,y4,transcript' -> (polygons, ignored,
    texts); a '###' transcript marks a don't-care region."""
    polys, ignored, texts = [], [], []
    for line in lines:
        line = line.strip().lstrip("﻿")
        if not line:
            continue
        parts = line.split(",")
        polys.append(np.array([float(v) for v in parts[:8]], np.float32).reshape(4, 2))
        text = ",".join(parts[8:])
        ignored.append(text.strip() == "###")
        texts.append(text)
    return polys, ignored, texts

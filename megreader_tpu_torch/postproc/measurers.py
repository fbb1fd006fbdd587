"""Measurers: detection P/R/H-mean (ICDAR 2015 and DetEval protocols) and
recognition accuracy / normalized edit distance.

A copy of ``megreader_tpu/postproc/measurers.py`` (numpy and plain Python on
the host). Polygon intersections clip convex pairs exactly
(Sutherland-Hodgman: by ``native/``'s C++ where ``g++`` is on the path, else
in numpy) and rasterize non-convex ones (chain polygons) with
``data/raster.py::fill_poly``, a numpy copy of ``cv2.fillPoly`` that sets
the same pixels: the card's machine has no cv2.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..data.raster import fill_poly


def polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: ``subject`` clipped by the convex ``clip`` polygon."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        dx1, dy1 = p2[0] - p1[0], p2[1] - p1[1]
        dx2, dy2 = b[0] - a[0], b[1] - a[1]
        denom = dx1 * dy2 - dy1 * dx2
        if abs(denom) < 1e-12:
            return p2
        t = ((a[0] - p1[0]) * dy2 - (a[1] - p1[1]) * dx2) / denom
        return (p1[0] + t * dx1, p1[1] + t * dy1)

    # the inside test needs a counter-clockwise clip polygon
    x, y = clip[:, 0], clip[:, 1]
    if np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)) < 0:
        clip = clip[::-1]

    output = [tuple(p) for p in subject]
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_list, output = output, []
        if not input_list:
            break
        s = input_list[-1]
        for p in input_list:
            if inside(p, a, b):
                if not inside(s, a, b):
                    output.append(intersect(s, p, a, b))
                output.append(p)
            elif inside(s, a, b):
                output.append(intersect(s, p, a, b))
            s = p
    return np.array(output, np.float64) if output else np.zeros((0, 2))


def is_convex(poly: np.ndarray) -> bool:
    """True if the polygon's turns all share one sign (degenerate edges ok)."""
    p = np.asarray(poly, np.float64)
    e = np.roll(p, -1, axis=0) - p
    cross = e[:, 0] * np.roll(e, -1, axis=0)[:, 1] - e[:, 1] * np.roll(e, -1, axis=0)[:, 0]
    return bool(np.all(cross >= -1e-9) or np.all(cross <= 1e-9))


#: supersampling of the raster route; the fill includes boundary pixels,
#: which biases areas by about perimeter / (2 SS)
_RASTER_SS = 4


def _raster_masks(p1: np.ndarray, p2: np.ndarray):
    """Both polygons filled on their joint box at ``_RASTER_SS`` times the
    pixel grid (the route for non-convex polygons)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    lo = np.floor(np.minimum(p1.min(0), p2.min(0))) - 1
    hi = np.ceil(np.maximum(p1.max(0), p2.max(0))) + 1
    wh = np.maximum((hi - lo).astype(np.int64) * _RASTER_SS, 2)
    w, h = int(min(wh[0], 8192)), int(min(wh[1], 8192))
    m1 = np.zeros((h, w), np.uint8)
    m2 = np.zeros((h, w), np.uint8)
    fill_poly(m1, np.round((p1 - lo) * _RASTER_SS).astype(np.int32))
    fill_poly(m2, np.round((p2 - lo) * _RASTER_SS).astype(np.int32))
    return m1, m2


def polygon_iou(p1: np.ndarray, p2: np.ndarray) -> float:
    """IoU of two simple polygons. A convex pair is clipped exactly: the
    intersection by the C++ route (``native``) where ``g++`` is on the path,
    the two areas in numpy on the polygons' own dtype, as
    ``polygon_iou_numpy`` takes them (the JAX package's C++ route takes them
    in float64: its IoU of float32 quads lies up to 2e-7 from numpy's)."""
    if not (is_convex(p1) and is_convex(p2)):
        m1, m2 = _raster_masks(p1, p2)
        union = int(np.sum(m1 | m2))
        return int(np.sum(m1 & m2)) / union if union else 0.0
    from .. import native

    inter = native.polygon_intersection_area(p1, p2)
    if inter is None:
        return polygon_iou_numpy(p1, p2)
    union = polygon_area(p1) + polygon_area(p2) - inter
    return inter / union if union > 0 else 0.0


def polygon_iou_numpy(p1: np.ndarray, p2: np.ndarray) -> float:
    """IoU of two convex polygons, clipped in numpy."""
    inter_poly = clip_polygon(p1.astype(np.float64), p2.astype(np.float64))
    if len(inter_poly) < 3:
        return 0.0
    inter = polygon_area(inter_poly)
    union = polygon_area(p1) + polygon_area(p2) - inter
    return inter / union if union > 0 else 0.0


def polygon_intersection_area(p1: np.ndarray, p2: np.ndarray) -> float:
    """|p1 n p2| for simple polygons: a convex pair clipped exactly (the C++
    route where ``g++`` is on the path, else numpy), others rasterized."""
    if not (is_convex(p1) and is_convex(p2)):
        m1, m2 = _raster_masks(p1, p2)
        return float(np.sum(m1 & m2)) / (_RASTER_SS * _RASTER_SS)
    from .. import native

    fast = native.polygon_intersection_area(p1, p2)
    return fast if fast is not None else polygon_intersection_area_numpy(p1, p2)


def polygon_intersection_area_numpy(p1: np.ndarray, p2: np.ndarray) -> float:
    """|p1 n p2| of two convex polygons, clipped in numpy."""
    inter_poly = clip_polygon(p1.astype(np.float64), p2.astype(np.float64))
    return polygon_area(inter_poly) if len(inter_poly) >= 3 else 0.0


def polygon_intersection_over_self(p: np.ndarray, other: np.ndarray) -> float:
    """|p n other| / |p|: the don't-care overlap test."""
    a = polygon_area(p)
    if not (is_convex(p) and is_convex(other)):
        return polygon_intersection_area(p, other) / a if a > 0 else 0.0
    inter_poly = clip_polygon(p.astype(np.float64), other.astype(np.float64))
    if len(inter_poly) < 3:
        return 0.0
    return polygon_area(inter_poly) / a if a > 0 else 0.0


class DetectionMeasurer:
    """ICDAR 2015 protocol: greedy IoU matching at ``iou_thresh``; predictions
    that lie mostly in a don't-care ('###') region are dropped."""

    def __init__(self, iou_thresh: float = 0.5, ignore_overlap: float = 0.5):
        self.iou_thresh = iou_thresh
        self.ignore_overlap = ignore_overlap

    def measure_one(self, pred_polys: Sequence[np.ndarray], gt_polys: Sequence[np.ndarray],
                    gt_ignored: Sequence[bool]) -> Dict[str, int]:
        care_gt = [g for g, ig in zip(gt_polys, gt_ignored) if not ig]
        ignore_gt = [g for g, ig in zip(gt_polys, gt_ignored) if ig]
        kept = [p for p in pred_polys
                if not any(polygon_intersection_over_self(p, ig) > self.ignore_overlap
                           for ig in ignore_gt)]
        matched_gt = set()
        tp = 0
        for p in kept:
            best_iou, best_j = 0.0, -1
            for j, g in enumerate(care_gt):
                if j in matched_gt:
                    continue
                iou = polygon_iou(p, g)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= self.iou_thresh:
                matched_gt.add(best_j)
                tp += 1
        return {"tp": tp, "n_pred": len(kept), "n_gt": len(care_gt)}

    def gather(self, raws: List[Dict[str, int]]) -> Dict[str, float]:
        tp = sum(r["tp"] for r in raws)
        n_pred = sum(r["n_pred"] for r in raws)
        n_gt = sum(r["n_gt"] for r in raws)
        precision = tp / n_pred if n_pred else 0.0
        recall = tp / n_gt if n_gt else 0.0
        hmean = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        return {"precision": precision, "recall": recall, "hmean": hmean}


class DetEvalMeasurer:
    """DetEval (ICDAR 2013) area protocol: one-to-one, one-to-many and
    many-to-one matches from the area-recall and area-precision matrices
    (tr 0.8, tp 0.4; split and merge matches score ``split_penalty``)."""

    def __init__(self, tr: float = 0.8, tp: float = 0.4, split_penalty: float = 0.8):
        self.tr = tr
        self.tp = tp
        self.split_penalty = split_penalty

    def measure_one(self, pred_polys: Sequence[np.ndarray], gt_polys: Sequence[np.ndarray],
                    gt_ignored: Sequence[bool]) -> Dict[str, float]:
        care_gt = [g for g, ig in zip(gt_polys, gt_ignored) if not ig]
        ignore_gt = [g for g, ig in zip(gt_polys, gt_ignored) if ig]
        preds = [p for p in pred_polys
                 if not any(polygon_intersection_over_self(p, ig) > 0.5 for ig in ignore_gt)]
        nG, nD = len(care_gt), len(preds)
        if nG == 0 or nD == 0:
            return {"recall_acc": 0.0, "precision_acc": 0.0, "n_gt": nG, "n_pred": nD}

        R = np.zeros((nG, nD))
        P = np.zeros((nG, nD))
        for i, g in enumerate(care_gt):
            ag = polygon_area(g)
            for j, d in enumerate(preds):
                ad = polygon_area(d)
                x = polygon_intersection_area(g, d)
                R[i, j] = x / ag if ag > 0 else 0.0
                P[i, j] = x / ad if ad > 0 else 0.0

        gt_score = np.zeros(nG)
        det_score = np.zeros(nD)
        gt_used = np.zeros(nG, bool)
        det_used = np.zeros(nD, bool)
        for i in range(nG):  # one to one
            for j in range(nD):
                if (R[i, j] >= self.tr and P[i, j] >= self.tp
                        and (R[i, :] >= self.tr).sum() == 1 and (P[:, j] >= self.tp).sum() == 1):
                    gt_score[i] = det_score[j] = 1.0
                    gt_used[i] = det_used[j] = True
        for i in range(nG):  # one gt split over several detections
            if gt_used[i]:
                continue
            js = [j for j in range(nD) if not det_used[j] and P[i, j] >= self.tp]
            if len(js) >= 2 and R[i, js].sum() >= self.tr:
                gt_score[i] = self.split_penalty
                for j in js:
                    det_score[j] = self.split_penalty
                    det_used[j] = True
                gt_used[i] = True
        for j in range(nD):  # several gts merged in one detection
            if det_used[j]:
                continue
            is_ = [i for i in range(nG) if not gt_used[i] and R[i, j] >= self.tr]
            if len(is_) >= 2 and P[is_, j].sum() >= self.tp:
                det_score[j] = self.split_penalty
                for i in is_:
                    gt_score[i] = self.split_penalty
                    gt_used[i] = True
                det_used[j] = True
        return {"recall_acc": float(gt_score.sum()), "precision_acc": float(det_score.sum()),
                "n_gt": nG, "n_pred": nD}

    def gather(self, raws: List[Dict[str, float]]) -> Dict[str, float]:
        n_gt = sum(r["n_gt"] for r in raws)
        n_pred = sum(r["n_pred"] for r in raws)
        recall = sum(r["recall_acc"] for r in raws) / n_gt if n_gt else 0.0
        precision = sum(r["precision_acc"] for r in raws) / n_pred if n_pred else 0.0
        hmean = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        return {"precision": precision, "recall": recall, "hmean": hmean}


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class RecognitionMeasurer:
    """Exact-match accuracy + mean normalized edit distance (1 - d / max len)."""

    def __init__(self, case_sensitive: bool = False):
        self.case_sensitive = case_sensitive

    def measure(self, preds: Sequence[str], gts: Sequence[str]) -> Dict[str, float]:
        if len(preds) != len(gts):
            raise ValueError(f"{len(preds)} predictions for {len(gts)} ground truths")
        n = len(preds)
        if n == 0:
            return {"accuracy": 0.0, "ned": 0.0, "n": 0}
        correct, ned = 0, 0.0
        for p, g in zip(preds, gts):
            if not self.case_sensitive:
                p, g = p.lower(), g.lower()
            correct += p == g
            denom = max(len(p), len(g), 1)
            ned += 1.0 - edit_distance(p, g) / denom
        return {"accuracy": correct / n, "ned": ned / n, "n": n}

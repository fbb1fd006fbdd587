"""``data/raster.py`` against cv2 5.0.0 (its IPP build), bit for bit:
``distance_transform_l2_3`` against ``cv2.distanceTransform(m, DIST_L2, 3)``
on seeded masks (random densities, single zeros, the border-map shapes of
``make_border_maps``: a quad's outline in its window, vertices off it too,
long rows), ``fill_poly`` against ``cv2.fillPoly`` on float32 and uint8
canvases with vertices off the canvas (random polygons and ICDAR-style
quads leaving a page), the closed thin ``polylines``,
``get_perspective_transform`` and ``warp_perspective_linear`` over the
synthetic pages' range (rotation within 15 degrees, corner jitter 0.05)
and over seeded homographies, and ``fma32`` against exact rationals."""

from fractions import Fraction

import cv2
import numpy as np
import pytest

from megreader_tpu_torch.data import raster, text_render


def _masks(kind, n, seed):
    rng = np.random.default_rng(seed)
    for t in range(n):
        H, W = (int(v) for v in rng.integers(1, 90, 2))
        if kind == "random":
            yield (rng.random((H, W)) < rng.uniform(0.6, 1.0)).astype(np.uint8)
        elif kind == "border":
            border = np.zeros((H, W), np.uint8)
            pts = rng.integers(-10, max(H, W) + 10, (4, 2)).astype(np.int32)
            cv2.polylines(border, [pts], True, 1)
            yield (1 - border).astype(np.uint8)
        else:  # single zeros, one of them in the last row every other time
            m = np.ones((H, W), np.uint8)
            m[rng.integers(H), rng.integers(W)] = 0
            if t % 2:
                m[-1, rng.integers(W)] = 0
            yield m


@pytest.mark.parametrize("kind", ["random", "border", "zeros"])
def test_distance_transform_matches_cv2(kind):
    masks = list(_masks(kind, 120, {"random": 0, "border": 1, "zeros": 2}[kind]))
    for m in masks:
        np.testing.assert_array_equal(raster.distance_transform_l2_3(m),
                                      cv2.distanceTransform(m, cv2.DIST_L2, 3))
    # the batched passes equal the single ones
    for got, m in zip(raster.distance_transforms_l2_3(masks[:20]), masks[:20]):
        np.testing.assert_array_equal(got, raster.distance_transform_l2_3(m))


def test_distance_transform_long_rows_and_edge_cases():
    rng = np.random.default_rng(3)
    cases = [np.ones((5, 7), np.uint8), np.ones((1, 40), np.uint8), np.zeros((3, 3), np.uint8)]
    for H in (1, 2, 3, 4):
        for z in (0, 3, 10):
            m = np.ones((H, 260), np.uint8)
            m[H - 1, z] = 0
            cases.append(m)
        m = np.ones((H + 1, 260), np.uint8)
        m[H - 1, 0] = 0
        cases.append(m)
    cases += [(rng.random((int(h), int(w))) < 0.997).astype(np.uint8)
              for h, w in rng.integers(100, 300, (4, 2))]
    cases.append(np.ones((60, 1), np.uint8))
    cases[-1][30, 0] = 0
    for m in cases:
        np.testing.assert_array_equal(raster.distance_transform_l2_3(m),
                                      cv2.distanceTransform(m, cv2.DIST_L2, 3))


def _polygons(n, seed):
    rng = np.random.default_rng(seed)
    for t in range(n):
        H, W = (int(v) for v in rng.integers(3, 60, 2))
        if t % 3 == 0:  # inside the canvas
            pts = rng.integers(0, min(H, W), (int(rng.integers(3, 8)), 2))
        else:
            pts = rng.integers(-25, max(H, W) + 25, (int(rng.integers(3, 7)), 2))
        yield pts.astype(np.int32), H, W


def _icdar_quads(n, seed):
    """Rotated, jittered word quads, centred anywhere within 20 px of a
    page, as ``parse_icdar_gt`` reads them (truncated to int32 by the
    maps)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        H, W = (int(v) for v in rng.integers(50, 300, 2))
        w, h, ang = rng.integers(10, 200), rng.integers(8, 60), rng.uniform(-0.4, 0.4)
        c = np.array([rng.uniform(-20, W + 20), rng.uniform(-20, H + 20)])
        base = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
        R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        q = base @ R.T + c + rng.uniform(-3, 3, (4, 2))
        yield q.astype(np.float32).astype(np.int32), H, W


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("source", ["polygons", "icdar_quads"])
def test_fill_poly_matches_cv2(source, dtype):
    cases = _polygons(900, 4) if source == "polygons" else _icdar_quads(500, 5)
    for pts, H, W in cases:
        for start, value in ((0, 1), (1, 0)):  # as the maps fill: 1 on 0, 0 on 1
            want = np.full((H, W), start, dtype)
            cv2.fillPoly(want, [pts], value)
            got = raster.fill_poly(np.full((H, W), start, dtype), pts, value)
            np.testing.assert_array_equal(got, want, err_msg=f"{pts.tolist()} on {H}x{W}")


def test_closed_thin_polylines_match_cv2():
    for pts, H, W in _icdar_quads(300, 6):
        want = np.zeros((H, W), np.uint8)
        cv2.polylines(want, [pts], True, 1)
        got = raster.polylines(np.zeros((H, W), np.uint8), pts, True, 1, thickness=1)
        np.testing.assert_array_equal(got, want)


def _dataset_warps(n, seed):
    """The synthetic pages' patches, quads and homographies
    (``SyntheticDetectionDataset._paste_warped`` at max_rotate 15,
    max_persp 0.05)."""
    rng = np.random.default_rng(seed)
    words = ["megreader", "the", "42", "recognition", "jax", "pallas"]
    for _ in range(n):
        text, fs = words[int(rng.integers(len(words)))], float(rng.uniform(0.8, 2.0))
        (tw, th), _ = text_render.text_size(text, fs)
        ph, pw = th + 6, tw + 2
        patch = text_render.put_text(np.zeros((ph, pw, 3), np.uint8), text, (1, th + 1), fs)
        src = np.array([[0, 0], [pw - 1, 0], [pw - 1, ph - 1], [0, ph - 1]], np.float32)
        rot = np.deg2rad(rng.uniform(-15, 15))
        R = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]], np.float32)
        c = np.array([(pw - 1) / 2, (ph - 1) / 2], np.float32)
        dst = ((src - c) @ R.T) * (1.0 + rng.uniform(-0.05, 0.05, (4, 2)).astype(np.float32)) + c
        dst -= dst.min(axis=0)
        size = int(np.ceil(dst[:, 0].max())) + 1, int(np.ceil(dst[:, 1].max())) + 1
        yield patch, src, dst.astype(np.float32), size


def _seeded_warps(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(5, 80, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        src = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
        dst = (src + rng.uniform(-0.3, 0.3, (4, 2)) * [w, h]).astype(np.float32)
        yield img, src, dst, (int(rng.integers(1, 120)), int(rng.integers(1, 120)))


@pytest.mark.parametrize("source", ["dataset", "seeded"])
def test_perspective_transform_and_warp_match_cv2(source):
    cases = _dataset_warps(120, 7) if source == "dataset" else _seeded_warps(150, 8)
    for img, src, dst, size in cases:
        M = raster.get_perspective_transform(src, dst)
        np.testing.assert_array_equal(M, cv2.getPerspectiveTransform(src, dst))
        want = cv2.warpPerspective(img, M, size, flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(raster.warp_perspective_linear(img, M, size), want)
    gray = img[..., 0].copy()
    np.testing.assert_array_equal(raster.warp_perspective_linear(gray, M, size),
                                  cv2.warpPerspective(gray, M, size, flags=cv2.INTER_LINEAR))
    with pytest.raises(ValueError, match="uint8"):
        raster.warp_perspective_linear(img.astype(np.float32), M, size)


def test_fma32_rounds_once():
    rng = np.random.default_rng(9)
    a = rng.uniform(-300, 300, 20000).astype(np.float32)
    b = rng.uniform(-2, 2, 20000).astype(np.float32)
    c = rng.uniform(-300, 300, 20000).astype(np.float32)
    # sums that land on float32 midpoints: c set so that a * b + c is one
    half = np.spacing(np.float32(1)) / 2
    a[:50], b[:50] = np.float32(1) + np.float32(half) * 2, np.float32(1) + np.float32(half) * 2
    c[:50] = np.float32(0)
    got = raster.fma32(a, b, c)
    for x, y, z, g in zip(a[:3000].tolist() + a[-10:].tolist(), b[:3000].tolist() + b[-10:].tolist(),
                          c[:3000].tolist() + c[-10:].tolist(), got[:3000].tolist() + got[-10:].tolist()):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert np.float32(g) == best, (x, y, z)

"""The hard synthetic tier's cv2 and PIL calls against the port's numpy copies
on the CPU, bit for bit, at the tier's own parameter ranges and small sizes:

* the glyph table: every one of its 14,652 masks, baselines and advances
  against the JAX package's ``_char_mask`` (PIL for the DejaVu faces, cv2
  for the Hershey ones);
* ``raster.get_rotation_matrix_2d`` and ``warp_affine_linear`` (uint8 and
  float32, angles 0.1-20 degrees of both signs and 90, odd sizes and the
  tier's glyph patches and word masks);
* ``imageio.resize_cubic`` (cv2's own route for a source under 4 rows or
  columns, IPP's above), ``raster.gaussian_blur`` (k 3 and 5) and
  ``imageio.resize_area`` (factors 0.4-0.85, and exactly 2);
* ``jpeg.encode_coefficients`` against the coefficients of cv2's own file
  and ``jpeg_round_trip`` against ``cv2.imdecode(cv2.imencode(...))``, q
  25-79, 1 and 100, 1x1, odd sizes, 37x50 and 640x640;
* ``raster.polylines`` of one open segment against ``cv2.line`` at
  thickness 1-4.
"""

import cv2
import numpy as np
import pytest

from megreader_tpu.data import hard_synth as jax_hard
from megreader_tpu_torch.core.charset import Charset
from megreader_tpu_torch.data import hard_synth, imageio, jpeg, raster


def test_glyph_table_equals_the_jax_char_mask(monkeypatch):
    monkeypatch.setattr(hard_synth, "_CHAR_CACHE", {})
    t = hard_synth._glyph_table()
    fonts = hard_synth.available_fonts()
    jax_fonts = jax_hard.available_fonts()
    assert [hard_synth.font_label(f) for f in fonts] == list(t["fonts"]) == \
        [jax_hard.font_label(f) for f in jax_fonts]
    chars = Charset().alphabet
    assert "".join(chr(c) for c in t["chars"]) == chars
    assert list(t["heights"]) == list(range(12, 49))
    n = 0
    for font, jfont in zip(fonts, jax_fonts):
        for h in t["heights"]:
            for ch in chars:
                got = hard_synth._char_mask(font, int(h), ch)
                want = jax_hard._char_mask(jfont, int(h), ch)
                assert got[0].dtype == want[0].dtype
                assert np.array_equal(got[0], want[0]) and got[1:] == want[1:], (font, h, ch)
                n += 1
    assert n == 14_652


def test_rotation_matrix_equals_cv2():
    rng = np.random.default_rng(0)
    for _ in range(500):
        c = (float(rng.integers(0, 400)) / 2, float(rng.uniform(0, 300)))
        ang = float(rng.choice([-1, 1]) * rng.uniform(0, 90))
        want = cv2.getRotationMatrix2D(c, ang, 1.0)
        assert np.array_equal(raster.get_rotation_matrix_2d(c, ang, 1.0), want), (c, ang)


def _patch_case(rng, side):
    """A glyph patch as ``render_word`` builds it: a mask in the middle of a
    square of zeros, rotated about the pen centre on the baseline."""
    patch = np.zeros((side, side), np.uint8)
    gh, gw = int(rng.integers(4, side - 3)), int(rng.integers(4, side - 3))
    oy, ox = (side - gh) // 2, (side - gw) // 2
    patch[oy:oy + gh, ox:ox + gw] = rng.integers(0, 256, (gh, gw))
    return patch, (ox + float(rng.integers(1, 2 * gw)) / 2, float(oy + rng.integers(0, gh)))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_warp_affine_linear_equals_cv2(dtype):
    rng = np.random.default_rng(1 if dtype == "uint8" else 2)
    angles = [90.0, -90.0] + [float(s * a) for s in (1, -1) for a in (0.1, 0.5, 3, 7.7, 20)]
    angles += [float(rng.choice([-1, 1]) * rng.uniform(0.1, 20)) for _ in range(60)]
    for k, ang in enumerate(angles):
        if dtype == "uint8":  # glyph patches, odd and even sides
            img, c = _patch_case(rng, int(rng.integers(9, 75)))
            dsize = img.shape[::-1]
        else:  # word masks in [0, 1], the rotation moved to a tight box
            img = rng.random((int(rng.integers(5, 90)), int(rng.integers(5, 330)))).astype(
                np.float32)
            c = (img.shape[1] / 2.0, img.shape[0] / 2.0)
            dsize = (int(rng.integers(5, 360)), int(rng.integers(5, 160)))
        M = cv2.getRotationMatrix2D(c, ang, 1.0)
        if k % 2:
            M[:, 2] -= rng.uniform(-30, 30, 2)
        want = cv2.warpAffine(img, M, dsize, flags=cv2.INTER_LINEAR)
        got = raster.warp_affine_linear(img, M, dsize)
        assert got.dtype == want.dtype and np.array_equal(got, want), (k, ang, img.shape, dsize)


def test_resize_cubic_equals_cv2():
    """The texture's coarse noise grids upscaled to crops and pages; sources
    of 2-3 rows or columns take cv2's route, larger ones IPP's."""
    rng = np.random.default_rng(3)
    routes = set()
    for k in range(120):
        h, w = (640, 640) if k % 12 == 0 else (int(rng.integers(16, 100)),
                                               int(rng.integers(20, 400)))
        gh, gw = max(2, h // int(rng.integers(16, 64))), max(2, w // int(rng.integers(16, 64)))
        coarse = rng.uniform(-1, 1, (gh, gw, 3)).astype(np.float32)
        routes.add(min(gh, gw) >= 4)
        want = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
        got = imageio.resize_cubic(coarse, (w, h))
        assert got.dtype == np.float32 and np.array_equal(got, want), (gh, gw, h, w)
    assert routes == {False, True}


@pytest.mark.parametrize("k", [3, 5])
def test_gaussian_blur_equals_cv2(k):
    rng = np.random.default_rng(k)
    lo, hi = (0.24, 0.999) if k == 3 else (1.0, 1.4)
    for _ in range(60):
        h, w = int(rng.integers(1, 80)), int(rng.integers(1, 200))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        sigma = float(rng.uniform(lo, hi))
        assert max(3, int(sigma * 4) | 1) == k
        want = cv2.GaussianBlur(img, (k, k), sigma)
        assert np.array_equal(raster.gaussian_blur(img, k, sigma), want), (h, w, sigma)


def test_resize_area_equals_cv2():
    rng = np.random.default_rng(4)
    for n in range(80):
        h, w = int(rng.integers(8, 120)), int(rng.integers(8, 400))
        if n % 8 == 0:  # both factors exactly 2: cv2's fast route
            h, w = 2 * (h // 2), 2 * (w // 2)
            size = (w // 2, h // 2)
        else:
            f = float(rng.uniform(0.4, 0.85))
            size = (max(4, int(w * f)), max(4, int(h * f)))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
        assert np.array_equal(imageio.resize_area(img, size), want), (h, w, size)


JPEG_SIZES = [(1, 1), (1, 7), (9, 1), (13, 17), (37, 50), (50, 37), (16, 16), (31, 47),
              (640, 640)]


@pytest.mark.parametrize("hw", JPEG_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_jpeg_coefficients_and_round_trip_equal_cv2(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    qs = [1, 100] + [int(q) for q in rng.integers(25, 80, 3 if hw == (640, 640) else 8)]
    for k, q in enumerate(qs):
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        if k % 2:  # smooth content, as the degraded items carry
            img = cv2.GaussianBlur(img, (5, 5), 2)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
        assert ok
        ref = jpeg.read_coefficients(enc.tobytes())
        got = jpeg.encode_coefficients(img, q)
        assert got["factors"] == ref["factors"] == [(2, 2), (1, 1), (1, 1)]
        for a, b in zip(got["quant"], ref["quant"]):
            assert np.array_equal(a, b), q
        for c, (a, b) in enumerate(zip(got["blocks"], ref["blocks"])):
            assert a.shape == b.shape and np.array_equal(a, b), (q, c)
        want = cv2.imdecode(enc, cv2.IMREAD_COLOR)
        assert np.array_equal(jpeg.jpeg_round_trip(img, q), want), q


@pytest.mark.parametrize("thickness", [1, 2, 3, 4])
def test_underline_equals_cv2_line(thickness):
    """``cv2.line`` is an open polyline of one segment: the underline runs
    from x 0 to the crop's width (one past its last column)."""
    rng = np.random.default_rng(thickness)
    for _ in range(40):
        h, w = int(rng.integers(10, 70)), int(rng.integers(10, 300))
        y = int(rng.integers(-3, h + 3))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.line(img.copy(), (0, y), (w, y), color, thickness)
        got = raster.polylines(img.copy(), np.array([[0, y], [w, y]]), False, color, thickness)
        assert np.array_equal(got, want), (h, w, y, thickness)


@pytest.mark.parametrize("kind", ["wide", "midpoints", "tiny"])
def test_fma32_rounds_once_on_its_slow_path_cases(kind):
    """``fma32`` keeps the float64 sum unless it lands on a float32 midpoint
    or below float32's normal range; those cases (and ordinary ones) against
    the exact rational, rounded half to even."""
    from fractions import Fraction

    rng = np.random.default_rng(["wide", "midpoints", "tiny"].index(kind))
    n = 4000
    if kind == "wide":
        e = rng.integers(-30, 30, (3, n))
        a, b, c = ((rng.uniform(-1, 1, n) * 2.0 ** e[k]).astype(np.float32) for k in range(3))
    elif kind == "midpoints":  # a * b = half an ulp of c less 2^-30 of it: the float64
        # sum lands on a float32 midpoint that the exact sum misses
        scale = 2.0 ** rng.integers(-20, 20, n)
        c = (rng.uniform(1, 2, n) * scale).astype(np.float32)
        a = (2.0 ** -24 * (1 + 2.0 ** -15) * scale * rng.choice([-1, 1], n)).astype(np.float32)
        b = np.full(n, 1 - 2.0 ** -15, np.float32)
    else:
        a, b = ((rng.uniform(-1, 1, n) * 2.0 ** -70).astype(np.float32) for _ in range(2))
        c = (rng.uniform(-1, 1, n) * 2.0 ** -135).astype(np.float32)
    got = raster.fma32(a, b, c)
    for x, y, z, g in zip(a.tolist(), b.tolist(), c.tolist(), got.tolist()):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert np.float32(g) == best, (x, y, z)

"""The port's ``native/`` (``geometry.cpp`` through ctypes, built by g++
into ``build/native/``) against the JAX package's C++ route (the same
source under the same flags: equal), against the port's numpy routes at
``tests/test_native.py``'s bounds (1e-4 for the offset, 1e-6 for the IoU:
the routes' thresholds differ, 1e-12 in C++ and 1e-9 in numpy), and its
connected components against cv2. Then the dispatch: the numpy route only
where no g++ is on the path, and a build that fails raises."""

import shutil

import cv2
import numpy as np
import pytest

from megreader_tpu import native as jax_native
from megreader_tpu.data import processes as jax_processes
from megreader_tpu_torch import native
from megreader_tpu_torch.data import processes
from megreader_tpu_torch.postproc import measurers

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


def _convex(rng, n=4, scale=10.0):
    c = rng.random(2) * 50 + 25
    angles = np.sort(rng.random(n) * 2 * np.pi)
    r = rng.random(n) * scale + 6
    return np.stack([c[0] + r * np.cos(angles), c[1] + r * np.sin(angles)], 1)


def _pairs(rng, count=40):
    for i in range(count):
        p = _convex(rng, 4 + i % 5)
        yield p, p + rng.standard_normal(2) * 6 if i % 3 else p[::-1] + rng.standard_normal(2)


def test_builds_into_build_native_by_the_source_hash():
    assert native.AVAILABLE
    lib = native.library()
    assert lib is not None and native.target().exists()
    assert native.target().parent.name == "native" and native.target().parent.parent.name == "build"
    assert native.target().name.startswith("libgeometry_")
    assert native.SRC.read_bytes() == (
        native.SRC.parents[2] / "megreader_tpu" / "native" / "geometry.cpp").read_bytes()


def test_cpp_route_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    for p1, p2 in _pairs(rng):
        assert native.polygon_iou(p1, p2) == jax_native.polygon_iou(p1, p2)
        assert native.polygon_intersection_area(p1, p2) == \
            jax_native.polygon_intersection_area(p1, p2)
        for d in (-1.5, 2.0, -4.0):
            np.testing.assert_array_equal(native.offset_polygon(p1, d),
                                          jax_native.offset_polygon(p1, d))
    q = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float64)
    preds = np.stack([q, q + 5, q + 100, q * 1.5 + 2])
    gts = np.stack([q, q + 20, q + [3, 1]])
    np.testing.assert_array_equal(native.batch_quad_iou(preds, gts),
                                  jax_native.batch_quad_iou(preds, gts))
    mask = rng.random((64, 80)) > 0.6
    np.testing.assert_array_equal(native.connected_components(mask),
                                  jax_native.connected_components(mask))
    assert native.offset_polygon(q[:2], 1.0) is None  # fewer than 3 points


def test_cpp_route_matches_the_numpy_route():
    rng = np.random.default_rng(1)
    for _ in range(10):
        poly = _convex(rng)
        for d in (-1.5, 2.0):
            np.testing.assert_allclose(native.offset_polygon(poly, d),
                                       processes.offset_polygon_numpy(poly, d),
                                       rtol=1e-4, atol=1e-4)
    for _ in range(20):
        x0, y0, w, h = rng.random(4) * 20 + 2
        q1 = np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]])
        q2 = q1 + rng.standard_normal(2) * 6
        # the dispatchers the program calls, on the C++ route
        assert measurers.polygon_iou(q1, q2) == pytest.approx(
            measurers.polygon_iou_numpy(q1, q2), abs=1e-6)
        assert measurers.polygon_intersection_area(q1, q2) == pytest.approx(
            measurers.polygon_intersection_area_numpy(q1, q2), abs=1e-6)
        assert native.polygon_iou(q1, q2) == pytest.approx(measurers.polygon_iou_numpy(q1, q2),
                                                           abs=1e-6)


def test_batch_quad_iou():
    q = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float64)
    m = native.batch_quad_iou(np.stack([q, q + 5, q + 100]), np.stack([q, q + 20]))
    assert m.shape == (3, 2)
    assert m[0, 0] == pytest.approx(1.0)
    assert m[1, 0] == pytest.approx(25 / 175, abs=1e-6)
    assert m[2, 0] == 0.0


@pytest.mark.parametrize("shape,p", [((64, 80), 0.7), ((97, 131), 0.45), ((1, 50), 0.5)])
def test_connected_components_match_cv2(shape, p):
    mask = np.random.default_rng(2).random(shape) > p
    ours = native.connected_components(mask)
    n_cv, cv_lbl = cv2.connectedComponents(mask.astype(np.uint8), connectivity=4)
    assert ours.max() == n_cv - 1
    for cid in range(1, n_cv):
        got = np.unique(ours[cv_lbl == cid])
        assert len(got) == 1 and got[0] > 0
    assert ((ours == 0) == (cv_lbl == 0)).all()


def test_dispatch_takes_numpy_only_without_gxx(monkeypatch):
    """With g++ the dispatchers give the C++ answers (the JAX package's
    default route); without it, the numpy routes'."""
    rng = np.random.default_rng(3)
    poly, other = _convex(rng), _convex(rng)
    np.testing.assert_array_equal(processes.offset_polygon(poly, -2.0),
                                  jax_processes.offset_polygon(poly, -2.0))
    assert measurers.polygon_intersection_area(poly, other) == \
        native.polygon_intersection_area(poly, other)
    monkeypatch.setattr(native, "AVAILABLE", False)
    assert native.library() is None and native.offset_polygon(poly, 1.0) is None
    np.testing.assert_array_equal(processes.offset_polygon(poly, -2.0),
                                  processes.offset_polygon_numpy(poly, -2.0))
    assert measurers.polygon_iou(poly, other) == measurers.polygon_iou_numpy(poly, other)
    assert measurers.polygon_intersection_area(poly, other) == \
        measurers.polygon_intersection_area_numpy(poly, other)


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch, tmp_path):
    bad = tmp_path / "geometry.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build geometry.cpp:\n.*error"):
        native.library()
    assert not list((tmp_path / "build").iterdir())

"""ctypes bindings for the host geometry kernels of ``geometry.cpp``.

The source is built with ``g++`` on its first use into ``build/native/`` at
the repository root (listed in ``.gitignore``), named by the hash of the
source, and never beside it. ``AVAILABLE`` says which route is live: True
where ``g++`` is on the path, and then a build or a load that fails raises
with the compiler's message; False where it is not, and then every entry
point returns None and its caller takes its numpy route
(``data/processes.py::offset_polygon_numpy``,
``postproc/measurers.py::clip_polygon``).

The two routes differ in their thresholds: a degenerate edge or a pair of
parallel edges is one under 1e-12 in C++ and under 1e-9 in numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
AVAILABLE = shutil.which("g++") is not None

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def target() -> Path:
    """The library's path: ``build/native/libgeometry_<hash of the source>.so``."""
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libgeometry_{digest}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{done.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None where no ``g++``."""
    global _lib
    if not AVAILABLE:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        so = target()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        D = ctypes.POINTER(ctypes.c_double)
        lib.mr_polygon_area.restype = ctypes.c_double
        lib.mr_polygon_area.argtypes = [D, ctypes.c_int]
        lib.mr_offset_polygon.restype = ctypes.c_int
        lib.mr_offset_polygon.argtypes = [D, ctypes.c_int, ctypes.c_double, D]
        lib.mr_polygon_inter_area.restype = ctypes.c_double
        lib.mr_polygon_inter_area.argtypes = [D, ctypes.c_int, D, ctypes.c_int]
        lib.mr_batch_quad_iou.restype = None
        lib.mr_batch_quad_iou.argtypes = [D, ctypes.c_int, D, ctypes.c_int, D]
        lib.mr_connected_components.restype = ctypes.c_int
        lib.mr_connected_components.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def offset_polygon(poly: np.ndarray, distance: float) -> Optional[np.ndarray]:
    """The polygon offset by ``distance`` (negative: shrink) as float32, or
    None (no ``g++``, or fewer than 3 points)."""
    lib = library()
    if lib is None:
        return None
    p = _f64(poly)
    out = np.empty_like(p)
    rc = lib.mr_offset_polygon(_dptr(p), len(p), float(distance), _dptr(out))
    return out.astype(np.float32) if rc == 0 else None


def polygon_intersection_area(p1: np.ndarray, p2: np.ndarray) -> Optional[float]:
    """|p1 n p2| of two convex polygons."""
    lib = library()
    if lib is None:
        return None
    a, b = _f64(p1), _f64(p2)
    return lib.mr_polygon_inter_area(_dptr(a), len(a), _dptr(b), len(b))


def polygon_iou(p1: np.ndarray, p2: np.ndarray) -> Optional[float]:
    """IoU of two convex polygons, its areas in float64: the JAX package's
    C++ IoU. The program's ``measurers.polygon_iou`` does not call it: it
    takes ``polygon_intersection_area`` from here and the two areas in
    numpy on the polygons' own dtype, as its numpy route does (ROADMAP,
    traps: ``native``)."""
    lib = library()
    if lib is None:
        return None
    a, b = _f64(p1), _f64(p2)
    inter = lib.mr_polygon_inter_area(_dptr(a), len(a), _dptr(b), len(b))
    union = lib.mr_polygon_area(_dptr(a), len(a)) + lib.mr_polygon_area(_dptr(b), len(b)) - inter
    return inter / union if union > 0 else 0.0


def batch_quad_iou(preds: np.ndarray, gts: np.ndarray) -> Optional[np.ndarray]:
    """preds (P, 4, 2), gts (G, 4, 2) -> the (P, G) IoU matrix."""
    lib = library()
    if lib is None:
        return None
    p, g = _f64(preds), _f64(gts)
    out = np.zeros((len(p), len(g)), np.float64)
    lib.mr_batch_quad_iou(_dptr(p), len(p), _dptr(g), len(g), _dptr(out))
    return out


def connected_components(mask: np.ndarray) -> Optional[np.ndarray]:
    """(H, W) bool -> int32 labels: 0 background, 1..n the 4-connected
    components in raster order of their first pixel."""
    lib = library()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask, np.uint8)
    labels = np.zeros(m.shape, np.int32)
    lib.mr_connected_components(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                m.shape[0], m.shape[1],
                                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels

#!/usr/bin/env python3
"""libtiff through ``ctypes``, for tests that hold the port's TIFF reader
(``megreader_tpu_torch/data/tiff.py``, ``data/cielab.py``) to the library
step by step, not only to cv2's final image: the strips and tiles as
``TIFFReadEncodedStrip`` / ``TIFFReadEncodedTile`` leave them in a zeroed
buffer (codec, predictor, damaged data), and the CIE L*a*b* tables and
conversions of ``tif_color.c``.

The library is the one PIL's ``_imaging`` links (Pillow's wheels bundle
libtiff 4.7.1; cv2 5 carries its own 4.7.1, which the tests use as the
judge of whole images). Linux: the file is found in the process's maps.

    python3 scripts/libtiff_ctypes.py    # prints the library and its version
"""

from __future__ import annotations

import ctypes
import os
import tempfile
from typing import List, Sequence

import numpy as np

RANGE = 1500  # CIELABTORGB_TABLE_RANGE


class Display(ctypes.Structure):
    """``TIFFDisplay``."""
    _fields_ = [("d_mat", (ctypes.c_float * 3) * 3), ("d_YCR", ctypes.c_float),
                ("d_YCG", ctypes.c_float), ("d_YCB", ctypes.c_float),
                ("d_Vrwhite", ctypes.c_uint32), ("d_Vgwhite", ctypes.c_uint32),
                ("d_Vbwhite", ctypes.c_uint32), ("d_Y0R", ctypes.c_float),
                ("d_Y0G", ctypes.c_float), ("d_Y0B", ctypes.c_float),
                ("d_gammaR", ctypes.c_float), ("d_gammaG", ctypes.c_float),
                ("d_gammaB", ctypes.c_float)]


class CIELabToRGB(ctypes.Structure):
    """``TIFFCIELabToRGB``."""
    _fields_ = [("range", ctypes.c_int), ("rstep", ctypes.c_float), ("gstep", ctypes.c_float),
                ("bstep", ctypes.c_float), ("X0", ctypes.c_float), ("Y0", ctypes.c_float),
                ("Z0", ctypes.c_float), ("display", Display),
                ("Yr2r", ctypes.c_float * (RANGE + 1)), ("Yg2g", ctypes.c_float * (RANGE + 1)),
                ("Yb2b", ctypes.c_float * (RANGE + 1))]


def display_srgb() -> Display:
    """``tif_getimage.c``'s ``display_sRGB``."""
    d = Display()
    for i, row in enumerate(((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416),
                             (0.0556, -0.2040, 1.0570))):
        for j, v in enumerate(row):
            d.d_mat[i][j] = v
    d.d_YCR = d.d_YCG = d.d_YCB = 100.0
    d.d_Vrwhite = d.d_Vgwhite = d.d_Vbwhite = 255
    d.d_Y0R = d.d_Y0G = d.d_Y0B = 1.0
    d.d_gammaR = d.d_gammaG = d.d_gammaB = 2.4
    return d


def library() -> ctypes.CDLL:
    """PIL's libtiff, its functions bound and its messages silenced."""
    import PIL._imaging  # noqa: F401  (maps libtiff)

    with open("/proc/self/maps") as f:
        paths = sorted({ln.split()[-1] for ln in f if "libtiff" in ln.split()[-1]})
    if not paths:
        raise OSError("PIL's _imaging does not link libtiff")
    lib = ctypes.CDLL(paths[0])
    p, u32, f32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float
    for name, res, args in (
            ("TIFFOpen", p, [ctypes.c_char_p, ctypes.c_char_p]), ("TIFFClose", None, [p]),
            ("TIFFReadEncodedStrip", ctypes.c_ssize_t, [p, u32, p, ctypes.c_ssize_t]),
            ("TIFFReadEncodedTile", ctypes.c_ssize_t, [p, u32, p, ctypes.c_ssize_t]),
            ("TIFFCIELabToRGBInit", ctypes.c_int, [p, p, p]),
            ("TIFFCIELabToXYZ", None, [p, u32, ctypes.c_int32, ctypes.c_int32, p, p, p]),
            ("TIFFXYZToRGB", None, [p, f32, f32, f32, p, p, p]),
            ("TIFFGetVersion", ctypes.c_char_p, []),
            ("TIFFSetWarningHandler", p, [p]), ("TIFFSetErrorHandler", p, [p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    lib.TIFFSetWarningHandler(None)
    lib.TIFFSetErrorHandler(None)
    return lib


def cielab_state(lib: ctypes.CDLL, ref_white: Sequence[float]) -> CIELabToRGB:
    """``TIFFCIELabToRGBInit`` against ``display_sRGB`` and ``ref_white``
    (X0, Y0, Z0, float32 as ``initCIELabConversion`` computes them)."""
    state, display = CIELabToRGB(), display_srgb()
    white = (ctypes.c_float * 3)(*ref_white)
    if lib.TIFFCIELabToRGBInit(ctypes.byref(state), ctypes.byref(display), white) < 0:
        raise ValueError("TIFFCIELabToRGBInit failed")
    return state


def lab8_to_rgb(lib: ctypes.CDLL, state: CIELabToRGB, lab: np.ndarray) -> np.ndarray:
    """(n, 3) bytes (L*, then a* and b* as signed bytes) -> (n, 3) RGB by
    ``TIFFCIELabToXYZ`` then ``TIFFXYZToRGB``, as ``putcontig8bitCIELab8``."""
    x, y, z = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
    r, g, b = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
    out = np.zeros((len(lab), 3), np.int64)
    ref = ctypes.byref(state)
    for i, (lv, av, bv) in enumerate(np.asarray(lab, np.int64)):
        lib.TIFFCIELabToXYZ(ref, int(lv), int(av) - 256 * (av > 127), int(bv) - 256 * (bv > 127),
                            ctypes.byref(x), ctypes.byref(y), ctypes.byref(z))
        lib.TIFFXYZToRGB(ref, x, y, z, ctypes.byref(r), ctypes.byref(g), ctypes.byref(b))
        out[i] = r.value, g.value, b.value
    return out


def read_encoded(lib: ctypes.CDLL, data: bytes, sizes: Sequence[int],
                 tiles: bool = False) -> List[bytes]:
    """libtiff's decode of each strip (or tile) ``k`` of ``data`` into a
    zeroed buffer of ``sizes[k]`` bytes (the RGBA reader's is zeroed too),
    whatever the call returns."""
    read = lib.TIFFReadEncodedTile if tiles else lib.TIFFReadEncodedStrip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.tif")
        with open(path, "wb") as f:
            f.write(data)
        tif = lib.TIFFOpen(path.encode(), b"r")
        if not tif:
            raise ValueError("TIFFOpen failed")
        out = []
        for k, size in enumerate(sizes):
            buf = (ctypes.c_uint8 * size)()
            read(tif, k, buf, size)
            out.append(bytes(buf))
        lib.TIFFClose(tif)
    return out


if __name__ == "__main__":
    lib = library()
    print(lib._name)
    print(lib.TIFFGetVersion().decode().splitlines()[0])

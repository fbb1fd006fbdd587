"""CIE L*a*b* to RGB as libtiff's RGBA reader converts it (``tif_color.c``,
``initCIELabConversion`` in ``tif_getimage.c``), bit-equal to cv2 5
(libtiff 4.7), in numpy float32 as libtiff computes in C ``float``.

* 8-bit samples are widened first (``TIFFCIELabToXYZ``): L* times 257,
  a* and b* (signed bytes) times 256; 16-bit samples are read as they are
  (``TIFFCIELab16ToXYZ``: L* unsigned, a* and b* signed, 256 times the
  CIE values).
* L*a*b* to XYZ against the reference white ``refWhite``: Y = 100, X and
  Z from the WhitePoint tag's chromaticity (x, y), by default D50's
  (96.425, 100, 82.468 normalised to their sum, in float32).
* XYZ to RGB by ``display_sRGB``: a 3x3 matrix, each result clamped to
  [1, 100] (C's ternaries, so NaN becomes 1), an index into tables of
  1501 entries, ``255 * (i / 1500) ** (1 / 2.4)`` with ``pow`` in double
  and the result in float, rounded half away from zero (``RINT``) and
  capped at 255.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

f32 = np.float32

RANGE = 1500  # CIELABTORGB_TABLE_RANGE
#: display_sRGB's XYZ -> luminance matrix
MATRIX = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                   [0.0556, -0.2040, 1.0570]], f32)
_Y0, _YC, _WHITE, _GAMMA = f32(1.0), f32(100.0), 255, f32(2.4)
_D50 = (f32(96.4250), f32(100.0), f32(82.4680))


def default_white_point() -> Tuple[np.float32, np.float32]:
    """libtiff's default WhitePoint (``TIFFGetFieldDefaulted``): D50's x, y."""
    total = _D50[0] + _D50[1] + _D50[2]
    return _D50[0] / total, _D50[1] / total


def tables() -> Tuple[np.ndarray, np.float32]:
    """``TIFFCIELabToRGBInit``'s table (the same for red, green and blue)
    and step: ``Yr2r[i] = 255 * (float)pow(i / 1500., 1 / (double)2.4f)``,
    ``rstep = (100 - 1) / 1500``."""
    gamma = 1.0 / float(_GAMMA)
    table = f32(_WHITE) * np.power(np.arange(RANGE + 1) / RANGE, gamma).astype(f32)
    return table, (_YC - _Y0) / f32(RANGE)


def reference_white(white_point=None) -> Tuple[np.float32, np.float32, np.float32]:
    """``initCIELabConversion``'s refWhite (X0, Y0, Z0) from a WhitePoint
    (x, y), or the default's."""
    x, y = (f32(v) for v in (white_point or default_white_point()))
    return x / y * f32(100), f32(100), (f32(1) - x - y) / y * f32(100)


def lab16_to_rgb(lab: np.ndarray, white_point=None) -> np.ndarray:
    """(..., 3) L* (0..65535), a*, b* (-32768..32767) -> (..., 3) uint8 RGB
    (``TIFFCIELab16ToXYZ`` then ``TIFFXYZToRGB``)."""
    x0, y0, z0 = reference_white(white_point)
    lab = np.asarray(lab).astype(f32)
    big_l = lab[..., 0] * f32(100) / f32(65535)
    dark = big_l < f32(8.856)
    y_dark = (big_l * y0) / f32(903.292)
    cby = np.where(dark, f32(7.787) * (y_dark / y0) + f32(16.0 / 116.0),
                   (big_l + f32(16)) / f32(116))
    y = np.where(dark, y_dark, y0 * cby * cby * cby)

    def cube(t, w):
        return np.where(t < f32(0.2069), w * (t - f32(0.13793)) / f32(7.787), w * t * t * t)

    with np.errstate(over="ignore", invalid="ignore"):
        x = cube(lab[..., 1] / f32(256) / f32(500) + cby, x0)
        z = cube(cby - lab[..., 2] / f32(256) / f32(200), z0)
        table, step = tables()
        out = []
        for row in MATRIX:
            lum = row[0] * x + row[1] * y + row[2] * z
            lum = np.where(lum > _Y0, lum, _Y0)
            lum = np.where(lum < _YC, lum, _YC)
            i = np.minimum(((lum - _Y0) / step).astype(np.int64), RANGE)
            v = table[i].astype(np.float64)
            out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5).astype(np.int64), _WHITE))
    return np.stack(out, -1).astype(np.uint8)


def lab8_to_rgb(lab: np.ndarray, white_point=None) -> np.ndarray:
    """(..., 3) bytes: L* unsigned, a* and b* signed -> uint8 RGB
    (``TIFFCIELabToXYZ``: widened to 16 bits, then as ``lab16_to_rgb``)."""
    lab = np.asarray(lab, np.int64)
    ab = lab[..., 1:] - ((lab[..., 1:] & 0x80) << 1)
    return lab16_to_rgb(np.concatenate([lab[..., :1] * 257, ab * 256], -1), white_point)

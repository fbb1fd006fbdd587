"""cv2 5.0.0's raster operations on the host, in numpy, without cv2.

The host ground-truth maps and the synthetic pages call five cv2
functions; each is copied here from probes of cv2 5.0.0 (with its IPP
build) and held to it by ``tests/test_torch_port_raster.py``:

* ``fill_poly``: ``cv2.fillPoly(img, [pts], value)`` (LINE_8, no shift)
  on a 2-D canvas of any dtype. Each edge is drawn by ``cv2.line``
  (``postproc/visualizer.py::_line``), then on each row the edges that
  cross it (half-open in y), ordered by x and taken in pairs, fill the
  pixels whose centre lies in [x_left, x_right). An edge's x is 16.16
  fixed point: inside the canvas it starts half a pixel right of its top
  vertex and steps by the truncated quotient of its run over its rise; an
  edge with an end outside is clipped (``clipLine``): where the clipped
  ends lie on different rows, it runs through the clipped ends moved a
  whole pixel right, extended to the rows of its own ends; where they lie
  on one row (the edge touches the canvas at one point at most), it keeps
  its own line, and if a clipped end lies in the first or last column it
  also fills that column on the edge's rows. (Found on probes, 4,000
  seeded polygons off the canvas all equal.)
* ``polylines``: ``cv2.polylines(img, [pts], True, value, 1)``, from
  ``postproc/visualizer.py``.
* ``distance_transform_l2_3``: ``cv2.distanceTransform(m, DIST_L2, 3)``.
  The IPP routine cv2 5 calls runs the 3x3 chamfer (weights 0.955 and
  1.3693 as float32) in float32, in two raster passes. The backward pass
  (bottom to top, right to left) takes each pixel's minimum over itself,
  its three lower neighbours and its right neighbour, one pixel at a time.
  The forward pass does so over the three upper neighbours and the left
  one, except on the other rows: on the rows between the first and the
  last, columns 4k to 4k + 3 (k >= 1, 4k + 3 <= width - 2) go as one
  block, whose pixels see the column before the block at 1-4 times 0.955
  (as float32 products) and the zeros inside the block, but not each
  other; the last row (of two or more) also sees the pixel two to the left
  at 2 x 0.955. The order of the float32 additions is what makes the copy
  bit-equal; this one runs each pass as wavefronts of pixels that depend
  only on earlier ones. (Found on probes: 600 seeded masks, border-map
  shapes among them, all equal.)
* ``get_perspective_transform``: cv2's 8x8 system (its products of
  float32 coordinates rounded to float32) solved by cv2's own Gaussian
  elimination with partial pivoting, in float64.
* ``warp_perspective_linear``: ``cv2.warpPerspective(img, M, dsize,
  flags=INTER_LINEAR)`` on uint8 images with ``BORDER_CONSTANT`` 0: the
  inverse of M (cv2's 3x3 adjugate over the determinant, float64) rounded
  to float32; each destination pixel's source point in float32 with fused
  multiply-adds, in two forms (the first ``width - width % 16`` pixels of
  a row, and the rest); the four neighbours blended by three fused
  multiply-adds and rounded half to even.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..postproc.visualizer import _clip_line, _line, polylines  # noqa: F401

_SHIFT = 16
_ONE = 1 << _SHIFT
_F32 = np.float32
_INF = np.finfo(np.float32).max
_HV = _F32(0.955)
_DG = _F32(1.3693)
#: k * 0.955 as float32 products, k = 0..4
_HV_TIMES = [_F32(k) * _HV for k in range(5)]


# ------------------------------------------------------------------ fill
def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(img: np.ndarray, pts: np.ndarray, value=1) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], value)`` for one polygon of integer
    points (N, 2) on a 2-D canvas, in place; returns ``img``."""
    H, W = img.shape[:2]
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    edges, columns = [], []
    for i in range(len(pts)):
        xa, ya = (int(v) for v in pts[i - 1])
        xb, yb = (int(v) for v in pts[i])
        _line(img, (xa, ya), (xb, yb), value)
        if ya == yb:
            continue
        a = [(xa << _SHIFT) + (_ONE >> 1), ya]
        b = [(xb << _SHIFT) + (_ONE >> 1), yb]
        if not (0 <= xa < W and 0 <= xb < W and 0 <= ya < H and 0 <= yb < H):
            _, cxa, cya, cxb, cyb = _clip_line(W, H, xa, ya, xb, yb)
            if cya != cyb:
                a, b = [(cxa << _SHIFT) + _ONE, cya], [(cxb << _SHIFT) + _ONE, cyb]
            else:  # touches the canvas at one point at most
                columns += [(cx, min(ya, yb), max(ya, yb)) for cx in {cxa, cxb}
                            if cx in (0, W - 1)]
        dx = _cdiv(b[0] - a[0], b[1] - a[1])
        top, y0, y1 = (a, ya, yb) if ya < yb else (b, yb, ya)
        edges.append((y0, y1, top[0] + (y0 - top[1]) * dx, dx))
    for cx, y0, y1 in columns:
        img[max(y0, 0):max(min(y1, H), 0), cx] = value
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    y0, y1 = np.maximum(e[:, 0], 0), np.minimum(e[:, 1], H)
    rows = np.maximum(y1 - y0, 0)
    if rows.sum() == 0:
        return img
    edge = np.repeat(np.arange(len(e)), rows)
    y = y0[edge] + (np.arange(rows.sum()) - np.repeat(np.cumsum(rows) - rows, rows))
    x = e[edge, 2] + (y - e[edge, 0]) * e[edge, 3]
    order = np.lexsort((x, y))
    y, x = y[order].reshape(-1, 2)[:, 0], x[order].reshape(-1, 2)
    # pixel j's centre lies in [x_left, x_right): ceil(x_l) - 1 <= j < ceil(x_r) - 1
    lo = ((x[:, 0] + _ONE - 1) >> _SHIFT) - 1
    hi = ((x[:, 1] + _ONE - 1) >> _SHIFT) - 1
    lo, hi = np.clip(lo, 0, W), np.clip(hi, 0, W)
    ok = hi > lo
    lo, hi, y = lo[ok], hi[ok], y[ok]
    if len(y) == 0:
        return img
    top = int(y.min())
    span = np.zeros((int(y.max()) - top + 1, W + 1), np.int32)
    np.add.at(span, (y - top, lo), 1)
    np.add.at(span, (y - top, hi), -1)
    img[top:top + len(span)][np.cumsum(span, 1)[:, :W] > 0] = value
    return img


# ------------------------------------------------------ distance transform
def _sweep(P: np.ndarray, idx: np.ndarray, key: np.ndarray, nbr: np.ndarray,
           wts: np.ndarray, floor: np.ndarray) -> None:
    """One raster pass over the pixels at flat positions ``idx`` of ``P``:
    each becomes the least of ``P[idx + nbr] + wts`` (``nbr`` and ``wts``
    (k, n)) and ``floor``, in wavefronts of equal ``key`` (every neighbour
    a pixel reads has a smaller key)."""
    order = np.argsort(key, kind="stable")
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    idx, floor = idx[order], floor[order]
    nbr, wts = idx[None] + nbr[:, order], wts[:, order]
    for a, b in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [len(idx)]])):
        v = np.minimum.reduce(P[nbr[:, a:b]] + wts[:, a:b], axis=0)
        P[idx[a:b]] = np.minimum(v, floor[a:b])


def distance_transform_l2_3(src: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(src, DIST_L2, 3)`` of a 2-D uint8 array:
    float32, each pixel's chamfer distance to the nearest zero (FLT_MAX
    where there is none)."""
    return distance_transforms_l2_3([src])[0]


def distance_transforms_l2_3(srcs) -> list:
    """``distance_transform_l2_3`` of each array of ``srcs``, their passes
    run together (one wavefront loop for all)."""
    srcs = [np.asarray(m) for m in srcs]
    if not srcs:
        return []
    sizes = [(m.shape[0] + 2) * (m.shape[1] + 2) for m in srcs]
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    P = np.full(int(sum(sizes)), _INF, np.float32)  # each with a border of FLT_MAX
    parts = []
    for m, o in zip(srcs, base):
        H, W = m.shape
        S = W + 2
        ii, jj = np.divmod(np.arange(H * W), W)
        lane = jj % 4
        zero = (m == 0).reshape(-1)
        # forward: the three upper neighbours and a horizontal source, the
        # pixel before or, in a block, the column before the block
        blocked = (ii > 0) & (ii < H - 1) & (jj >= 4) & (jj - lane + 3 <= W - 2)
        back = np.where(blocked, lane + 1, 1)
        floor = np.where(zero, _F32(0), _INF).astype(np.float32)
        zgrid = zero.reshape(H, W)
        for k in (3, 2, 1):  # the nearest zero k lanes to the left inside the block
            left = np.zeros((H, W), bool)
            left[:, k:] = zgrid[:, :-k]
            hit = blocked & (lane >= k) & left.reshape(-1)
            floor[hit] = np.minimum(floor[hit], _HV_TIMES[k])
        # the last row (of two or more) also sees the pixel two to the left
        back2 = np.where((ii == H - 1) & (H > 1) & (jj >= 2), 2, back)
        parts.append(dict(idx=o + (ii + 1) * S + jj + 1, S=S, back=back, back2=back2,
                          floor=floor, fwd=2 * ii + jj, bwd=2 * (H - 1 - ii) + (W - 1 - jj)))
    cat = {k: np.concatenate([q[k] for q in parts])
           for k in ("idx", "back", "back2", "floor", "fwd", "bwd")}
    S = np.concatenate([np.full(len(q["idx"]), q["S"]) for q in parts])
    n = len(cat["idx"])
    times = np.array(_HV_TIMES, np.float32)
    nbr = np.stack([-S - 1, -S, -S + 1, -cat["back"], -cat["back2"]])
    wts = np.stack([np.full(n, _DG), np.full(n, _HV), np.full(n, _DG),
                    times[cat["back"]], times[cat["back2"]]]).astype(np.float32)
    _sweep(P, cat["idx"], cat["fwd"], nbr, wts, cat["floor"])
    # backward: itself, the three lower neighbours and the right one
    nbr = np.stack([np.zeros(n, np.int64), S + 1, S, S - 1, np.ones(n, np.int64)])
    wts = np.array([[0], [_DG], [_HV], [_DG], [_HV]], np.float32).repeat(n, 1)
    _sweep(P, cat["idx"], cat["bwd"], nbr, wts, np.full(n, _INF, np.float32))
    return [P[o:o + sz].reshape(m.shape[0] + 2, m.shape[1] + 2)[1:-1, 1:-1].copy()
            for m, o, sz in zip(srcs, base, sizes)]


# ---------------------------------------------------------- perspective
def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)`` for four float32 points
    each: the (3, 3) float64 homography."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        (sx, sy), (dx, dy) = s[i], d[i]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6], a[i][7] = float(-sx * dx), float(-sy * dx)  # float32 products
        a[i + 4][6], a[i + 4][7] = float(-sx * dy), float(-sy * dy)
        b[i], b[i + 4] = float(dx), float(dy)
    for i in range(8):  # cv2's LU: partial pivoting, rows scaled by -1 / pivot
        k = max(range(i, 8), key=lambda r: (abs(a[r][i]), -r))
        if abs(a[k][i]) < np.finfo(np.float64).eps * 10:
            raise ValueError("get_perspective_transform: the points are degenerate")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d_ = -1.0 / a[i][i]
        for j in range(i + 1, 8):
            alpha = a[j][i] * d_
            for c in range(i + 1, 8):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        t = b[i]
        for c in range(i + 1, 8):
            t -= a[i][c] * b[c]
        b[i] = t / a[i][i]
    return np.array(b + [1.0]).reshape(3, 3)


def _invert3(M: np.ndarray) -> np.ndarray:
    """cv2's ``invert`` of a 3x3 float64 matrix: adjugate times 1 / det."""
    m = [[float(v) for v in r] for r in np.asarray(M, np.float64)]
    det = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
           - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
           + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    if det == 0:
        return np.zeros((3, 3))
    d = 1.0 / det
    return np.array([
        [(m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d, (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
         (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d],
        [(m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d, (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d,
         (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d],
        [(m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d, (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
         (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d]])


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once. The float64 product of two
    float32 values is exact, and the float64 sum rounds it to float32
    correctly unless that sum lands on a float32 midpoint (or below
    float32's normal range): only those entries take the sum's own error
    (TwoSum) into account."""
    a64 = np.asarray(a, np.float32).astype(np.float64)
    b64 = np.asarray(b, np.float32).astype(np.float64)
    c64 = np.asarray(c, np.float32).astype(np.float64)
    s = a64 * b64 + c64
    r = np.asarray(s.astype(np.float32))
    bits = s.view(np.uint64) if s.ndim else np.asarray(s).reshape(1).view(np.uint64)
    odd = ((bits & 0x1FFFFFFF) == 0x10000000).reshape(s.shape)
    odd |= (np.abs(s) < 2.0 ** -126) & (s != 0)
    if not odd.any():
        return r
    a64, b64, c64 = (np.broadcast_to(v, s.shape)[odd] for v in (a64, b64, c64))
    p = a64 * b64
    t = p + c64
    bp = t - c64
    err = (p - bp) + (c64 - (t - bp))
    q = t.astype(np.float32)
    q64 = q.astype(np.float64)
    toward = np.nextafter(q, np.where(t > q64, _F32(np.inf), _F32(-np.inf)).astype(np.float32))
    mid = (t != q64) & (2 * (t - q64) == toward.astype(np.float64) - q64)
    wrong = mid & (err != 0) & ((err > 0) == (t > q64))
    r = np.array(r, copy=True)
    r[odd] = np.where(wrong, toward, q)
    return r


def warp_perspective_linear(img: np.ndarray, M: np.ndarray,
                            dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(img, M, dsize, flags=INTER_LINEAR)`` of an
    (H, W, C) or (H, W) uint8 image, ``dsize`` = (width, height), the
    border constant 0."""
    if img.dtype != np.uint8:
        raise ValueError(f"warp_perspective_linear takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        return warp_perspective_linear(img[..., None], M, dsize)[..., 0]
    w_out, h_out = (int(v) for v in dsize)
    m = _invert3(M).astype(np.float32).reshape(-1)
    y, x = np.mgrid[0:h_out, 0:w_out].astype(np.float32)
    head = x < w_out - w_out % 16

    def coord(k):
        # the first 16-pixel groups: fma(M_k0, x, M_k1 * y + M_k2); the rest:
        # fma(x, M_k0, y * M_k1) + M_k2
        body = fma32(m[3 * k], x, (y * m[3 * k + 1]) + m[3 * k + 2])
        tail = fma32(x, m[3 * k], y * m[3 * k + 1]) + m[3 * k + 2]
        return np.where(head, body, tail).astype(np.float32)

    w = coord(2)
    sx = (coord(0) / w).astype(np.float32)
    sy = (coord(1) / w).astype(np.float32)
    ok = np.isfinite(sx) & np.isfinite(sy) & (np.abs(sx) < 2 ** 30) & (np.abs(sy) < 2 ** 30)
    return _bilinear(img, np.where(ok, sx, -4), np.where(ok, sy, -4))


def _bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """The warps' bilinear sample of (H, W, C) ``img`` at float32 source
    points, taps outside the image 0: the four neighbours blended by three
    fused multiply-adds in float32, rounded half to even for uint8."""
    fx0, fy0 = np.floor(sx), np.floor(sy)
    fx = (sx - fx0).astype(np.float32)[..., None]
    fy = (sy - fy0).astype(np.float32)[..., None]
    ix, iy = fx0.astype(np.int64), fy0.astype(np.int64)
    H, W = img.shape[:2]

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(np.float32)
        return np.where(inside[..., None], v, _F32(0))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = fma32(fx, p01 - p00, p00)
    bot = fma32(fx, p11 - p10, p10)
    out = fma32(fy, bot - top, top)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


# ---------------------------------------------------------------- affine
def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the (2, 3) float64
    matrix, the centre taken as float32 (cv2's ``Point2f``) and the angle in
    degrees through ``std::cos``/``std::sin``."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = float(angle) * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(M: np.ndarray) -> np.ndarray:
    """cv2 ``warpAffine``'s inverse of a (2, 3) matrix, in float64."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m)


def warp_affine_linear(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR)`` of an (H, W, C)
    or (H, W) uint8 or float32 image, ``dsize`` = (width, height), the
    border constant 0: the inverse of M (float64) rounded to float32, each
    source point computed as ``warp_perspective_linear`` computes its
    numerators (without the division), and its bilinear blend."""
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"warp_affine_linear takes uint8 or float32 images, got {img.dtype}")
    if img.ndim == 2:
        return warp_affine_linear(img[..., None], M, dsize)[..., 0]
    w_out, h_out = (int(v) for v in dsize)
    m = _invert_affine(M).astype(np.float32)
    y, x = np.mgrid[0:h_out, 0:w_out].astype(np.float32)
    head = x < w_out - w_out % 16

    def coord(k):
        body = fma32(m[3 * k], x, (y * m[3 * k + 1]) + m[3 * k + 2])
        tail = fma32(x, m[3 * k], y * m[3 * k + 1]) + m[3 * k + 2]
        return np.where(head, body, tail).astype(np.float32)

    return _bilinear(img, coord(0), coord(1))


# ------------------------------------------------------------------ blur
def gaussian_kernel_q8(ksize: int, sigma: float) -> np.ndarray:
    """cv2's bit-exact 8-bit Gaussian kernel (``getGaussianKernelBitExact``
    then ``getGaussianKernelFixedPoint_ED``): exp(-(i - c)^2 / (2 sigma^2))
    in float64, normalised by its sum, then each half rounded to 8
    fractional bits with the rounding error carried to the next tap, and
    the centre tap made up to 256."""
    if ksize % 2 == 0 or ksize < 1 or sigma <= 0:
        raise ValueError(f"gaussian_kernel_q8: odd ksize and sigma > 0, got {ksize}, {sigma}")
    scale = -0.125 / (float(sigma) * float(sigma))
    t = [math.exp(float((2 * i - (ksize - 1)) ** 2) * scale) for i in range(ksize)]
    total = 0.0
    for v in t:
        total += v
    inv = 1.0 / total
    out = [0] * ksize
    err, acc = 0.0, 0
    for i in range(ksize // 2):
        adj = t[i] * inv * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
        acc += v
    out[ksize // 2] = 256 - 2 * acc
    return np.array(out, np.int64)


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source indices of ``BORDER_REFLECT_101`` for positions -pad .. n + pad - 1."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of an (H, W) or
    (H, W, C) uint8 image: cv2's fixed-point route, the kernel of
    ``gaussian_kernel_q8`` along rows then columns with ``BORDER_REFLECT_101``
    in exact integer sums, rounded half up from 16 fractional bits."""
    if img.dtype != np.uint8:
        raise ValueError(f"gaussian_blur takes uint8 images, got {img.dtype}")
    k = gaussian_kernel_q8(ksize, sigma)
    h, w = img.shape[:2]
    p = ksize // 2
    k = k.astype(np.int32)  # sums below 255 * 2^16
    x = img.astype(np.int32)[:, _reflect101(w, p)]
    rows = sum(k[i] * x[:, i:i + w] for i in range(ksize))[_reflect101(h, p)]
    out = sum(k[i] * rows[i:i + h] for i in range(ksize))
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)

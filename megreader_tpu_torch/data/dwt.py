"""JPEG 2000's inverse wavelet and component transforms as OpenJPEG 2.5
computes them (T.800 Annex F and G).

* ``idwt53``: the reversible 5/3 lifting in integers, each row of a level
  first, then each column, with whole-sample symmetric extension; a lone
  sample on an odd coordinate is halved (C's division, toward zero).
* ``idwt97``: the irreversible 9/7 lifting in float32, op for op as
  OpenJPEG's SSE lanes do it (no fused multiply-add): low-pass samples
  times K = 1.230174105, high-pass ones times 1.625732422 (OpenJPEG's
  ``two_invK``, which its step sizes leave out the subband gain for), then
  ``x += (left + right) * c`` with c = -delta, -gamma, -beta, -alpha in
  turn. A lone sample is left as it is.
* ``inverse_rct`` / ``inverse_ict``: the component transforms, the ICT in
  float32 with OpenJPEG's constants and order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_LIFTS = tuple(np.float32(-c) for c in (np.float32(0.443506852), np.float32(0.882911075),
                                           np.float32(-0.052980118), np.float32(-1.586134342)))


def _mirror(x: np.ndarray) -> np.ndarray:
    """x along its last axis with one sample mirrored on each side."""
    return np.concatenate([x[..., 1:2], x, x[..., -2:-1]], axis=-1)


def _inverse_53(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """One 5/3 level along the last axis: x holds sn low-pass then the
    high-pass samples; returns them interleaved and reconstructed."""
    n = x.shape[-1]
    out = np.empty_like(x)
    lo, hi = (0, 1) if cas == 0 else (1, 0)
    if n == 1:
        out[...] = x if cas == 0 else np.sign(x) * (np.abs(x) >> 1)
        return out
    out[..., lo::2] = x[..., :sn]
    out[..., hi::2] = x[..., sn:]
    p = _mirror(out)
    out[..., lo::2] -= (p[..., lo:n:2] + p[..., lo + 2:n + 2:2] + 2) >> 2
    p = _mirror(out)
    out[..., hi::2] += (p[..., hi:n:2] + p[..., hi + 2:n + 2:2]) >> 1
    return out


def _inverse_97(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    out = np.empty_like(x)
    lo, hi = (0, 1) if cas == 0 else (1, 0)
    out[..., lo::2] = x[..., :sn] * _K
    out[..., hi::2] = x[..., sn:] * _TWO_INV_K
    for step, c in enumerate(_LIFTS):
        at = lo if step % 2 == 0 else hi
        p = _mirror(out)
        out[..., at::2] = out[..., at::2] + (p[..., at:n:2] + p[..., at + 2:n + 2:2]) * c
    return out


def _idwt(a: np.ndarray, levels: List[Tuple[int, int, int, int]], one_d) -> np.ndarray:
    """``levels``: for each resolution from 1 up, (width, height, the
    width and height of the resolution below, the parities of its x0 and
    y0). ``a`` holds the tile-component with its subbands in place."""
    for rw, rh, sw, sh, cx, cy in levels:
        a[:rh, :rw] = one_d(a[:rh, :rw], sw, cx)
        a[:rh, :rw] = one_d(a[:rh, :rw].T, sh, cy).T
    return a


def idwt53(a: np.ndarray, levels) -> np.ndarray:
    return _idwt(a, levels, _inverse_53)


def idwt97(a: np.ndarray, levels) -> np.ndarray:
    return _idwt(a, levels, _inverse_97)


def inverse_rct(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    g = y - ((u + v) >> 2)
    return v + g, g, u + g


def inverse_ict(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    r = y + v * np.float32(1.402)
    g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
    b = y + u * np.float32(1.772)
    return r, g, b

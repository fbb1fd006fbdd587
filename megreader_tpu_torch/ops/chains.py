"""Chains: polygon outlines and band quads for curved text regions.

A port of ``megreader_tpu/ops/chains.py``. ``extract_chains`` slices each
region slot into S uniform bands along its principal axis u (from the slot's
``center``, ``theta`` and ``extent_u``) and reduces each band's perpendicular
coordinate v to a centre and a half-height; the band boundaries become a
spine of S + 1 points with local half-heights, tangents and normals.
``chains_to_band_quads`` turns a chain into S quads for the ruled-surface
unwarp (``ops/image.py::rectify_quads_mxu(warp='bilinear')``),
``chains_to_polygons`` into a closed outline, ``chain_arc_length`` measures
the spine and ``resample_width`` squeezes a crop onto its target width.

The JAX function builds (K, N) planes a page (u, v, the band index, a mask
a band). Here each pixel finds its slot through the root -> slot lookup of
``ops/ccl.py::extract_regions``, takes u and v from its slot's centre and
angle with the JAX function's float32 arithmetic, and one scatter-reduce
over the group slot * S + band gives each band's pixel count, v minimum and
v maximum: O(N) work and memory a page instead of O(K N). Counts, minima and
maxima are exact, so a band's statistics differ from JAX's only where a
pixel's u, v or band index does (an ulp of u can move a pixel on a band
boundary into the next band).

Slots are aligned with the statistics as the JAX function aligns them: the
roots are drawn again by the XLA candidate phase, with the candidate count
of the ``extract_impl`` that made the statistics (``'pallas_full'`` keeps
round_up(max(8K, 128), 128) candidates, the others max(8K, 128)), so row k
of the chains is row k of the statistics under every implementation. A slot
without a region has root 0, as there: its chain is taken over the pixels
labelled 0 (the component of pixel 0, if pixel 0 is foreground), with that
slot's own statistics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .ccl import _SPILL, _candidates, _top_k_slots
from .extract import pallas_k2

Chains = Dict[str, torch.Tensor]

#: pixel-slot pairs of the pixels labelled 0 computed at once
_ZERO_PAIRS = 1 << 22


def chain_roots(labels: torch.Tensor, K: int, extract_impl: str = "xla") -> torch.Tensor:
    """The root of each of the K slots of ``extract_regions(labels, ...,
    max_regions=K, impl=extract_impl)``: (B, K) int64, 0 for a slot without a
    region."""
    B = labels.shape[0]
    K2 = pallas_k2(K) if extract_impl == "pallas_full" else max(8 * K, 128)
    lbl = labels.reshape(B, -1).to(torch.int64)
    return _top_k_slots(*_candidates(lbl, K2), K)[1]


def _band_of(xs, ys, cx, cy, cos_t, sin_t, u0, width, S: int):
    """u, v and the band index of pixels at (xs, ys) in slots with these
    parameters (all float32, broadcast together), as the JAX function
    computes them."""
    dx = xs - cx
    dy = ys - cy
    u = dx * cos_t + dy * sin_t
    v = -dx * sin_t + dy * cos_t
    band = torch.clamp(torch.floor((u - u0) / width * S), 0, S - 1).to(torch.int64)
    return v, band


def _band_stats(labels: torch.Tensor, stats: Dict[str, torch.Tensor], roots: torch.Tensor,
                S: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (page, slot, band): pixel count (int64), v minimum and v maximum
    (float32; 1e9 / -1e9 where the band is empty), each (B, K, S)."""
    B, H, W = labels.shape
    N = H * W
    K = roots.shape[1]
    G = B * K * S
    dev = labels.device
    lbl = labels.reshape(B, N).to(torch.int64)
    cx, cy = stats["center"][..., 0], stats["center"][..., 1]
    theta = stats["theta"]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    u0 = stats["extent_u"][..., 0]
    width = torch.clamp(stats["extent_u"][..., 1] - u0, min=1e-3)
    params = torch.stack([cx, cy, cos_t, sin_t, u0, width], -1).to(torch.float32)  # (B, K, 6)

    count = torch.zeros(G + _SPILL, dtype=torch.int64, device=dev)
    v_lo = torch.full((G + _SPILL,), 1e9, dtype=torch.float32, device=dev)
    v_hi = torch.full((G + _SPILL,), -1e9, dtype=torch.float32, device=dev)

    def accumulate(group, v):
        count.scatter_add_(0, group, torch.ones_like(group))
        v_lo.scatter_reduce_(0, group, v, "amin")
        v_hi.scatter_reduce_(0, group, v, "amax")

    yy = torch.arange(H, device=dev, dtype=torch.float32).repeat_interleave(W)
    xx = torch.arange(W, device=dev, dtype=torch.float32).repeat(H)

    # pixels labelled > 0: the one slot whose root is their label (the
    # roots of slots with a region are distinct, and the others are 0)
    slot_of = torch.full((B, N + 2), K, dtype=torch.int64, device=dev)
    slot_of.scatter_(1, torch.where(roots > 0, roots, N + 1),
                     torch.arange(K, device=dev).expand(B, K))
    slot = slot_of.gather(1, torch.where(lbl > 0, lbl, N))  # (B, N); K: none
    member = slot < K
    page = torch.arange(B, device=dev)[:, None]
    p = params[page, torch.where(member, slot, 0)]  # (B, N, 6)
    v, band = _band_of(xx, yy, *p.unbind(-1), S)
    spill = G + torch.arange(N, device=dev) % _SPILL
    accumulate(torch.where(member, (page * K + slot) * S + band, spill).reshape(-1),
               v.reshape(-1))

    # pixels labelled 0 belong to every slot whose root is 0; pixel 0 is
    # foreground exactly when such pixels exist
    for b in torch.nonzero(lbl[:, 0] == 0).flatten().tolist():
        pix = torch.nonzero(lbl[b] == 0).flatten()
        slots = torch.nonzero(roots[b] == 0).flatten()
        step = max(1, _ZERO_PAIRS // max(1, pix.numel()))
        for s0 in range(0, slots.numel(), step):
            k = slots[s0:s0 + step, None]  # (m, 1)
            v, band = _band_of(xx[pix], yy[pix], *params[b, k].unbind(-1), S)
            accumulate(((b * K + k) * S + band).reshape(-1), v.reshape(-1))

    shape = (B, K, S)
    return count[:G].view(shape), v_lo[:G].view(shape), v_hi[:G].view(shape)


def _central(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Differences d (..., n - 1, ...) along ``dim`` -> (..., n, ...): the
    first and last as they are, the inner ones the mean of their two
    neighbours (central differences, one-sided at the ends)."""
    first = d.narrow(dim, 0, 1)
    last = d.narrow(dim, d.shape[dim] - 1, 1)
    n = d.shape[dim]
    inner = 0.5 * (d.narrow(dim, 0, n - 1) + d.narrow(dim, 1, n - 1))
    return torch.cat([first, inner, last], dim)


def _unit_normals(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit tangents and normals (+v side) of a polyline (..., P, 2)."""
    tang = _central(pts[..., 1:, :] - pts[..., :-1, :], -2)
    tang = tang / torch.clamp(torch.linalg.norm(tang, dim=-1, keepdim=True), min=1e-6)
    return tang, torch.stack([-tang[..., 1], tang[..., 0]], -1)


def extract_chains(labels: torch.Tensor, stats: Dict[str, torch.Tensor], n_bands: int = 8,
                   extract_impl: str = "xla") -> Chains:
    """(B, H, W) int32 labels and the batched statistics of
    ``extract_regions(..., impl=extract_impl)`` -> chains (B, K, S + 1, ...):
    ``points`` (x, y), unit ``tangent`` and ``normal`` (+v side),
    ``half_h`` (before any unclip) and ``band_alive`` (B, K, S)."""
    S = n_bands
    K = stats["center"].shape[1]
    roots = chain_roots(labels, K, extract_impl)
    cnt, v_lo, v_hi = _band_stats(labels, stats, roots, S)
    ok = cnt > 0
    c = torch.where(ok, 0.5 * (v_lo + v_hi), 0.0)  # (B, K, S)
    h = torch.where(ok, 0.5 * (v_hi - v_lo), 0.0)

    # empty bands: the v-centroid (0) and the mean live half-height
    n_ok = torch.clamp(ok.sum(-1), min=1)
    h_mean = (h * ok).sum(-1) / n_ok
    h = torch.where(ok, h, h_mean[..., None])

    # de-inflate: a band's v extent includes the spine's drift within it
    # (|dc/du| * band width / 2), the slope from neighbouring band centres
    width = torch.clamp(stats["extent_u"][..., 1] - stats["extent_u"][..., 0], min=1e-3)
    bw = width / S  # (B, K)
    if S >= 2:
        slope = _central(c[..., 1:] - c[..., :-1], -1) / bw[..., None]
        h = torch.clamp(h - torch.abs(slope) * bw[..., None] * 0.5, min=0.5)

    def to_boundaries(a):  # (B, K, S) -> (B, K, S + 1): ends extrapolated linearly
        inner = 0.5 * (a[..., :-1] + a[..., 1:])
        if S >= 2:
            first = 1.5 * a[..., :1] - 0.5 * a[..., 1:2]
            last = 1.5 * a[..., -1:] - 0.5 * a[..., -2:-1]
        else:
            first, last = a[..., :1], a[..., -1:]
        return torch.cat([first, inner, last], -1)

    vc = to_boundaries(c)
    hh = torch.clamp(to_boundaries(h), min=0.5)
    u0 = stats["extent_u"][..., 0]
    frac = torch.arange(S + 1, dtype=torch.float32, device=labels.device) / S
    ub = u0[..., None] + width[..., None] * frac  # (B, K, S + 1)
    theta = stats["theta"]
    cos_t, sin_t = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    cx, cy = stats["center"][..., 0:1], stats["center"][..., 1:2]
    px = cx + ub * cos_t - vc * sin_t
    py = cy + ub * sin_t + vc * cos_t
    pts = torch.stack([px, py], -1)  # (B, K, S + 1, 2)
    tang, normal = _unit_normals(pts)
    return {"points": pts, "tangent": tang, "normal": normal, "half_h": hh, "band_alive": ok}


def _resample_polyline(pts: torch.Tensor, hh: torch.Tensor, m: int):
    """A polyline (..., Q, 2) and its per-point scalars (..., Q) resampled to
    ``m`` points uniform in arc length, through the JAX function's (..., m,
    Q) interpolation matrix (a target on no half-open segment, the far end
    among them, takes the last one)."""
    seg = torch.clamp(torch.linalg.norm(pts[..., 1:, :] - pts[..., :-1, :], dim=-1), min=1e-6)
    q1 = seg.shape[-1]
    cum = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, -1)], -1)  # (..., Q)
    total = cum[..., -1:]
    a = total * (torch.arange(m, dtype=pts.dtype, device=pts.device) / (m - 1))  # (..., m)
    lo = cum[..., None, :-1]
    hi = cum[..., None, 1:]
    av = a[..., :, None]
    inside = (av >= lo) & (av < hi)  # (..., m, Q - 1)
    none = ~inside.any(-1, keepdim=True)
    last = torch.arange(q1, device=pts.device) == q1 - 1
    inside = inside | (none & last)
    frac = torch.clamp((av - lo) / seg[..., None, :], 0.0, 1.0)
    w_lo = torch.where(inside, 1.0 - frac, 0.0)
    w_hi = torch.where(inside, frac, 0.0)
    zero = torch.zeros_like(w_lo[..., :1])
    Wm = torch.cat([w_lo, zero], -1) + torch.cat([zero, w_hi], -1)  # (..., m, Q)
    return torch.einsum("...mq,...qc->...mc", Wm, pts), torch.einsum("...mq,...q->...m", Wm, hh)


def chains_to_band_quads(chains: Chains, unclip_distance: torch.Tensor = None) -> torch.Tensor:
    """Chains -> per-band quads (B, K, S, 4, 2), corners TL TR BR BL.

    ``unclip_distance`` (B, K): the spine's ends pushed out by d along their
    tangents and every half-height grown by d, then the spine resampled so
    that every band covers the same arc length."""
    pts, hh, tang = chains["points"], chains["half_h"], chains["tangent"]
    P = pts.shape[-2]
    if unclip_distance is not None:
        d = unclip_distance[..., None]  # (B, K, 1)
        pts_e = torch.cat([pts[..., :1, :] - tang[..., :1, :] * d[..., None], pts,
                           pts[..., -1:, :] + tang[..., -1:, :] * d[..., None]], -2)
        hh_e = torch.cat([hh[..., :1], hh, hh[..., -1:]], -1) + d
        pts, hh = _resample_polyline(pts_e, hh_e, P)
    _, nrm = _unit_normals(pts)
    top = pts - nrm * hh[..., None]
    bot = pts + nrm * hh[..., None]
    return torch.stack([top[..., :-1, :], top[..., 1:, :], bot[..., 1:, :], bot[..., :-1, :]],
                       -2)


def chains_to_polygons(chains: Chains, unclip_distance: torch.Tensor = None) -> torch.Tensor:
    """Chains -> closed polygons (B, K, 2(S + 1), 2): the top chain left to
    right, then the bottom chain right to left."""
    bq = chains_to_band_quads(chains, unclip_distance)
    top = torch.cat([bq[..., :, 0, :], bq[..., -1:, 1, :]], -2)
    bot = torch.cat([bq[..., :, 3, :], bq[..., -1:, 2, :]], -2)
    return torch.cat([top, bot.flip(-2)], -2)


def chain_arc_length(chains: Chains, unclip_distance: torch.Tensor = None) -> torch.Tensor:
    """The spine's length (B, K), with the unclip's two end extensions."""
    pts = chains["points"]
    L = torch.linalg.norm(pts[..., 1:, :] - pts[..., :-1, :], dim=-1).sum(-1)
    return L if unclip_distance is None else L + 2.0 * unclip_distance


def resample_width(crops: torch.Tensor, target_w: torch.Tensor, out_w: int) -> torch.Tensor:
    """Each (..., Ho, Wi, C) crop's full width squeezed onto the first
    ``target_w`` columns (at least 2) of a (..., Ho, out_w, C) canvas, the rest
    zero: a tent-weight contraction over the width."""
    *lead, Ho, Wi, C = crops.shape
    flat = crops.reshape(-1, Ho, Wi, C)
    tw = torch.clamp(target_w.reshape(-1).to(torch.float32), min=2.0)
    ox = torch.arange(out_w, dtype=torch.float32, device=crops.device)
    src = torch.clamp((ox + 0.5) * (Wi / tw)[:, None] - 0.5, 0.0, Wi - 1.0)  # (N, out_w)
    ix = torch.arange(Wi, dtype=torch.float32, device=crops.device)
    Wx = torch.clamp(1.0 - torch.abs(src[..., None] - ix), min=0.0).to(flat.dtype)
    out = torch.einsum("now,nhwc->nhoc", Wx, flat)
    col = ox.view(1, 1, out_w, 1) < tw[:, None, None, None]
    return (out * col).reshape(*lead, Ho, out_w, C)

"""Detection ground-truth maps rasterized on the device from polygon buffers.

A port of ``megreader_tpu/ops/gt_maps.py``: the DB targets of each page (the
shrunk text mask ``gt``, the valid-pixel ``mask``, the border band
``thresh_mask`` and its distance falloff ``thresh_map``) from padded (B, P, V,
2) convex polygons, in plain tensor code (the JAX package has no kernel here).

* A pixel centre is inside a convex polygon when its cross products with the
  edges share one sign; its distance to the boundary is the least
  point-to-segment distance over the edges.
* The shrink distance is d = A (1 - r^2) / perimeter. The shrunk region is
  {inside, distance >= d}, the band {inside or distance <= d}, the falloff
  clip(1 - distance / d, 0, 1) on the band.
* Ignored polygons, and polygons too small (min side < ``min_text_size``) or
  whose shrink is empty, mask their region out instead of contributing.

``tile_hw=None`` rasterizes every polygon on its whole page. The default tiles
each polygon's d-dilated bounding box (all tiles of the batch at once) and
merges them into the page maps by max and min, which do not depend on the
order; a page holding a valid polygon whose dilated box does not fit the tile
takes the whole-page path instead. Both give the same maps, bit for bit.

``pad_polygons`` is host-side: polygon lists to static buffers, refusing none
but warning once on a non-quad or non-convex polygon, which the rasterizer
approximates (the host maps of ``data/processes.py`` are exact for those).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _shrink_distance(polys: torch.Tensor, shrink_ratio: float) -> torch.Tensor:
    """(..., V, 2) -> (...) d = |area| (1 - r^2) / perimeter."""
    x, y = polys[..., 0], polys[..., 1]
    xn, yn = x.roll(-1, -1), y.roll(-1, -1)
    area = 0.5 * torch.abs((x * yn - y * xn).sum(-1))
    perim = torch.sqrt((xn - x) ** 2 + (yn - y) ** 2).sum(-1)
    return area * (1.0 - shrink_ratio**2) / torch.clamp(perim, min=1e-6)


def _rasterize(polys: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
               shrink_ratio: float, min_text_size: float):
    """M polygons (M, V, 2), each on its grid of pixel centres xs, ys (M or 1,
    h, w) -> shrunk, inside, band (M, h, w) bool, falloff (M, h, w), bad (M,)."""
    a = polys
    b = polys.roll(-1, 1)
    ex = (b[..., 0] - a[..., 0])[..., None, None]  # (M, V, 1, 1)
    ey = (b[..., 1] - a[..., 1])[..., None, None]
    px = xs[:, None] - a[..., 0][..., None, None]  # (M, V, h, w)
    py = ys[:, None] - a[..., 1][..., None, None]
    cross = ex * py - ey * px
    inside = (cross >= 0).all(1) | (cross <= 0).all(1)  # either orientation
    t = torch.clamp((px * ex + py * ey) / torch.clamp(ex * ex + ey * ey, min=1e-9), 0.0, 1.0)
    dx = px - t * ex
    dy = py - t * ey
    dist = torch.sqrt((dx * dx + dy * dy).amin(1))

    d = _shrink_distance(polys, shrink_ratio)[:, None, None]
    h = polys[..., 1].amax(-1) - polys[..., 1].amin(-1)
    w = polys[..., 0].amax(-1) - polys[..., 0].amin(-1)
    too_small = torch.minimum(h, w) < min_text_size
    shrunk = inside & (dist >= d)
    degenerate = shrunk.flatten(1).sum(1) < 1
    band = inside | (dist <= d)  # the convex dilation by d
    falloff = torch.clamp(1.0 - dist / torch.clamp(d, min=1e-6), 0.0, 1.0) * band
    return shrunk, inside, band, falloff, too_small | degenerate


def _roles(valid: torch.Tensor, ignore: torch.Tensor, bad: torch.Tensor):
    """(border polygons, contributing polygons, masked-out polygons)."""
    valid_f = valid & ~ignore
    return valid_f, valid_f & ~bad, valid & (ignore | (valid_f & bad))


def _gt_dense(polys, valid, ignore, hw, shrink_ratio, min_text_size, thresh_min, thresh_max):
    """One page: (P, V, 2) polygons rasterized on the whole page."""
    H, W = hw
    dev = polys.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    shrunk, inside, band, falloff, bad = _rasterize(polys, xs[None], ys[None], shrink_ratio,
                                                    min_text_size)
    border, contributes, masked_out = _roles(valid, ignore, bad)

    def any_of(m, sel):
        return (m & sel[:, None, None]).any(0)

    canvas = torch.where(border[:, None, None], falloff, 0.0).amax(0) if len(polys) \
        else torch.zeros((H, W), device=dev)
    return {
        "gt": any_of(shrunk, contributes).float(),
        "mask": 1.0 - any_of(inside, masked_out).float(),
        "thresh_map": canvas * (thresh_max - thresh_min) + thresh_min,
        "thresh_mask": any_of(band, border).float(),
    }


def _gt_tiled(polys, valid, ignore, hw, tile_hw, shrink_ratio, min_text_size,
              thresh_min, thresh_max):
    """Every polygon of the batch rasterized on a (TH, TW) tile over its
    d-dilated box, merged into the pages by max / min."""
    B, P = polys.shape[:2]
    H, W = hw
    TH, TW = min(tile_hw[0], H), min(tile_hw[1], W)
    dev = polys.device
    flat = polys.reshape(B * P, *polys.shape[2:])
    pad = _shrink_distance(flat, shrink_ratio) + 2.0
    x0 = torch.clamp(torch.floor(flat[..., 0].amin(-1) - pad), 0.0, float(W - TW)).to(torch.int64)
    y0 = torch.clamp(torch.floor(flat[..., 1].amin(-1) - pad), 0.0, float(H - TH)).to(torch.int64)
    iy = torch.arange(TH, device=dev)[None, :, None]
    ix = torch.arange(TW, device=dev)[None, None, :]
    xs = x0.to(torch.float32)[:, None, None] + ix.to(torch.float32)
    ys = y0.to(torch.float32)[:, None, None] + iy.to(torch.float32)
    shrunk, inside, band, falloff, bad = _rasterize(
        flat, xs.expand(-1, TH, TW), ys.expand(-1, TH, TW), shrink_ratio, min_text_size)
    border, contributes, masked_out = _roles(valid.reshape(-1), ignore.reshape(-1), bad)

    page = torch.arange(B * P, device=dev) // P
    idx = ((page[:, None, None] * H + y0[:, None, None] + iy) * W
           + x0[:, None, None] + ix).reshape(-1)

    def merge(init, tile, op):
        out = torch.full((B * H * W,), init, dtype=torch.float32, device=dev)
        return out.scatter_reduce_(0, idx, tile.reshape(-1).float(), op).view(B, H, W)

    sel = lambda m: m[:, None, None]  # noqa: E731
    canvas = merge(0.0, torch.where(sel(border), falloff, 0.0), "amax")
    return {
        "gt": merge(0.0, shrunk & sel(contributes), "amax"),
        "mask": merge(1.0, 1.0 - (inside & sel(masked_out)).float(), "amin"),
        "thresh_map": canvas * (thresh_max - thresh_min) + thresh_min,
        "thresh_mask": merge(0.0, band & sel(border), "amax"),
    }


def make_detection_gt(
    polygons: torch.Tensor,
    poly_valid: torch.Tensor,
    poly_ignore: torch.Tensor,
    hw: Tuple[int, int],
    shrink_ratio: float = 0.4,
    min_text_size: float = 4.0,
    thresh_min: float = 0.3,
    thresh_max: float = 0.7,
    tile_hw: Optional[Tuple[int, int]] = (192, 384),
) -> Dict[str, torch.Tensor]:
    """(B, P, V, 2) float32 pixel coordinates and (B, P) bool valid / ignore
    flags -> {gt, mask, thresh_map, thresh_mask}, each (B, H, W) float32 on
    the polygons' device. ``tile_hw=None``: every polygon on its whole page."""
    polygons = polygons.to(torch.float32)
    poly_valid, poly_ignore = poly_valid.bool(), poly_ignore.bool()
    args = (shrink_ratio, min_text_size, thresh_min, thresh_max)

    def dense(b):
        return _gt_dense(polygons[b], poly_valid[b], poly_ignore[b], hw, *args)

    B, P = poly_valid.shape
    if tile_hw is None or P == 0:
        pages = [dense(b) for b in range(B)]
        return {k: torch.stack([p[k] for p in pages]) for k in pages[0]} if B else {}
    out = _gt_tiled(polygons, poly_valid, poly_ignore, hw, tile_hw, *args)
    # a page with a valid polygon whose dilated box exceeds the tile is
    # rasterized whole instead
    TH, TW = min(tile_hw[0], hw[0]), min(tile_hw[1], hw[1])
    span = 2.0 * (_shrink_distance(polygons, shrink_ratio) + 2.0)
    bw = polygons[..., 0].amax(-1) - polygons[..., 0].amin(-1)
    bh = polygons[..., 1].amax(-1) - polygons[..., 1].amin(-1)
    too_big = (poly_valid & ((bw + span > TW) | (bh + span > TH))).any(1)
    for b in torch.nonzero(too_big).flatten().tolist():
        for k, v in dense(b).items():
            out[k][b] = v
    return out


_nonquad_warned = False


def _is_convex(p) -> bool:
    """Orientation-consistent cross-product test for a (V, 2) polygon."""
    e = np.roll(p, -1, axis=0) - p
    cross = e[:, 0] * np.roll(e, -1, axis=0)[:, 1] - e[:, 1] * np.roll(e, -1, axis=0)[:, 0]
    return bool(np.all(cross >= -1e-6) or np.all(cross <= 1e-6))


def pad_polygons(polys, ignore, max_polys: int, n_vertices: int = 4):
    """Host side: a list of (V, 2) arrays -> (max_polys, n_vertices, 2) float32
    buffer, valid and ignore flags. More polygons than ``max_polys`` raise.

    The rasterizer is exact for convex polygons only, and polygons of other
    vertex counts are resampled to ``n_vertices`` by index: the first such
    input warns (datasets with such annotations should use the host maps,
    ``Experiment(device_gt=False)``)."""
    global _nonquad_warned

    if len(polys) > max_polys:
        raise ValueError(
            f"{len(polys)} polygons exceed buffer capacity {max_polys}; "
            "size the buffer to the batch (detection_collate_polys does)"
        )
    buf = np.zeros((max_polys, n_vertices, 2), np.float32)
    valid = np.zeros((max_polys,), bool)
    ign = np.zeros((max_polys,), bool)
    for i, (p, ig) in enumerate(zip(polys, ignore)):
        p = np.asarray(p, np.float32)
        if p.shape[0] != n_vertices or not _is_convex(p):
            if p.shape[0] != n_vertices:
                p = p[np.linspace(0, p.shape[0] - 1, n_vertices).round().astype(int)]
            if not _nonquad_warned:
                import warnings

                warnings.warn(
                    "device-GT path received a non-quad or non-convex polygon; it will be "
                    "approximated by a (possibly decimated) convex rasterization. For "
                    "curved/polygon annotations use Experiment(device_gt=False): the host "
                    "maps rasterize arbitrary polygons exactly.",
                    stacklevel=3,
                )
                _nonquad_warned = True
        buf[i] = p
        valid[i] = True
        ign[i] = bool(ig)
    return buf, valid, ign

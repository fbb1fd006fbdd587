"""Detection representer: prob maps -> scored quads or polygons in original
page coordinates.

A port of ``megreader_tpu/postproc/detection.py``: binarize, connected
components (the CUDA kernel on the card), region statistics, then unclipped
rotated quads (``mode='quad'``) or chain polygons for curved text
(``mode='poly'``, ``ops/chains.py``), all on the maps' device; only the
corners, scores and validity go to the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ccl import (
    connected_components,
    extract_regions,
    regions_to_quads,
    unclip_distance_for,
)
from ..ops.chains import chains_to_polygons, extract_chains


@torch.no_grad()
def detect_quads_device(
    prob_maps: torch.Tensor,
    bin_thresh: float = 0.3,
    box_thresh: float = 0.7,
    unclip_ratio: float = 1.5,
    max_regions: int = 64,
    ccl_iters: int = 64,
    stride: int = 1,
) -> Dict[str, torch.Tensor]:
    """(B, H, W) prob maps -> {'quads' (B, K, 4, 2), 'scores' (B, K), 'valid'
    (B, K)} in map pixels. ``stride`` > 1 max-pools the map (windows of
    ``stride``, no padding) before labelling, and scales the quads back."""
    if stride > 1:
        prob_maps = F.max_pool2d(prob_maps[:, None], stride, stride)[:, 0]
    labels = connected_components(prob_maps > bin_thresh, max_iters=ccl_iters)
    stats = extract_regions(labels, prob_maps, max_regions=max_regions)
    d = unclip_distance_for(stats, ratio=unclip_ratio)
    quads = regions_to_quads(stats, d) * stride
    valid = stats["valid"] & (stats["score"] >= box_thresh) & (stats["area"] >= 4.0)
    return {"quads": quads, "scores": stats["score"], "valid": valid}


@torch.no_grad()
def detect_polygons_device(
    prob_maps: torch.Tensor,
    bin_thresh: float = 0.3,
    box_thresh: float = 0.7,
    unclip_ratio: float = 1.5,
    max_regions: int = 64,
    ccl_iters: int = 64,
    n_bands: int = 8,
) -> Dict[str, torch.Tensor]:
    """The polygon output mode for curved text: (B, H, W) prob maps ->
    {'polygons' (B, K, 2(n_bands + 1), 2), 'scores' (B, K), 'valid' (B, K)},
    each region's chain outline unclipped by d = area * ratio / perimeter."""
    labels = connected_components(prob_maps > bin_thresh, max_iters=ccl_iters)
    stats = extract_regions(labels, prob_maps, max_regions=max_regions)
    d = unclip_distance_for(stats, ratio=unclip_ratio)
    polys = chains_to_polygons(extract_chains(labels, stats, n_bands=n_bands), d)
    valid = stats["valid"] & (stats["score"] >= box_thresh) & (stats["area"] >= 4.0)
    return {"polygons": polys, "scores": stats["score"], "valid": valid}


class SegDetectorRepresenter:
    """Host-facing wrapper: per-page lists of polygons and scores. ``mode``
    'quad' gives min-area rotated rectangles, 'poly' chain polygons of
    ``n_bands`` bands (curved text)."""

    def __init__(self, bin_thresh: float = 0.3, box_thresh: float = 0.7,
                 unclip_ratio: float = 1.5, max_regions: int = 64, stride: int = 1,
                 mode: str = "quad", n_bands: int = 8):
        if mode not in ("quad", "poly"):
            raise ValueError(f"unknown representer mode {mode!r}")
        self.bin_thresh = bin_thresh
        self.box_thresh = box_thresh
        self.unclip_ratio = unclip_ratio
        self.max_regions = max_regions
        self.stride = stride
        self.mode = mode
        self.n_bands = n_bands

    def represent(self, prob_maps: torch.Tensor, scales: np.ndarray = None) -> List[Dict]:
        """prob_maps (B, H, W); scales (B, 2) = (sx, sy) from map to page
        coordinates. Returns per page {'polygons': (n, P, 2) float32,
        'scores': (n,)}: P = 4 in quad mode, 2(n_bands + 1) in poly mode
        (``stride`` applies to quad mode only, as in the JAX package)."""
        kw = dict(bin_thresh=self.bin_thresh, box_thresh=self.box_thresh,
                  unclip_ratio=self.unclip_ratio, max_regions=self.max_regions)
        if self.mode == "poly":
            out = detect_polygons_device(prob_maps, n_bands=self.n_bands, **kw)
            key = "polygons"
        else:
            out = detect_quads_device(prob_maps, stride=self.stride, **kw)
            key = "quads"
        quads, scores, valid = (out[k].cpu().numpy() for k in (key, "scores", "valid"))
        results = []
        for b in range(quads.shape[0]):
            q = quads[b][valid[b]]
            if scales is not None:
                q = q * np.asarray(scales[b], np.float32)[None, None, :]
            results.append({"polygons": q.astype(np.float32), "scores": scores[b][valid[b]]})
        return results

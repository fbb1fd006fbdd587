"""End-to-end page pipeline: detect -> label -> extract -> rectify -> recognize.

    pages (B, H, W, 3) float32 [0, 255]
      -> SegDetectorNet prob map (B, H, W)
      -> binarize + connected components (CUDA kernel on the card; with
         ``ccl_multigrid`` a half-resolution launch seeds a full one)
      -> K fixed region slots per page -> word quads (B, K, 4, 2); in chain
         mode also each region's chain of S bands and its polygon
      -> perspective, box, deskewed box or chain crops (B*K, 32, 100, 3) -> CTC,
         2D-CTC or attention recognizer -> its decode (``rec_mode`` 'greedy'
         or 'beam' of width ``beam_width``; Viterbi for Markov heights)
      -> ids/lengths; ``predict`` looks the strings up on the host.

Shapes are static: K is a fixed region budget, and slots without a region are
masked by ``valid``, not dropped. Each stage is a method, so a caller can time
the stages one by one; ``run`` chains them.

``bf16=True`` serves as the JAX package's ``bf16`` pipeline does: the
detector and the recognizer run as bf16-cast copies (``cast_floats``, made
once per module and made again only when its weights change), fed bf16
normalized pages and crops; the prob map comes back as float32, and the CCL,
the extraction and the rectification see what they see in float32 serving.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..core.charset import Charset
from ..ops.ccl import (
    connected_components,
    extract_regions,
    regions_to_quads,
    unclip_distance_for,
    unclip_distance_inverse,
)
from ..ops.chains import (
    chain_arc_length,
    chains_to_band_quads,
    chains_to_polygons,
    extract_chains,
    resample_width,
)
from ..ops.image import crop_resize_boxes, normalize, rectify_quads_mxu, rotate_crops
from ..ops.precision import cast_floats
from ..parallel.mesh import Mesh, all_gather_batch, batch_sharding
from .predictors import RECOGNIZERS, default_charset


def page_regions(pipe, labels: torch.Tensor, prob: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Labels + prob -> region ``stats`` (``extract_regions`` with
    ``pipe.resolved_impls['extract']``), the unclip distance ``d`` (B, K),
    word quads (B, K, 4, 2), their boxes (x0, y0, x1, y1) widened by
    ``box_margin`` and clamped to the page, and ``valid`` (score at least
    ``box_thresh``, area at least 8). ``pipe`` gives the settings
    (``max_regions``, ``unclip``, ``shrink_ratio``, ``unclip_ratio``,
    ``box_thresh``, ``box_margin``); the page pipeline and the spotter's share
    it."""
    H, W = prob.shape[1:]
    stats = extract_regions(labels, prob, max_regions=pipe.max_regions,
                            impl=pipe.resolved_impls["extract"])
    if pipe.unclip == "inverse":
        d = unclip_distance_inverse(stats, shrink_ratio=pipe.shrink_ratio)
    else:
        d = unclip_distance_for(stats, ratio=pipe.unclip_ratio)
    quads = regions_to_quads(stats, d)
    valid = stats["valid"] & (stats["score"] >= pipe.box_thresh) & (stats["area"] >= 8.0)
    m = pipe.box_margin
    boxes = torch.stack([
        torch.clamp(quads[..., 0].amin(-1) - m, 0, W - 1),
        torch.clamp(quads[..., 1].amin(-1) - m, 0, H - 1),
        torch.clamp(quads[..., 0].amax(-1) + m, 1, W),
        torch.clamp(quads[..., 1].amax(-1) + m, 1, H),
    ], -1)
    return {"stats": stats, "d": d, "quads": quads, "boxes": boxes, "valid": valid}


def bf16_serving(pipe, module: nn.Module) -> nn.Module:
    """The module that serves for ``module`` in ``pipe``: itself, or under
    ``pipe.bf16`` its bf16-cast copy, kept in ``pipe._cast`` and cast again
    when ``module``'s weights have changed since."""
    if not pipe.bf16:
        return module
    versions = tuple(t._version for t in (*module.parameters(), *module.buffers()))
    hit = pipe._cast.get(module)
    if hit is None or hit[0] != versions:
        hit = (versions, cast_floats(module, torch.bfloat16))
        pipe._cast[module] = hit
    return hit[1]


class E2EPipeline:
    """detect -> crop -> recognize, batched over pages, on one device."""

    def __init__(
        self,
        detector,
        recognizer,
        charset: Optional[Charset] = None,
        max_regions: int = 32,
        bin_thresh: float = 0.3,
        box_thresh: float = 0.6,
        unclip_ratio: float = 1.5,
        unclip: str = "inverse",
        shrink_ratio: float = 0.4,
        crop_hw=(32, 100),
        box_margin: float = 4.0,
        deskew: bool = False,
        rectify: str = "perspective",
        n_bands: int = 8,
        ccl_iters: int = 24,
        ccl_multigrid: bool = False,
        bf16: bool = False,
        extract_impl: str = "auto",
        rec_mode: str = "greedy",
        beam_width: int = 8,
        device="cuda",
    ):
        if not isinstance(recognizer, RECOGNIZERS):
            raise TypeError(f"{type(recognizer).__name__} is not a crop recognizer")
        # the legacy flag upgrades an unspecified rectify mode only
        rectify = "deskew" if (deskew and rectify == "perspective") else rectify
        if rectify not in ("perspective", "box", "deskew", "chain"):
            raise ValueError(f"unknown rectify mode {rectify!r}")
        if rec_mode not in ("greedy", "beam"):
            raise ValueError(f"unknown rec_mode {rec_mode!r}")
        if extract_impl not in ("auto", "xla", "pallas", "pallas_full"):
            raise ValueError(f"unknown extract_impl {extract_impl!r}")
        if unclip not in ("inverse", "ratio"):
            raise ValueError(f"unknown unclip mode {unclip!r}")
        self.detector = detector
        self.recognizer = recognizer
        self.charset = charset or default_charset(recognizer)
        self.max_regions = max_regions
        self.bin_thresh = bin_thresh
        self.box_thresh = box_thresh
        self.unclip_ratio = unclip_ratio
        self.unclip = unclip
        self.shrink_ratio = shrink_ratio
        self.crop_hw = tuple(crop_hw)
        self.box_margin = box_margin
        #: crop geometry: 'box' (axis-aligned box), 'deskew' (the box turned
        #: level by the region's principal angle, ``rotate_crops``),
        #: 'perspective' (the rotated quad rectified, ``rectify_quads_mxu``) or
        #: 'chain' (curved text: each region's chain of ``n_bands`` bands
        #: unwarped band by band, ``ops/chains.py``)
        self.rectify = rectify
        self.n_bands = n_bands
        self.ccl_iters = ccl_iters
        #: seed the full-resolution labels from a half-resolution solve
        #: (``connected_components(multigrid=True)``): the same labels
        self.ccl_multigrid = ccl_multigrid
        self.rec_mode = rec_mode
        self.beam_width = beam_width
        self.bf16 = bf16
        #: module -> (its weights' versions, its bf16 copy)
        self._cast = weakref.WeakKeyDictionary()
        #: region-stats path: 'auto' resolves to 'xla', as in the JAX package;
        #: 'pallas' / 'pallas_full' run the CUDA extraction kernels
        #: (``ops/extract.py``)
        self.extract_impl = extract_impl
        self.device = torch.device(device)
        #: what 'auto' resolved to; the CCL follows the device (kernel on the
        #: card, plain version on the CPU)
        self.resolved_impls = {
            "ccl": "cuda" if self.device.type == "cuda" else "plain",
            "extract": "xla" if extract_impl == "auto" else extract_impl,
        }

    # --- stages -------------------------------------------------------------

    def serving(self, module: nn.Module) -> nn.Module:
        """``bf16_serving`` of ``module``."""
        return bf16_serving(self, module)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16) if self.bf16 else x

    def detect(self, det_module, pages: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) pages -> (B, H, W) float32 prob map (the module in
        eval mode)."""
        net = self.serving(det_module).eval()
        return net(self._input(normalize(pages)), heads=("prob",))["prob"].float()

    def label(self, prob: torch.Tensor) -> torch.Tensor:
        """Binarize and label components: (B, H, W) int32."""
        return connected_components(prob > self.bin_thresh, max_iters=self.ccl_iters,
                                    multigrid=self.ccl_multigrid)

    def regions(self, labels: torch.Tensor, prob: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Labels + prob -> ``page_regions``; in chain mode also the
        ``chains`` and the ``polygons`` (B, K, 2(S + 1), 2), unclipped by
        ``d``."""
        out = page_regions(self, labels, prob)
        if self.rectify == "chain":
            out["chains"] = extract_chains(labels, out["stats"], n_bands=self.n_bands,
                                           extract_impl=self.resolved_impls["extract"])
            out["polygons"] = chains_to_polygons(out["chains"], out["d"])
        return out

    def crops(self, pages: torch.Tensor, regions: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Word crops (B*K, Ho, Wo, 3), normalized for the recognizer (bf16
        under ``bf16``), cut from the float32 pages."""
        B, K = regions["quads"].shape[:2]
        Ho, Wo = self.crop_hw
        if self.rectify == "perspective":
            quads = regions["quads"]
            # margin along the quad's own axes (same role as box_margin)
            c = quads.mean(-2, keepdim=True)
            qm = quads + torch.sign(quads - c) * (self.box_margin * 0.5)
            crops = rectify_quads_mxu(pages, qm, (Ho, Wo), aspect="preserve_h")
        elif self.rectify == "chain":
            crops = self._chain_crops(pages, regions)
        else:
            crops = crop_resize_boxes(pages, regions["boxes"], (Ho, Wo), aspect="preserve_h")
        crops = crops.reshape(B * K, Ho, Wo, 3)
        if self.rectify == "deskew":
            crops = rotate_crops(crops, regions["stats"]["theta"].reshape(B * K))
        return self._input(normalize(crops))

    def _chain_crops(self, pages: torch.Tensor, regions: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        """Chain mode's crops (B, K, Ho, Wo, 3): each band quad (unclip plus
        half the box margin) unwarped by the ruled surface onto a (Ho, Wb)
        slice, Wb = max(Wo // S, 8), the S slices side by side, then the word
        squeezed onto its arc length's width at the crop's height."""
        chains = regions["chains"]
        B, K = regions["quads"].shape[:2]
        Ho, Wo = self.crop_hw
        S = self.n_bands
        dm = regions["d"] + self.box_margin * 0.5
        band_quads = chains_to_band_quads(chains, dm)
        Wb = max(Wo // S, 8)
        slices = rectify_quads_mxu(pages, band_quads.reshape(B, K * S, 4, 2), (Ho, Wb),
                                   crop_hw=(48, 64), aspect="stretch", warp="bilinear")
        stretched = (slices.reshape(B, K, S, Ho, Wb, 3).permute(0, 1, 3, 2, 4, 5)
                     .reshape(B, K, Ho, S * Wb, 3))
        L = chain_arc_length(chains, dm)
        th = 2.0 * (chains["half_h"].mean(-1) + dm)
        tw = torch.clamp(torch.round(L * Ho / torch.clamp(th, min=1.0)), 2.0, float(Wo))
        return resample_width(stretched, tw, Wo)

    def recognize(self, rec_module, crops: torch.Tensor):
        """Crops -> (ids (B*K, T) int32, lengths (B*K,) int32), by the
        recognizer family's decode for ``rec_mode``."""
        return self.recognizer.decode(crops, mode=self.rec_mode,
                                      net=self.serving(self.recognizer.net if rec_module is None
                                                       else rec_module),
                                      beam_width=self.beam_width)

    # --- whole path -----------------------------------------------------------

    def _pages(self, pages) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def run(self, det_module, rec_module, pages) -> Dict[str, torch.Tensor]:
        """The page program: modules (``None``: the wrappers' own) and
        (B, H, W, 3) pages -> dict of ids (B, K, T), lengths, quads, boxes,
        scores, valid (and in chain mode polygons), as the JAX pipeline's
        ``build()`` program returns."""
        det_module = self.detector.net if det_module is None else det_module
        rec_module = self.recognizer.net if rec_module is None else rec_module
        pages = self._pages(pages)
        B = pages.shape[0]
        K = self.max_regions
        prob = self.detect(det_module, pages)
        labels = self.label(prob)
        reg = self.regions(labels, prob)
        ids, lens = self.recognize(rec_module, self.crops(pages, reg))
        out = {
            "ids": ids.reshape(B, K, -1),
            "lengths": lens.reshape(B, K),
            "quads": reg["quads"],
            "boxes": reg["boxes"],
            "scores": reg["stats"]["score"],
            "valid": reg["valid"],
        }
        if "polygons" in reg:
            out["polygons"] = reg["polygons"]
        return out

    def build(self, mesh=None):
        """The JAX pipeline's ``build()`` surface: returns ``run``. With
        ``mesh`` (a ``parallel.Mesh``) each rank runs its contiguous block of
        the pages (JAX's ``P('data')``) and the ranks all-gather the
        fixed-shape outputs, so every rank returns what ``run`` returns on
        all the pages."""
        if mesh is None:
            return self.run
        if not isinstance(mesh, Mesh):
            raise TypeError(f"build(mesh=...) takes a parallel.Mesh, got {type(mesh).__name__}")

        def run_sharded(det_module, rec_module, pages) -> Dict[str, torch.Tensor]:
            out = self.run(det_module, rec_module, pages[batch_sharding(mesh, len(pages))])
            return {k: all_gather_batch(v, mesh) for k, v in out.items()}

        return run_sharded

    def predict(self, det_module, rec_module, pages) -> List[List[Dict]]:
        """pages (B, H, W, 3) float32 [0, 255] -> per-page detection dicts;
        a detection's ``polygon`` is its chain outline in chain mode, else its
        quad."""
        out = {k: v.cpu().numpy() for k, v in self.run(det_module, rec_module, pages).items()}
        polys = out.get("polygons", out["quads"])
        results: List[List[Dict]] = []
        for b in range(out["ids"].shape[0]):
            page = []
            for k in range(out["ids"].shape[1]):
                if not out["valid"][b, k]:
                    continue
                page.append({
                    "polygon": polys[b, k],
                    "quad": out["quads"][b, k],
                    "text": self.charset.decode(out["ids"][b, k][: out["lengths"][b, k]]),
                    "score": float(out["scores"][b, k]),
                })
            results.append(page)
        return results

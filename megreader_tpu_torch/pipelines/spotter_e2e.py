"""The shared-trunk spotter's page program: detect -> pool -> recognize from
ONE trunk pass (``megreader_tpu/pipelines/spotter_e2e.py``).

    pages (B, H, W, 3) float32 [0, 255]
      -> SharedTrunkSpotterNet.fused_map           (one trunk + FPN pass)
      -> detect_maps('prob') -> binarize -> connected components (the CUDA
         kernel on the card) -> K region slots -> quads -> boxes (box_margin)
      -> recognize(fused, boxes): deformable RoI pooling -> BiLSTM -> greedy
         CTC -> ids (B, K, T), lengths; ``predict`` looks the strings up.

Shapes are static as in ``E2EPipeline``: K slots a page, the empty ones
masked by ``valid``. The region stage is ``e2e.page_regions``;
``extract_impl`` 'auto' resolves to 'xla', 'pallas' / 'pallas_full' run the
CUDA extraction kernels. ``bf16=True`` serves the bf16-cast copy of the net
(``e2e.bf16_serving``) on bf16 normalized pages; the prob map and the RoI
pooling stay float32, as in the JAX program.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..core.charset import Charset
from ..ops.ccl import connected_components
from ..ops.ctc import ctc_greedy_decode
from ..ops.image import normalize
from ..parallel.mesh import Mesh, all_gather_batch, batch_sharding
from .e2e import bf16_serving, page_regions


class SpotterE2EPipeline:
    """One-trunk detect + recognize serving for a ``SharedTrunkSpotter``."""

    def __init__(
        self,
        spotter,
        charset: Optional[Charset] = None,
        max_regions: int = 32,
        bin_thresh: float = 0.3,
        box_thresh: float = 0.6,
        unclip: str = "inverse",
        unclip_ratio: float = 1.5,
        shrink_ratio: float = 0.4,
        box_margin: float = 4.0,
        ccl_iters: int = 24,
        extract_impl: str = "auto",
        bf16: bool = False,
        device="cuda",
    ):
        if not hasattr(spotter.net, "fused_map"):
            raise TypeError(f"{type(spotter).__name__} is not a shared-trunk spotter")
        if extract_impl not in ("auto", "xla", "pallas", "pallas_full"):
            raise ValueError(f"unknown extract_impl {extract_impl!r}")
        if unclip not in ("inverse", "ratio"):
            raise ValueError(f"unknown unclip mode {unclip!r}")
        self.spotter = spotter
        self.charset = charset or Charset()
        self.max_regions = max_regions
        self.bin_thresh = bin_thresh
        self.box_thresh = box_thresh
        self.unclip = unclip
        self.unclip_ratio = unclip_ratio
        self.shrink_ratio = shrink_ratio
        self.box_margin = box_margin
        self.ccl_iters = ccl_iters
        self.bf16 = bf16
        self._cast = weakref.WeakKeyDictionary()
        self.device = torch.device(device)
        self.resolved_impls = {
            "ccl": "cuda" if self.device.type == "cuda" else "plain",
            "extract": "xla" if extract_impl == "auto" else extract_impl,
        }

    # --- stages -------------------------------------------------------------

    def serving(self, net: nn.Module) -> nn.Module:
        return bf16_serving(self, net).eval()

    def fused(self, net: nn.Module, pages: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) pages -> the fused map (B, D, H/4, W/4) of one trunk
        pass (bf16 under ``bf16``)."""
        x = normalize(pages)
        return self.serving(net).fused_map(x.to(torch.bfloat16) if self.bf16 else x)

    def detect(self, net: nn.Module, fused: torch.Tensor) -> torch.Tensor:
        """The prob head alone: (B, H, W) float32."""
        return self.serving(net).detect_maps(fused, heads=("prob",))["prob"].float()

    def label(self, prob: torch.Tensor) -> torch.Tensor:
        return connected_components(prob > self.bin_thresh, max_iters=self.ccl_iters)

    def regions(self, labels: torch.Tensor, prob: torch.Tensor) -> Dict[str, torch.Tensor]:
        return page_regions(self, labels, prob)

    def recognize(self, net: nn.Module, fused: torch.Tensor, rois: torch.Tensor):
        """(B, K, 4) boxes on the fused map -> greedy (ids (B, K, T), lengths
        (B, K)) int32."""
        logits = self.serving(net).recognize(fused, rois)
        B, K, T, C = logits.shape
        lengths = torch.full((B * K,), T, dtype=torch.int32, device=logits.device)
        ids, lens = ctc_greedy_decode(logits.reshape(B * K, T, C), lengths,
                                      blank=self.spotter.blank)
        return ids.reshape(B, K, T), lens.reshape(B, K)

    # --- whole path -----------------------------------------------------------

    @torch.no_grad()
    def run(self, net: Optional[nn.Module], pages) -> Dict[str, torch.Tensor]:
        """The page program: the module (``None``: the spotter's own) and
        (B, H, W, 3) pages -> dict of ids (B, K, T), lengths, quads, boxes,
        scores, valid, as the JAX pipeline's ``build()`` program returns."""
        net = self.spotter.net if net is None else net
        pages = torch.as_tensor(pages, dtype=torch.float32).to(self.device)
        fused = self.fused(net, pages)
        prob = self.detect(net, fused)
        reg = self.regions(self.label(prob), prob)
        ids, lens = self.recognize(net, fused, reg["boxes"])
        return {"ids": ids, "lengths": lens, "quads": reg["quads"], "boxes": reg["boxes"],
                "scores": reg["stats"]["score"], "valid": reg["valid"]}

    def build(self, mesh=None):
        """``run``; with ``mesh`` (a ``parallel.Mesh``) each rank runs its
        block of the pages and the ranks all-gather the outputs, as
        ``E2EPipeline.build(mesh)``."""
        if mesh is None:
            return self.run
        if not isinstance(mesh, Mesh):
            raise TypeError(f"build(mesh=...) takes a parallel.Mesh, got {type(mesh).__name__}")

        def run_sharded(net, pages) -> Dict[str, torch.Tensor]:
            out = self.run(net, pages[batch_sharding(mesh, len(pages))])
            return {k: all_gather_batch(v, mesh) for k, v in out.items()}

        return run_sharded

    def predict(self, net: Optional[nn.Module], pages) -> List[List[Dict]]:
        """pages (B, H, W, 3) float32 [0, 255] -> per page, a dict a valid
        region: polygon (its quad), text, score."""
        out = {k: v.cpu().numpy() for k, v in self.run(net, pages).items()}
        results: List[List[Dict]] = []
        for b in range(out["ids"].shape[0]):
            results.append([
                {"polygon": out["quads"][b, k],
                 "text": self.charset.decode(out["ids"][b, k][: out["lengths"][b, k]]),
                 "score": float(out["scores"][b, k])}
                for k in range(out["ids"].shape[1]) if out["valid"][b, k]
            ])
        return results

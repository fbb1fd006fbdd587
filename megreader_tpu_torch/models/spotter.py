"""Text spotters: one page trunk, deformable RoI pooling, a CTC head
(``megreader_tpu/models/spotter.py``).

    pages (B, H, W, 3)
      -> ResNet det trunk + FPN               -> fused (B, D, H/4, W/4)
      -> DeformRoIPooling((kh, kw) bins) over each page's word boxes
                                              -> (B, P, kh, kw, D)
      -> mean over kh -> BiLSTM -> Linear     -> (B, P, kw, classes)
      -> CTC loss over the valid RoIs / greedy decode

``RoITextSpotter`` trains the recognition branch alone; ``SharedTrunkSpotter``
also carries the detector's prob and thresh heads on the same fused map and
trains them with the DB losses. Its serving program is
``pipelines/spotter_e2e.py``. RoIs are axis-aligned (x0, y0, x1, y1) page
boxes in P fixed slots a page; ``roi_valid`` masks the empty ones.

The RoI pooling runs on the fused map in at least float32 (the JAX package's
``fused.astype(float32)``), under mixed precision too; the LSTM input is cast
back to the compute dtype, and the logits come out in float32. The CTC term
is ``sum(valid * nll / max(len, 1)) / max(sum(valid), 1)`` over the global
batch (both sums through ``parallel.batch_sum``); an invalid slot gets a
length-1 target (its zero-filled label, the blank class) and is masked out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.ctc import ctc_greedy_decode, ctc_loss
from ..ops.losses import balanced_bce_loss, dice_loss, masked_l1_loss
from ..ops.precision import Linear, at_least_float32, parse_compute_dtype
from ..parallel.mesh import batch_sum
from .deform import DeformRoIPooling
from .detector import FPNNeck, MapHead
from .resnet import resnet_variant
from .sequence import StackedBiLSTM


class _RoIRecognition(nn.Module):
    """The recognition branch's modules and its pass from the fused map."""

    def _build_recognition(self, num_classes: int, fpn_dim: int, pool_hw, hidden: int,
                           trans_hidden: int, dtype):
        self.num_classes = num_classes
        self.dtype = dtype
        self.roi_pool = DeformRoIPooling(fpn_dim, tuple(pool_hw), spatial_scale=0.25,
                                         hidden=trans_hidden)
        self.encoder = StackedBiLSTM(fpn_dim, hidden, 1, dtype)
        self.classifier = Linear(2 * hidden, num_classes, compute_dtype=dtype)

    def recognize(self, fused: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """fused (B, D, h, w), rois (B, P, 4) page boxes -> logits (B, P, kw,
        classes) float32."""
        pooled = self.roi_pool(at_least_float32(fused).permute(0, 2, 3, 1), rois)
        B, P, kh, kw, D = pooled.shape
        seq = pooled.mean(2).reshape(B * P, kw, D)
        if self.dtype is not None:
            seq = seq.to(self.dtype)
        logits = self.classifier(self.encoder(seq))
        return logits.float().reshape(B, P, kw, self.num_classes)


class RoITextSpotterNet(_RoIRecognition):
    """Trunk + FPN + deformable RoI pooling + BiLSTM + classifier; NHWC pages
    and (B, P, 4) RoIs in, (B, P, kw, classes) float32 logits out."""

    def __init__(self, num_classes: int, backbone: str = "resnet18", fpn_dim: int = 256,
                 pool_hw=(4, 32), hidden: int = 256, trans_hidden: int = 128,
                 dcn_stages=(), dtype=None):
        super().__init__()
        self.backbone = resnet_variant(backbone, "det", dtype=dtype, dcn_stages=dcn_stages)
        self.fpn = FPNNeck(self.backbone.out_channels, fpn_dim, fpn_dim, dtype)
        self._build_recognition(num_classes, fpn_dim, pool_hw, hidden, trans_hidden, dtype)

    def forward(self, images: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        return self.recognize(self.fpn(self.backbone(images.permute(0, 3, 1, 2))), rois)


class SharedTrunkSpotterNet(_RoIRecognition):
    """One trunk + FPN for both tasks: the prob/thresh map heads (detection)
    and the RoI recognition branch. ``forward(images, rois=None, heads)``
    returns the maps of ``heads`` (``binary`` with both) and, with ``rois``,
    the ``logits``; serving calls ``fused_map``, ``detect_maps`` and
    ``recognize`` one by one."""

    def __init__(self, num_classes: int, backbone: str = "resnet18", fpn_dim: int = 256,
                 head_dim: int = 64, k: float = 50.0, pool_hw=(4, 32), hidden: int = 256,
                 trans_hidden: int = 128, dcn_stages=(), dtype=None):
        super().__init__()
        self.trunk = resnet_variant(backbone, "det", dtype=dtype, dcn_stages=dcn_stages)
        self.fpn = FPNNeck(self.trunk.out_channels, fpn_dim, fpn_dim, dtype)
        self.prob_head = MapHead(fpn_dim, head_dim, dtype)
        self.thresh_head = MapHead(fpn_dim, head_dim, dtype)
        self.k = k
        self._build_recognition(num_classes, fpn_dim, pool_hw, hidden, trans_hidden, dtype)

    def fused_map(self, images: torch.Tensor) -> torch.Tensor:
        """One trunk + FPN pass: NHWC pages -> (B, D, H/4, W/4)."""
        return self.fpn(self.trunk(images.permute(0, 3, 1, 2)))

    def detect_maps(self, fused: torch.Tensor,
                    heads: Tuple[str, ...] = ("prob", "thresh")) -> Dict[str, torch.Tensor]:
        out = {}
        if "prob" in heads:
            out["prob"] = self.prob_head(fused)
        if "thresh" in heads:
            out["thresh"] = self.thresh_head(fused)
        if "prob" in out and "thresh" in out:
            out["binary"] = torch.sigmoid(self.k * (out["prob"] - out["thresh"]))
        return out

    def forward(self, images: torch.Tensor, rois: Optional[torch.Tensor] = None,
                heads: Tuple[str, ...] = ("prob", "thresh")) -> Dict[str, torch.Tensor]:
        fused = self.fused_map(images)
        out = self.detect_maps(fused, heads)
        if rois is not None:
            out["logits"] = self.recognize(fused, rois)
        return out


def spotting_ctc(logits: torch.Tensor, batch: Dict[str, torch.Tensor], blank: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked mean CTC loss, number of valid RoIs), both over the global
    batch, from (B, P, T, C) logits and the batch's ``label`` (B, P, L),
    ``label_length`` and ``roi_valid`` (B, P)."""
    B, P, T, C = logits.shape
    dev = logits.device
    labels = batch["label"].to(dev, torch.int32).reshape(B * P, -1).contiguous()
    lab_len = batch["label_length"].to(dev, torch.int32).reshape(B * P)
    valid = batch["roi_valid"].to(dev).reshape(B * P) & (lab_len > 0)
    nll = ctc_loss(logits.reshape(B * P, T, C),
                   torch.full((B * P,), T, dtype=torch.int32, device=dev), labels,
                   torch.where(valid, lab_len, 1).contiguous(), blank=blank, reduction="none")
    per = nll / lab_len.clamp(min=1).to(nll.dtype)
    num, count = batch_sum(torch.stack([torch.where(valid, per, 0.0).sum(),
                                        valid.sum().to(nll.dtype)]))
    return num / count.clamp(min=1.0), count


def _greedy(logits: torch.Tensor, blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, P, T, C = logits.shape
    lengths = torch.full((B * P,), T, dtype=torch.int32, device=logits.device)
    ids, lens = ctc_greedy_decode(logits.reshape(B * P, T, C), lengths, blank=blank)
    return ids.reshape(B, P, T), lens.reshape(B, P)


class RoITextSpotter:
    """Task wrapper: the net on ``device``, the CTC loss over the valid RoIs,
    greedy decode per RoI. ``apply``, ``loss`` and ``decode`` put the net in
    train or eval mode themselves."""

    def __init__(self, num_classes: int = 37, backbone: str = "resnet18", fpn_dim: int = 256,
                 pool_hw=(4, 32), hidden: int = 256, blank: int = 0, dcn_stages=(),
                 compute_dtype: str = "float32", device="cuda"):
        self.net = RoITextSpotterNet(num_classes, backbone, fpn_dim, tuple(pool_hw), hidden,
                                     dcn_stages=tuple(dcn_stages),
                                     dtype=parse_compute_dtype(compute_dtype)).to(device).eval()
        self.num_classes = num_classes
        self.blank = blank

    def apply(self, images: torch.Tensor, rois: torch.Tensor, train: bool = False,
              net: nn.Module = None) -> torch.Tensor:
        """NHWC normalized pages, (B, P, 4) RoIs -> (B, P, kw, classes) logits;
        ``net`` overrides the wrapper's own module (same architecture)."""
        net = self.net if net is None else net
        return net.train(train)(images, rois)

    def loss(self, batch: Dict[str, torch.Tensor], train: bool = True):
        """batch: image (B, H, W, 3) normalized, rois (B, P, 4), roi_valid
        (B, P) bool, label (B, P, L), label_length (B, P) -> (loss, metrics
        {loss, n_rois} detached)."""
        loss, count = spotting_ctc(self.apply(batch["image"], batch["rois"], train=train),
                                   batch, self.blank)
        return loss, {"loss": loss.detach(), "n_rois": count.detach()}

    @torch.no_grad()
    def decode(self, images: torch.Tensor, rois: torch.Tensor, net: nn.Module = None):
        """Greedy CTC per RoI: (ids (B, P, T) int32, lengths (B, P) int32)."""
        return _greedy(self.apply(images, rois, net=net), self.blank)


class SharedTrunkSpotter:
    """Task wrapper: the DB detection losses and the RoI CTC loss from one
    trunk pass (``bce_scale * bce + dice + l1_scale * l1 + ctc_scale *
    ctc``); serving is ``pipelines/spotter_e2e.py``."""

    def __init__(self, num_classes: int = 37, backbone: str = "resnet18", fpn_dim: int = 256,
                 head_dim: int = 64, pool_hw=(4, 32), hidden: int = 256, blank: int = 0,
                 dcn_stages=(), compute_dtype: str = "float32", bce_scale: float = 5.0,
                 l1_scale: float = 10.0, negative_ratio: float = 3.0, ctc_scale: float = 1.0,
                 device="cuda"):
        self.net = SharedTrunkSpotterNet(num_classes, backbone, fpn_dim, head_dim,
                                         pool_hw=tuple(pool_hw), hidden=hidden,
                                         dcn_stages=tuple(dcn_stages),
                                         dtype=parse_compute_dtype(compute_dtype)
                                         ).to(device).eval()
        self.num_classes = num_classes
        self.blank = blank
        self.bce_scale = bce_scale
        self.l1_scale = l1_scale
        self.negative_ratio = negative_ratio
        self.ctc_scale = ctc_scale

    def apply(self, images: torch.Tensor, rois: Optional[torch.Tensor] = None,
              train: bool = False, heads: Tuple[str, ...] = ("prob", "thresh"),
              net: nn.Module = None) -> Dict[str, torch.Tensor]:
        net = self.net if net is None else net
        return net.train(train)(images, rois, heads=tuple(heads))

    def loss(self, batch: Dict[str, torch.Tensor], train: bool = True):
        """batch: image; gt, mask, thresh_map, thresh_mask (B, H, W); rois,
        roi_valid, label, label_length -> (total, metrics {loss, bce, dice,
        thresh_l1, ctc} detached)."""
        maps = self.apply(batch["image"], batch["rois"], train=train)
        bce = balanced_bce_loss(maps["prob"], batch["gt"], batch["mask"], self.negative_ratio)
        dice = dice_loss(maps["binary"], batch["gt"], batch["mask"])
        l1 = masked_l1_loss(maps["thresh"], batch["thresh_map"], batch["thresh_mask"])
        ctc, _ = spotting_ctc(maps["logits"], batch, self.blank)
        total = self.bce_scale * bce + dice + self.l1_scale * l1 + self.ctc_scale * ctc
        metrics = {"loss": total, "bce": bce, "dice": dice, "thresh_l1": l1, "ctc": ctc}
        return total, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def decode(self, images: torch.Tensor, rois: torch.Tensor, net: nn.Module = None):
        """Greedy CTC per RoI (the recognition branch only, no map head)."""
        return _greedy(self.apply(images, rois, heads=(), net=net)["logits"], self.blank)

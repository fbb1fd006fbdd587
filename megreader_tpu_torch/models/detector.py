"""FPN segmentation text detector (DB-style prob/thresh maps).

ResNet C2-C5 -> top-down FPN -> concatenated /4 feature -> per-pixel map
heads. Internal modules are NCHW; ``SegDetectorNet`` takes NHWC pages and
returns (B, H, W) maps, as the JAX package does.

The map head is the plain formulation of the JAX ``MapHead`` (resize ->
conv): the JAX package's packed serving head is a TPU layout rewrite with the
same parameters, equality-tested against this formulation there.

``compute_dtype='bfloat16'`` is the JAX package's mixed precision: the trunk,
the FPN and the heads' convs in bf16 on float32 parameters, BatchNorm in
float32, the sigmoids and the loss in float32. Under the bf16 serving cast
(``ops/precision.py::cast_floats``) the same ops promote their bf16 input and
weights. The resizes run in their input's dtype, so a bf16 head rounds its
upsampled tensor once more than the JAX head, which folds each upsample into
the conv after it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.losses import balanced_bce_loss, dice_loss, masked_l1_loss
from ..ops.precision import Conv2d, at_least_float32, parse_compute_dtype
from .resnet import BatchNorm2d, resnet_variant


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Half-pixel bilinear upscale with edge clamping (the JAX package's tent
    matrices / ``jax.image.resize`` for upscaling)."""
    if x.shape[-2:] == (h, w):
        return x
    if h < x.shape[-2] or w < x.shape[-1]:
        raise NotImplementedError("only upscaling resizes are ported")
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class FPNNeck(nn.Module):
    """Top-down FPN: laterals to ``dim``, upsample+add, smooth, concat at /4."""

    def __init__(self, in_chs, dim: int = 256, out_dim: int = 256, dtype=None):
        super().__init__()
        for i, c in zip((2, 3, 4, 5), in_chs):
            self.add_module(f"lat{i}", Conv2d(c, dim, 1, compute_dtype=dtype))
        q = out_dim // 4
        for i in (2, 3, 4, 5):
            self.add_module(f"smooth{i}", Conv2d(dim, q, 3, 1, 1, compute_dtype=dtype))

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        c2, c3, c4, c5 = feats
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _resize_to(p5, *c4.shape[-2:])
        p3 = self.lat3(c3) + _resize_to(p4, *c3.shape[-2:])
        p2 = self.lat2(c2) + _resize_to(p3, *c2.shape[-2:])
        h, w = c2.shape[-2:]
        outs = [
            _resize_to(getattr(self, f"smooth{i}")(p), h, w)
            for i, p in zip((2, 3, 4, 5), (p2, p3, p4, p5))
        ]
        return torch.cat(outs, 1)  # (B, out_dim, H/4, W/4)


class MapHead(nn.Module):
    """conv3x3 -> BN -> relu -> [2x upsample -> conv3x3 -> BN -> relu] ->
    [2x upsample -> conv3x3] -> sigmoid: a (B, 4h, 4w) float32 map."""

    def __init__(self, in_ch: int, dim: int = 64, dtype=None):
        super().__init__()
        self.conv = Conv2d(in_ch, dim, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn = BatchNorm2d(dim)
        # the JAX head's up1/up2 are _UpConv modules (fused_upsample=True),
        # which int8 serving leaves in float
        self.up1 = Conv2d(dim, dim // 2, 3, 1, 1, bias=False, compute_dtype=dtype, int8=False)
        self.bn1 = BatchNorm2d(dim // 2)
        self.up2 = Conv2d(dim // 2, 1, 3, 1, 1, compute_dtype=dtype, int8=False)

    def forward(self, x):
        y = F.relu(self.bn(self.conv(x)))
        h, w = y.shape[-2:]
        y = F.relu(self.bn1(self.up1(_resize_to(y, 2 * h, 2 * w))))
        y = self.up2(_resize_to(y, 4 * h, 4 * w))
        return torch.sigmoid(at_least_float32(y[:, 0]))


class SegDetectorNet(nn.Module):
    """ResNet trunk + FPN + prob/thresh heads; NHWC pages in, (B, H, W) maps out."""

    def __init__(self, num_backbone: str = "resnet18", fpn_dim: int = 256,
                 head_dim: int = 64, k: float = 50.0, width: int = 64, dtype=None,
                 dcn_stages=(), stem_s2d: bool = False, stem_s2d4: bool = False):
        super().__init__()
        self.backbone = resnet_variant(num_backbone, "det", width, dtype=dtype,
                                       dcn_stages=dcn_stages, stem_s2d=stem_s2d,
                                       stem_s2d4=stem_s2d4)
        self.fpn = FPNNeck(self.backbone.out_channels, fpn_dim, fpn_dim, dtype)
        self.prob_head = MapHead(fpn_dim, head_dim, dtype)
        self.thresh_head = MapHead(fpn_dim, head_dim, dtype)
        self.k = k

    def forward(self, images: torch.Tensor,
                heads: Tuple[str, ...] = ("prob", "thresh")) -> Dict[str, torch.Tensor]:
        """``heads=('prob',)`` is the serving call: the thresh head is a
        training auxiliary and is skipped."""
        fused = self.fpn(self.backbone(images.permute(0, 3, 1, 2)))
        out: Dict[str, torch.Tensor] = {}
        if "prob" in heads:
            out["prob"] = self.prob_head(fused)
        if "thresh" in heads:
            out["thresh"] = self.thresh_head(fused)
        if "prob" in heads and "thresh" in heads:
            out["binary"] = torch.sigmoid(self.k * (out["prob"] - out["thresh"]))
        return out


class SegDetector:
    """Task wrapper: the net on ``device``, the DB training loss over the
    prob, binary and thresh maps, and map inference. ``apply``, ``loss`` and
    ``predict_maps`` put the net in train or eval mode themselves.

    ``dcn_stages`` (1-based trunk stages, e.g. (3, 4)) swaps those stages'
    3x3 ``conv2`` for deformable ones (``deform.py``); ``backbone`` is
    ``resnet18``/``resnet34`` (BasicBlock) or ``resnet50``/``resnet101``
    (Bottleneck: DB's deformable ResNet-50 is ``resnet50`` with
    ``dcn_stages=(2, 3, 4)``).

    ``stem_s2d`` / ``stem_s2d4`` are accepted and compute the plain stem,
    the function of the JAX package's space-to-depth rewrites of the same
    ``stem_conv`` weight (``resnet.py::ResNet``). The JAX package's
    ``fused_upsample`` head is a TPU formulation of the plain resize -> conv
    head the port runs, and is not an option here
    (ROADMAP Queue 1 item 15c)."""

    def __init__(self, backbone: str = "resnet18", fpn_dim: int = 256, head_dim: int = 64,
                 k: float = 50.0, bce_scale: float = 5.0, l1_scale: float = 10.0,
                 negative_ratio: float = 3.0, width: int = 64, compute_dtype: str = "float32",
                 dcn_stages=(), stem_s2d: bool = False, stem_s2d4: bool = False,
                 device="cuda"):
        dtype = parse_compute_dtype(compute_dtype)
        self.net = SegDetectorNet(backbone, fpn_dim, head_dim, k, width, dtype,
                                  tuple(dcn_stages), stem_s2d, stem_s2d4).to(device).eval()
        self.bce_scale = bce_scale
        self.l1_scale = l1_scale
        self.negative_ratio = negative_ratio

    def apply(self, images: torch.Tensor, train: bool = False,
              heads: Tuple[str, ...] = ("prob", "thresh"), net: nn.Module = None):
        """NHWC normalized pages -> maps; ``train`` runs BatchNorm on batch
        statistics and updates its running statistics. ``net`` overrides the
        wrapper's own module (same architecture)."""
        net = self.net if net is None else net
        return net.train(train)(images, heads=tuple(heads))

    def loss(self, batch: Dict[str, torch.Tensor], train: bool = True):
        """batch: image (B, H, W, 3) normalized; gt (shrunk text), mask (valid
        pixels), thresh_map, thresh_mask, each (B, H, W) -> (bce_scale * bce +
        dice + l1_scale * l1, metrics {loss, bce, dice, thresh_l1} detached)."""
        return self.map_loss(self.apply(batch["image"], train=train), batch)

    def map_loss(self, maps: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        """``loss`` from the net's maps {prob, thresh, binary}."""
        bce = balanced_bce_loss(maps["prob"], batch["gt"], batch["mask"], self.negative_ratio)
        dice = dice_loss(maps["binary"], batch["gt"], batch["mask"])
        l1 = masked_l1_loss(maps["thresh"], batch["thresh_map"], batch["thresh_mask"])
        total = self.bce_scale * bce + dice + self.l1_scale * l1
        metrics = {"loss": total, "bce": bce, "dice": dice, "thresh_l1": l1}
        return total, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def predict_maps(self, images: torch.Tensor, net: nn.Module = None,
                     heads: Tuple[str, ...] = ("prob", "thresh")) -> Dict[str, torch.Tensor]:
        """Eval-mode maps of NHWC normalized pages."""
        return self.apply(images, train=False, heads=heads, net=net)

"""FPN segmentation text detector (DB-style prob/thresh maps).

ResNet C2-C5 -> top-down FPN -> concatenated /4 feature -> per-pixel map
heads. Internal modules are NCHW; ``SegDetectorNet`` takes NHWC pages and
returns (B, H, W) maps, as the JAX package does.

The map head is the plain formulation of the JAX ``MapHead`` (resize ->
conv): the JAX package's packed serving head is a TPU layout rewrite with the
same parameters, equality-tested against this formulation there.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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

    def __init__(self, in_chs, dim: int = 256, out_dim: int = 256):
        super().__init__()
        for i, c in zip((2, 3, 4, 5), in_chs):
            self.add_module(f"lat{i}", nn.Conv2d(c, dim, 1))
        q = out_dim // 4
        for i in (2, 3, 4, 5):
            self.add_module(f"smooth{i}", nn.Conv2d(dim, q, 3, 1, 1))

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
    [2x upsample -> conv3x3] -> sigmoid: a (B, 4h, 4w) map."""

    def __init__(self, in_ch: int, dim: int = 64):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, dim, 3, 1, 1, bias=False)
        self.bn = BatchNorm2d(dim)
        self.up1 = nn.Conv2d(dim, dim // 2, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(dim // 2)
        self.up2 = nn.Conv2d(dim // 2, 1, 3, 1, 1)

    def forward(self, x):
        y = F.relu(self.bn(self.conv(x)))
        h, w = y.shape[-2:]
        y = F.relu(self.bn1(self.up1(_resize_to(y, 2 * h, 2 * w))))
        y = self.up2(_resize_to(y, 4 * h, 4 * w))
        return torch.sigmoid(y[:, 0].float())


class SegDetectorNet(nn.Module):
    """ResNet trunk + FPN + prob/thresh heads; NHWC pages in, (B, H, W) maps out."""

    def __init__(self, num_backbone: str = "resnet18", fpn_dim: int = 256,
                 head_dim: int = 64, k: float = 50.0, width: int = 64):
        super().__init__()
        self.backbone = resnet_variant(num_backbone, "det", width)
        self.fpn = FPNNeck(self.backbone.out_channels, fpn_dim, fpn_dim)
        self.prob_head = MapHead(fpn_dim, head_dim)
        self.thresh_head = MapHead(fpn_dim, head_dim)
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
    """Serving wrapper: builds the net on ``device`` in eval mode."""

    def __init__(self, backbone: str = "resnet18", fpn_dim: int = 256, head_dim: int = 64,
                 k: float = 50.0, width: int = 64, compute_dtype: str = "float32",
                 device="cuda"):
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: bf16 serving is not ported yet (ROADMAP)"
            )
        self.net = SegDetectorNet(backbone, fpn_dim, head_dim, k, width).to(device).eval()

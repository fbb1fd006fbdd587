"""Segmentation losses of the DB detector: balanced BCE, dice, masked L1.

A port of ``megreader_tpu/ops/losses.py``. The hard-negative mining keeps the
JAX package's static-shape form: the k-th largest negative loss (k =
``negative_ratio`` x positives, at least 1, at most the negatives) is read
from a descending sort, and every negative at or above it is kept, ties
included.

The batch reductions go through ``parallel.batch_sum`` / ``batch_mean``: in
a data-parallel step (``parallel.global_batch``) each loss is the global
batch's, as the JAX package's SPMD step takes it.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import batch_mean, batch_sum

EPS = 1e-6


def balanced_bce_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                      negative_ratio: float = 3.0) -> torch.Tensor:
    """Hard-negative-mined BCE over (B, H, W) probabilities; gt {0, 1}, mask
    the valid pixels. Keeps every positive and the hardest negatives."""
    pred = torch.clamp(pred, EPS, 1.0 - EPS)
    bce = -(gt * torch.log(pred) + (1.0 - gt) * torch.log(1.0 - pred))
    B = pred.shape[0]
    bce_f = bce.reshape(B, -1)
    pos_f = (gt * mask).reshape(B, -1)
    neg_f = ((1.0 - gt) * mask).reshape(B, -1)
    N = bce_f.shape[1]

    n_pos = pos_f.sum(1)
    n_neg_keep = torch.minimum(torch.clamp(n_pos * negative_ratio, min=1.0), neg_f.sum(1))
    neg_losses = torch.where(neg_f > 0, bce_f, -torch.inf)
    sorted_neg = torch.sort(neg_losses, dim=1, descending=True).values
    k_idx = torch.clamp(n_neg_keep.to(torch.int64) - 1, 0, N - 1)
    kth = sorted_neg.gather(1, k_idx[:, None])
    neg_keep = (neg_losses >= kth) & (neg_f > 0)

    pos_sum = (bce_f * pos_f).sum(1)
    neg_sum = torch.where(neg_keep, bce_f, 0.0).sum(1)
    denom = n_pos + neg_keep.sum(1) + EPS
    return batch_mean((pos_sum + neg_sum) / denom)


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1 - 2|X n Y| / (|X| + |Y|) over the masked pixels (the binary map's loss)."""
    inter, pp, gg = batch_sum(torch.stack(
        [(pred * gt * mask).sum(), (pred * pred * mask).sum(), (gt * gt * mask).sum()]))
    return 1.0 - 2.0 * inter / (pp + gg + EPS)


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - gt| over the mask's support (the threshold map's loss)."""
    num, den = batch_sum(torch.stack([(torch.abs(pred - gt) * mask).sum(), mask.sum()]))
    return num / (den + EPS)

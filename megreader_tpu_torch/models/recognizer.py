"""CTC word recognizer: ResNet (rec) -> height collapse -> encoder -> classifier.

Shape trace (config #1, NHWC in): (B, 32, 100, 3) -> resnet18-rec ->
(B, 512, 2, 25) -> mean over height -> (B, 25, 512) -> StackedBiLSTM(256) x2
-> (B, 25, 512) -> Linear(num_classes) -> (B, 25, 37).

``compute_dtype='bfloat16'`` is the JAX package's mixed precision: float32
parameters, bf16 convs and matmuls, BatchNorm and the LSTM cells in float32,
bf16 logits handed on as float32; the CTC loss takes its log-softmax in
float32, as the TPU kernel path does (``ops/ctc.py::ctc_loss``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.ctc import ctc_beam_decode, ctc_greedy_decode, ctc_loss
from ..ops.precision import Linear, parse_compute_dtype
from .resnet import resnet_variant
from .sequence import StackedBiLSTM, TransformerEncoder


def rec_feature_hw(crop_hw) -> Tuple[int, int]:
    """(H', W') of the 'rec' trunk's feature map for ``crop_hw`` crops: the
    2x2 pool, then stride 2 in height at stages 2-4 and in width at stage 2
    (padding 1: ceil)."""
    h, w = crop_hw[0] // 2, -(-(crop_hw[1] // 2) // 2)
    for _ in range(3):
        h = -(-h // 2)
    return h, w


class CTCRecognizerNet(nn.Module):
    """CNN + sequence encoder + per-timestep classifier; NHWC crops in,
    (B, T, num_classes) float32 logits out. ``dtype``: the compute dtype of
    the trunk, the BiLSTM and the classifier (None: promote, as flax).

    ``encoder``: 'bilstm', 'transformer' (``TransformerEncoder`` of width
    2 * ``hidden``, which takes no dtype) or 'none' (the classifier reads the
    collapsed features). ``height_collapse``: 'mean' over the rows, or
    'reshape', the rows stacked into channels (B, W', H' * C) with index
    h * C + c, as the JAX net's (B, H', W', C) -> (B, W', H' * C). 'reshape'
    and the transformer need the feature map's size, which the net takes
    from ``crop_hw`` (flax reads it at its first call). ``dcn_stages``:
    deformable 3x3 convs in those trunk stages (``resnet.py``)."""

    def __init__(self, num_classes: int, backbone: str = "resnet18", encoder: str = "bilstm",
                 hidden: int = 256, num_encoder_layers: int = 2,
                 height_collapse: str = "mean", dtype=None, crop_hw=(32, 100), dcn_stages=()):
        super().__init__()
        if height_collapse not in ("mean", "reshape"):
            raise ValueError(f"unknown height_collapse {height_collapse!r}")
        self.height_collapse = height_collapse
        self.backbone = resnet_variant(backbone, "rec", dtype=dtype, dcn_stages=dcn_stages)
        self.feature_hw = rec_feature_hw(crop_hw)
        width = self.backbone.out_channels[-1]
        if height_collapse == "reshape":
            width *= self.feature_hw[0]
        if encoder == "bilstm":
            self.encoder = StackedBiLSTM(width, hidden, num_encoder_layers, dtype)
            width = 2 * hidden
        elif encoder == "transformer":
            self.encoder = TransformerEncoder(width, self.feature_hw[1], dim=2 * hidden,
                                              num_layers=num_encoder_layers)
            width = 2 * hidden
        elif encoder == "none":
            self.encoder = None
        else:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.classifier = Linear(width, num_classes, compute_dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(images.permute(0, 3, 1, 2))  # (B, C, H', W')
        if self.height_collapse == "mean":
            seq = feat.mean(2).transpose(1, 2)  # (B, W', C)
        else:
            if tuple(feat.shape[2:]) != self.feature_hw:
                raise ValueError(f"feature map of {tuple(feat.shape[2:])}, but the net was "
                                 f"built for {self.feature_hw} (crops "
                                 f"{tuple(images.shape[1:3])}): build it with the crop_hw "
                                 "it is fed")
            B, C, H, W = feat.shape
            seq = feat.permute(0, 3, 2, 1).reshape(B, W, H * C)
        if self.encoder is not None:
            seq = self.encoder(seq)
        return self.classifier(seq).float()


class CTCRecognizer:
    """Task wrapper: the net on ``device``, the CTC training loss, greedy
    and prefix-beam decode. ``loss`` and ``decode`` put the net in train or
    eval mode themselves."""

    def __init__(self, num_classes: int = 37, backbone: str = "resnet18",
                 encoder: str = "bilstm", hidden: int = 256, num_encoder_layers: int = 2,
                 blank: int = 0, height_collapse: str = "mean", compute_dtype: str = "float32",
                 crop_hw=(32, 100), dcn_stages=(), device="cuda"):
        self.net = CTCRecognizerNet(
            num_classes, backbone, encoder, hidden, num_encoder_layers, height_collapse,
            parse_compute_dtype(compute_dtype), crop_hw, tuple(dcn_stages),
        ).to(device).eval()
        self.num_classes = num_classes
        self.blank = blank

    def loss(self, batch, train: bool = True):
        """batch: {image (B, H, W, 3), label (B, L) int32, label_length (B,)
        int32} on the net's device -> (mean CTC loss, {"loss": detached}).

        ``train`` runs BatchNorm on batch statistics and updates its running
        statistics; every row's logit length is T."""
        self.net.train(train)
        logits = self.net(batch["image"])
        B, T, _ = logits.shape
        logit_lengths = torch.full((B,), T, dtype=torch.int32, device=logits.device)
        loss = ctc_loss(logits, logit_lengths, batch["label"], batch["label_length"],
                        blank=self.blank)
        return loss, {"loss": loss.detach()}

    @torch.no_grad()
    def decode(self, images: torch.Tensor, mode: str = "greedy", net: nn.Module = None,
               beam_width: int = 8, blank_collapse: float = 1.0):
        """NHWC crops -> (ids (B, T) int32, lengths (B,) int32): ``mode``
        'greedy' or 'beam' (``ctc_beam_decode`` of width ``beam_width``;
        ``blank_collapse`` < 1 drops blank-dominated frames first). The
        logits are taken in float32. ``net`` overrides the wrapper's own
        module (same architecture)."""
        net = self.net if net is None else net
        logits = net.eval()(images).float()
        B, T, _ = logits.shape
        lengths = torch.full((B,), T, dtype=torch.int32, device=logits.device)
        if mode == "greedy":
            return ctc_greedy_decode(logits, lengths, blank=self.blank)
        if mode == "beam":
            return ctc_beam_decode(logits, lengths, beam_width=beam_width, blank=self.blank,
                                   blank_collapse=blank_collapse)
        raise ValueError(f"unknown decode mode {mode!r}")

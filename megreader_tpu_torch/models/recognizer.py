"""CTC word recognizer: ResNet (rec) -> height mean -> BiLSTM -> classifier.

Shape trace (config #1, NHWC in): (B, 32, 100, 3) -> resnet18-rec ->
(B, 512, 2, 25) -> mean over height -> (B, 25, 512) -> StackedBiLSTM(256) x2
-> (B, 25, 512) -> Linear(num_classes) -> (B, 25, 37).

``compute_dtype='bfloat16'`` is the JAX package's mixed precision: float32
parameters, bf16 convs and matmuls, BatchNorm and the LSTM cells in float32,
bf16 logits handed on as float32; the CTC loss takes its log-softmax in
float32, as the TPU kernel path does (``ops/ctc.py::ctc_loss``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.ctc import ctc_beam_decode, ctc_greedy_decode, ctc_loss
from ..ops.precision import Linear, parse_compute_dtype
from .resnet import resnet_variant
from .sequence import StackedBiLSTM


class CTCRecognizerNet(nn.Module):
    """CNN + BiLSTM encoder + per-timestep classifier; NHWC crops in,
    (B, T, num_classes) float32 logits out. ``dtype``: the compute dtype of
    the trunk, the encoder and the classifier (None: promote, as flax)."""

    def __init__(self, num_classes: int, backbone: str = "resnet18", encoder: str = "bilstm",
                 hidden: int = 256, num_encoder_layers: int = 2,
                 height_collapse: str = "mean", dtype=None):
        super().__init__()
        if encoder != "bilstm":
            raise NotImplementedError(
                f"encoder={encoder!r}: only the BiLSTM encoder is ported (ROADMAP Queue 1)"
            )
        if height_collapse != "mean":
            raise NotImplementedError(
                f"height_collapse={height_collapse!r}: only 'mean' is ported (ROADMAP Queue 1)"
            )
        self.backbone = resnet_variant(backbone, "rec", dtype=dtype)
        self.encoder = StackedBiLSTM(self.backbone.out_channels[-1], hidden, num_encoder_layers,
                                     dtype)
        self.classifier = Linear(2 * hidden, num_classes, compute_dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(images.permute(0, 3, 1, 2))  # (B, C, H', W')
        seq = feat.mean(2).transpose(1, 2)  # (B, W', C)
        return self.classifier(self.encoder(seq)).float()


class CTCRecognizer:
    """Task wrapper: the net on ``device``, the CTC training loss, greedy
    and prefix-beam decode. ``loss`` and ``decode`` put the net in train or
    eval mode themselves."""

    def __init__(self, num_classes: int = 37, backbone: str = "resnet18",
                 encoder: str = "bilstm", hidden: int = 256, num_encoder_layers: int = 2,
                 blank: int = 0, height_collapse: str = "mean", compute_dtype: str = "float32",
                 device="cuda"):
        self.net = CTCRecognizerNet(
            num_classes, backbone, encoder, hidden, num_encoder_layers, height_collapse,
            parse_compute_dtype(compute_dtype),
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

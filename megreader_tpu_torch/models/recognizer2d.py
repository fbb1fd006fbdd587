"""2D-CTC recognizer (judged config #2): ResNet rec2d -> 2-D prob map + height head.

Shape trace (config #2, NHWC in): (B, 32, 100, 3) -> resnet18-rec2d ->
(B, 512, 4, 25) -> (B, T=25, H=4, 512), the JAX package's (B, W, H, C) layout
->
  class head   -> (B, 25, 4, num_classes) log-softmax over classes
  height head  -> independent: (B, 25, 4) log-softmax over heights;
                  markov: transitions (B, 25, 4, 4) (rows h_prev, log-softmax
                  over the new height) and initial heights (B, 4) from column 0.

flax infers the height H' of the feature map when it builds the transition
head (``Dense(H)``); the port's net takes it from ``crop_hw`` at
construction (three halvings of the crop height, ceil after each stride-2
conv) and raises at forward if the feature map disagrees.

``compute_dtype='bfloat16'`` runs the trunk in bf16 (mixed precision,
float32 parameters); the heads take the features in float32, as flax casts
them, so the heads, the losses and the decodes stay float32 under mixed
precision and under the bf16 serving cast alike.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.ctc import ctc_beam_decode
from ..ops.ctc2d import (
    ctc2d_greedy_decode,
    ctc2d_loss_independent,
    ctc2d_loss_markov,
    ctc2d_viterbi_height_decode,
    fuse_heights,
)
from ..ops.precision import Linear, at_least_float32, parse_compute_dtype
from .resnet import resnet_variant

TRANSITIONS = ("independent", "markov")


def rec2d_feature_height(crop_h: int) -> int:
    """Rows of the rec2d feature map: the 2x2 pool, then the two stride-2
    convs of stages 2 and 3 (padding 1: ceil)."""
    h = crop_h // 2
    for _ in range(2):
        h = -(-h // 2)
    return h


class Ctc2dRecognizerNet(nn.Module):
    """rec2d trunk + per-cell class head + height head; NHWC crops in, a
    tuple of float32 log-probs out (see the module docstring)."""

    def __init__(self, num_classes: int, backbone: str = "resnet18",
                 transition: str = "independent", width: int = 64, crop_hw=(32, 100),
                 dtype=None):
        super().__init__()
        if transition not in TRANSITIONS:
            raise ValueError(f"unknown transition {transition!r}")
        self.transition = transition
        self.backbone = resnet_variant(backbone, "rec2d", width, dtype=dtype)
        feat = self.backbone.out_channels[-1]
        self.height = rec2d_feature_height(crop_hw[0])
        self.class_head = Linear(feat, num_classes)
        if transition == "independent":
            self.height_head = Linear(feat, 1)
        else:
            self.trans_head = Linear(feat, self.height)
            self.init_head = Linear(feat, 1)

    def forward(self, images: torch.Tensor):
        feat = self.backbone(images.permute(0, 3, 1, 2))  # (B, C, H', W')
        if feat.shape[2] != self.height:
            raise ValueError(f"feature map of height {feat.shape[2]}, but the net was built "
                             f"for {self.height} (crop height {images.shape[1]}): build it "
                             "with the crop_hw it is fed")
        # (B, T=W', H', C) in float32 (float64 in the tests); the heads
        # promote it with their weights
        feat = at_least_float32(feat.permute(0, 3, 2, 1))
        emit = torch.log_softmax(self.class_head(feat), -1)
        if self.transition == "independent":
            return emit, torch.log_softmax(self.height_head(feat)[..., 0], -1)
        trans = torch.log_softmax(self.trans_head(feat), -1)  # rows h_prev
        init = torch.log_softmax(self.init_head(feat[:, 0])[..., 0], -1)
        return emit, trans, init


class Ctc2dRecognizer:
    """Task wrapper: the net on ``device``, the 2D-CTC training loss and the
    decode (greedy or prefix beam for independent heights, Viterbi over the
    height chain for Markov heights). ``loss`` and ``decode`` put the net in
    train or eval mode themselves."""

    def __init__(self, num_classes: int = 37, backbone: str = "resnet18",
                 transition: str = "independent", blank: int = 0, width: int = 64,
                 compute_dtype: str = "float32", crop_hw=(32, 100), device="cuda"):
        self.net = Ctc2dRecognizerNet(num_classes, backbone, transition, width, crop_hw,
                                      parse_compute_dtype(compute_dtype)).to(device).eval()
        self.num_classes = num_classes
        self.transition = transition
        self.blank = blank

    def loss(self, batch, train: bool = True):
        """batch: {image (B, H, W, 3), label (B, L) int32, label_length (B,)
        int32} on the net's device -> (mean 2D-CTC loss, {"loss": detached}).

        ``train`` runs BatchNorm on batch statistics and updates its running
        statistics; every row's logit length is T."""
        self.net.train(train)
        heads = self.net(batch["image"])
        B, T = heads[0].shape[:2]
        lengths = torch.full((B,), T, dtype=torch.int32, device=heads[0].device)
        loss_fn = ctc2d_loss_independent if self.transition == "independent" else ctc2d_loss_markov
        loss = loss_fn(*heads, lengths, batch["label"], batch["label_length"], blank=self.blank)
        return loss, {"loss": loss.detach()}

    @torch.no_grad()
    def decode(self, images: torch.Tensor, mode: str = "greedy", net: nn.Module = None,
               beam_width: int = 8, blank_collapse: float = 1.0):
        """NHWC crops -> (ids (B, T) int32, lengths (B,) int32). Independent
        heights: ``mode`` 'greedy', or 'beam' (``ctc_beam_decode`` of the
        heights' fused 1-D posterior); Markov heights decode by Viterbi
        whatever ``mode`` says, as in the JAX package. ``net`` overrides the
        wrapper's own module (same architecture)."""
        net = self.net if net is None else net
        heads = tuple(h.float() for h in net.eval()(images))
        B, T = heads[0].shape[:2]
        lengths = torch.full((B,), T, dtype=torch.int32, device=heads[0].device)
        if self.transition == "markov":
            return ctc2d_viterbi_height_decode(*heads, lengths, blank=self.blank)
        if mode == "beam":
            return ctc_beam_decode(fuse_heights(*heads), lengths, beam_width=beam_width,
                                   blank=self.blank, blank_collapse=blank_collapse)
        if mode != "greedy":
            raise ValueError(f"unknown decode mode {mode!r}")
        return ctc2d_greedy_decode(*heads, lengths, blank=self.blank)

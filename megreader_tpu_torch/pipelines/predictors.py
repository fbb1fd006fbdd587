"""Recognizer predictor: word crops -> strings, batched on the model's device.

A port of ``megreader_tpu/pipelines/predictors.py::RecognizerPredictor`` for
the CTC and 2D-CTC families: canvases are resized to ``crop_hw`` with their
aspect kept (``resize_with_aspect_pad``) and normalized on the device, the
model decodes the batch there, and only ids and lengths cross to the host.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn

from ..core.charset import Charset
from ..models.recognizer import CTCRecognizer
from ..models.recognizer2d import Ctc2dRecognizer
from ..ops.image import normalize, resize_with_aspect_pad


class RecognizerPredictor:
    """Word crops -> strings, for ``CTCRecognizer`` and ``Ctc2dRecognizer``."""

    def __init__(self, model, charset=None, crop_hw=(32, 100), mode: str = "greedy"):
        if not isinstance(model, (CTCRecognizer, Ctc2dRecognizer)):
            raise NotImplementedError(
                f"{type(model).__name__}: the attention family is not ported "
                "(ROADMAP Queue 1 item 10)"
            )
        self.model = model
        self.charset = charset or Charset()
        self.crop_hw = tuple(crop_hw)
        self.mode = mode

    def prepare(self, canvases, sizes) -> torch.Tensor:
        """(B, H, W, 3) canvases with (B, 2) crop sizes -> normalized (B, Ho, Wo, 3)
        crops on the model's device."""
        device = next(self.model.net.parameters()).device
        images = torch.as_tensor(np.asarray(canvases)).to(device).float()
        img, _w = resize_with_aspect_pad(images, torch.as_tensor(np.asarray(sizes)).to(device),
                                         self.crop_hw)
        return normalize(img)

    def predict(self, net: nn.Module, canvases, sizes) -> List[str]:
        """``net`` (None: the model's own module) decodes the crops."""
        ids, lengths = self.model.decode(self.prepare(canvases, sizes), mode=self.mode, net=net)
        return self.charset.decode_batch(ids.cpu().numpy(), lengths.cpu().numpy())

"""Predictors: word crops -> strings, pages -> quads, batched on the model's device.

A port of ``megreader_tpu/pipelines/predictors.py``:

* ``RecognizerPredictor`` for the CTC, 2D-CTC and attention families:
  canvases are resized to ``crop_hw`` with their aspect kept
  (``resize_with_aspect_pad``) and normalized on the device, the model
  decodes the batch there (``mode`` 'greedy' or 'beam' of width
  ``beam_width``; Markov heights decode by Viterbi), and only ids and lengths
  cross to the host. With ``int8`` the whole decode runs under
  ``int8_context`` of the net (``ops/quantize.py``), as the JAX predictor
  runs its ``_decode``.
* ``DetectorPredictor`` for ``SegDetector``: pages are normalized on the
  device, the prob head alone runs, and the representer
  (``postproc/detection.py``, quad mode) turns the maps into scored quads.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..core.charset import AttentionCharset, Charset
from ..models.attention import AttentionRecognizer
from ..models.detector import SegDetector
from ..models.recognizer import CTCRecognizer
from ..models.recognizer2d import Ctc2dRecognizer
from ..ops.image import normalize, resize_with_aspect_pad
from ..ops.quantize import int8_context
from ..postproc.detection import SegDetectorRepresenter

RECOGNIZERS = (CTCRecognizer, Ctc2dRecognizer, AttentionRecognizer)


def default_charset(model) -> Charset:
    """The charset a recognizer's ids index: ``AttentionCharset`` for the
    attention family, the CTC ``Charset`` for the others."""
    return AttentionCharset() if isinstance(model, AttentionRecognizer) else Charset()


class RecognizerPredictor:
    """Word crops -> strings, for ``CTCRecognizer``, ``Ctc2dRecognizer`` and
    ``AttentionRecognizer``."""

    def __init__(self, model, charset=None, crop_hw=(32, 100), mode: str = "greedy",
                 beam_width: int = 8, int8: bool = False):
        if not isinstance(model, RECOGNIZERS):
            raise TypeError(f"{type(model).__name__} is not a recognizer")
        self.model = model
        self.charset = charset or default_charset(model)
        self.crop_hw = tuple(crop_hw)
        self.mode = mode
        self.beam_width = beam_width
        self.int8 = int8

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
        net = self.model.net if net is None else net
        images = self.prepare(canvases, sizes)
        with int8_context(net) if self.int8 else contextlib.nullcontext():
            ids, lengths = self.model.decode(images, mode=self.mode, net=net,
                                             beam_width=self.beam_width)
        return self.charset.decode_batch(ids.cpu().numpy(), lengths.cpu().numpy())


class DetectorPredictor:
    """Pages -> per-page quads and scores, for ``SegDetector``."""

    def __init__(self, model, representer: Optional[SegDetectorRepresenter] = None):
        if not isinstance(model, SegDetector):
            raise TypeError(f"{type(model).__name__} is not a SegDetector")
        self.model = model
        self.representer = representer or SegDetectorRepresenter()

    @torch.no_grad()
    def predict(self, net: nn.Module, pages, scales=None) -> List[Dict]:
        """``net`` (None: the model's own module) maps (B, H, W, 3) float32
        pages in [0, 255] to its prob maps; ``scales`` (B, 2) as the
        representer takes them. Returns per page {'polygons' (n, 4, 2),
        'scores' (n,)}."""
        net = self.model.net if net is None else net
        device = next(net.parameters()).device
        images = torch.as_tensor(np.asarray(pages, np.float32)).to(device)
        prob = net.eval()(normalize(images), heads=("prob",))["prob"]
        return self.representer.represent(prob, scales=scales)

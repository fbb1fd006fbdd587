"""Evaluation loops: recognition accuracy / NED, detection P/R/H-mean and
spotting accuracy / NED on GT boxes (``megreader_tpu/evaluation.py``): the
model's forward, the representer or the predictor, then the measurer, over
the experiment's eval set."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .ops.image import normalize
from .ops.quantize import int8_context
from .pipelines.predictors import RecognizerPredictor
from .postproc.detection import SegDetectorRepresenter
from .postproc.measurers import DetectionMeasurer, DetEvalMeasurer, RecognitionMeasurer


def evaluate_recognition(exp, net: nn.Module = None, mode: str = "greedy") -> Dict[str, float]:
    """Accuracy, normalized edit distance and count over ``exp.eval_loader``;
    ``net`` (None: the model's own module) decodes, by ``mode`` 'greedy' or
    'beam' (``RecognizerPredictor``'s width)."""
    if exp.eval_loader is None:
        raise ValueError("experiment has no eval dataset")
    predictor = RecognizerPredictor(exp.model, exp.charset, crop_hw=exp.crop_hw, mode=mode)
    preds, gts = [], []
    for batch in exp.eval_loader:
        preds.extend(predictor.predict(net, batch["image"], batch["size"]))
        gts.extend(exp.charset.normalize(t) for t in batch["text"])
    return RecognitionMeasurer().measure(preds, gts)


def evaluate_detection(exp, net: nn.Module = None,
                       representer: Optional[SegDetectorRepresenter] = None,
                       protocol: str = "icdar2015", int8: bool = False) -> Dict[str, float]:
    """Precision, recall and H-mean of the detector's quads over
    ``exp.eval_loader`` (``protocol`` 'icdar2015' or 'deteval'); ``net``
    (None: the model's own module) gives the prob maps, in eval mode, and
    under ``int8`` through int8 serving's layers (``ops/quantize.py``), the
    quality gate of that path."""
    if protocol not in ("icdar2015", "deteval"):
        raise ValueError(f"unknown detection protocol {protocol!r}")
    if exp.eval_loader is None:
        raise ValueError("experiment has no eval dataset")
    representer = representer or SegDetectorRepresenter()
    measurer = DetEvalMeasurer() if protocol == "deteval" else DetectionMeasurer()
    net = exp.model.net if net is None else net
    device = next(net.parameters()).device
    raws = []
    for batch in exp.eval_loader:
        # the pixels only: the prepare function's GT maps are not needed here
        x = normalize(torch.as_tensor(np.asarray(batch["image"])).to(device).float())
        with int8_context(net) if int8 else contextlib.nullcontext():
            prob = exp.model.predict_maps(x, net=net, heads=("prob",))["prob"]
        scales = np.asarray(batch["scale"])
        for b, res in enumerate(representer.represent(prob, scales=scales)):
            gt = [p * scales[b][None, :] for p in batch["polygons"][b]]
            raws.append(measurer.measure_one(list(res["polygons"]), gt, batch["ignore"][b]))
    return measurer.gather(raws)


def evaluate_spotting(exp, net: nn.Module = None) -> Dict[str, float]:
    """A spotter's accuracy, normalized edit distance and count over the
    valid GT boxes of ``exp.eval_loader`` (recognition given true
    localization): the prepared RoIs greedy-decoded by ``net`` (None: the
    model's own module), each valid slot's string against its transcript."""
    if exp.eval_loader is None:
        raise ValueError("experiment has no eval dataset")
    preds, gts = [], []
    for batch in exp.eval_loader:
        prepped = exp.prepare(batch)
        ids, lens = exp.model.decode(prepped["image"], prepped["rois"], net=net)
        valid = prepped["roi_valid"].cpu().numpy()
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for b, texts in enumerate(batch["texts"]):
            for k, t in enumerate(texts[:ids.shape[1]]):
                if valid[b, k]:
                    preds.append(exp.charset.decode(ids[b, k][:lens[b, k]]))
                    gts.append(exp.charset.normalize(t))
    return RecognitionMeasurer().measure(preds, gts)


def evaluate(exp, net: nn.Module = None, mode: str = "greedy", protocol: str = "icdar2015",
             representer_mode: str = "quad", int8: bool = False) -> Dict[str, float]:
    """The task's evaluation: detection for ``SegDetector`` (``int8`` as
    there), spotting for the spotters, else recognition; spotting and
    recognition ignore ``int8`` as the JAX package's do."""
    if exp.task in ("RoITextSpotter", "SharedTrunkSpotter"):
        return evaluate_spotting(exp, net)
    if exp.task != "SegDetector":
        return evaluate_recognition(exp, net, mode=mode)
    return evaluate_detection(exp, net, representer=SegDetectorRepresenter(mode=representer_mode),
                              protocol=protocol, int8=int8)

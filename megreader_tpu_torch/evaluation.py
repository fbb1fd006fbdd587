"""Recognition evaluation: the experiment's eval set through the predictor and
the measurer (``megreader_tpu/evaluation.py::evaluate_recognition``)."""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from .pipelines.predictors import RecognizerPredictor
from .postproc.measurers import RecognitionMeasurer


def evaluate_recognition(exp, net: nn.Module = None, mode: str = "greedy") -> Dict[str, float]:
    """Accuracy, normalized edit distance and count over ``exp.eval_loader``;
    ``net`` (None: the model's own module) decodes."""
    if exp.eval_loader is None:
        raise ValueError("experiment has no eval dataset")
    predictor = RecognizerPredictor(exp.model, exp.charset, crop_hw=exp.crop_hw, mode=mode)
    preds, gts = [], []
    for batch in exp.eval_loader:
        preds.extend(predictor.predict(net, batch["image"], batch["size"]))
        gts.extend(exp.charset.normalize(t) for t in batch["text"])
    return RecognitionMeasurer().measure(preds, gts)

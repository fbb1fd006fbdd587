"""Experiment: wire a recognizer, its data and its optimizer into a trainer.

The recognition branch of ``megreader_tpu/experiment.py``, built from Python
objects: ``recognition_collate`` on the host (uint8 canvases, encoded
labels), and a prepare function that moves each batch to the model's device,
casts it there, resizes each crop to ``crop_hw`` with its aspect kept
(``resize_with_aspect_pad``) and normalizes it. With ``validate_every_steps``
and an eval dataset, the trainer runs ``evaluation.evaluate_recognition``
(greedy, or Viterbi for Markov heights) every so many steps.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from .core.charset import Charset
from .data.loader import Loader, recognition_collate
from .evaluation import evaluate_recognition
from .ops.image import normalize, resize_with_aspect_pad
from .train.train_step import OptimizerConfig
from .train.trainer import Trainer

RECOGNITION_TASKS = {"CTCRecognizer", "Ctc2dRecognizer"}


def _recognition_prepare(batch: Dict, crop_hw=(32, 100), device="cuda") -> Dict:
    """Host batch (numpy) -> model batch on ``device``: uint8 over the wire,
    cast on the device."""
    images = torch.as_tensor(np.asarray(batch["image"])).to(device).float()
    sizes = torch.as_tensor(np.asarray(batch["size"])).to(device)
    img, _w = resize_with_aspect_pad(images, sizes, tuple(crop_hw))
    return {
        "image": normalize(img),
        "label": torch.as_tensor(np.asarray(batch["label"])).to(device),
        "label_length": torch.as_tensor(np.asarray(batch["label_length"])).to(device),
    }


class Experiment:
    """Model + dataset + optimizer + trainer wiring, for ``CTCRecognizer`` and
    ``Ctc2dRecognizer`` (whose net must be built for the same ``crop_hw``)."""

    def __init__(
        self,
        model,
        train_dataset=None,
        eval_dataset=None,
        optimizer: Optional[OptimizerConfig] = None,
        charset=None,
        workspace: str = "/tmp/megreader_tpu_exp",
        batch_size: int = 64,
        epochs: int = 10,
        crop_hw=(32, 100),
        max_label_len: int = 32,
        log_every: int = 50,
        use_mesh: bool = False,
        augment: bool = False,
        validate_every_steps: int = 0,
        loader_workers: int = 4,
        loader_worker_mode: str = "thread",
    ):
        self.model = model
        self.task = model.__class__.__name__
        if self.task not in RECOGNITION_TASKS:
            raise NotImplementedError(
                f"task {self.task}: only the CTC and 2D-CTC recognizers' training is "
                "ported (ROADMAP Queue 1 items 7, 10, 13)"
            )
        if augment:
            raise NotImplementedError(
                "augment=True: device augmentation is not ported (ROADMAP Queue 1 item 7)"
            )
        self.workspace = workspace
        self.crop_hw = tuple(crop_hw)
        self.charset = charset or Charset()
        self.collate = functools.partial(
            recognition_collate, charset=self.charset, max_label_len=max_label_len
        )
        device = next(model.net.parameters()).device
        self.prepare = functools.partial(_recognition_prepare, crop_hw=self.crop_hw,
                                         device=device)
        self.train_loader = (
            Loader(train_dataset, batch_size, self.collate, shuffle=True, host_shard=True,
                   workers=loader_workers, worker_mode=loader_worker_mode)
            if train_dataset is not None else None
        )
        self.eval_loader = (
            Loader(eval_dataset, batch_size, self.collate, shuffle=False, drop_last=False,
                   workers=loader_workers, worker_mode=loader_worker_mode)
            if eval_dataset is not None else None
        )
        self.optimizer = optimizer or OptimizerConfig()
        self.epochs = epochs
        self.log_every = log_every
        self.use_mesh = use_mesh
        self.validate_every_steps = validate_every_steps

    def make_trainer(self) -> Trainer:
        if self.train_loader is None:
            raise ValueError("experiment has no train dataset")
        validate_fn = None
        if self.validate_every_steps and self.eval_loader is not None:
            def validate_fn(model, state):
                return evaluate_recognition(self, state.module)

        return Trainer(
            model=self.model,
            loader=self.train_loader,
            optimizer=self.optimizer,
            workspace=self.workspace,
            epochs=self.epochs,
            log_every=self.log_every,
            use_mesh=self.use_mesh,
            prepare_batch=self.prepare,
            validate_every_steps=self.validate_every_steps,
            validate_fn=validate_fn,
        )

    @staticmethod
    def from_yaml(path: str, overrides: Optional[Dict[str, Any]] = None) -> "Experiment":
        raise NotImplementedError(
            "from_yaml: YAML configs and the component registry are not ported "
            "(ROADMAP Queue 1 item 8)"
        )

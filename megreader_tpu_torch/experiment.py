"""Experiment: wire a model, its data and its optimizer into a trainer.

The recognition and detection branches of ``megreader_tpu/experiment.py``,
built from Python objects.

* Recognition: ``recognition_collate`` on the host (uint8 canvases, encoded
  labels), and a prepare function that moves each batch to the model's
  device, casts it there, resizes each crop to ``crop_hw`` with its aspect
  kept (``resize_with_aspect_pad``) and normalizes it. With ``augment``,
  the resize carries random geometric and photometric jitter
  (``augment_resize_with_aspect_pad``) from a ``torch.Generator`` on the
  model's device seeded by (``seed``, the train step) alone: the JAX
  package's ``fold_in(PRNGKey(seed), step)``, pure in both, so no state
  lives between calls. The detection task ignores ``augment``, as in JAX.
* Detection (``SegDetector``): with ``device_gt`` (the default), the host
  ships pages and padded polygon buffers (``detection_collate_polys``, at
  least ``max_polys`` slots) and the prepare function rasterizes the GT maps
  on the device (``ops/gt_maps.make_detection_gt``) with the train dataset's
  shrink ratio, minimal text size and threshold range, and turns the
  datasets' host maps off; without it, the datasets' host maps travel in
  compact types (``detection_collate``) and are cast on the device.

* Spotting (``RoITextSpotter``, ``SharedTrunkSpotter``): the host ships
  pages, padded polygon buffers and each polygon's encoded transcript
  (``spotting_collate``); the prepare function turns the polygons into
  axis-aligned RoIs with a 2-pixel margin and the valid, unignored slots
  into ``roi_valid``. The shared-trunk spotter also trains its detection
  heads on the datasets' host GT maps, which pass through; the RoI spotter
  turns them off.

With ``validate_every_steps`` and an eval dataset, the trainer runs
``evaluation.evaluate`` every so many steps: ``evaluate_recognition``
(greedy, or Viterbi for Markov heights), ``evaluate_detection`` or
``evaluate_spotting``.

``Experiment.from_yaml`` builds one from an ``experiments/*.yaml`` file
through the port's registry (``all.py``, ``core/config.py``).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, Optional

import numpy as np
import torch

from .data.loader import (
    Loader,
    detection_collate,
    detection_collate_polys,
    recognition_collate,
    spotting_collate,
)
from .core.config import Config
from .evaluation import evaluate
from .ops.gt_maps import make_detection_gt
from .ops.image import augment_resize_with_aspect_pad, normalize, resize_with_aspect_pad
from .pipelines.predictors import default_charset
from .train.train_step import OptimizerConfig
from .train.trainer import Trainer

RECOGNITION_TASKS = {"CTCRecognizer", "Ctc2dRecognizer", "AttentionRecognizer"}
DETECTION_TASKS = {"SegDetector"}
SPOTTING_TASKS = {"RoITextSpotter", "SharedTrunkSpotter"}
#: the dataset attributes that set the device GT maps' geometry
_GT_ATTRS = ("shrink_ratio", "min_text_size", "thresh_min", "thresh_max")


def augment_generator(seed: int, step: int, device) -> torch.Generator:
    """A fresh generator on ``device`` whose stream is a function of (seed,
    step) alone: the two are mixed by numpy's ``SeedSequence``."""
    key = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _recognition_prepare(batch: Dict, crop_hw=(32, 100), device="cuda",
                         augment_gen: Optional[torch.Generator] = None) -> Dict:
    """Host batch (numpy) -> model batch on ``device``: uint8 over the wire,
    cast on the device; with ``augment_gen``, the augmented resize."""
    images = torch.as_tensor(np.asarray(batch["image"])).to(device).float()
    sizes = torch.as_tensor(np.asarray(batch["size"])).to(device)
    if augment_gen is not None:
        img, _w = augment_resize_with_aspect_pad(augment_gen, images, sizes, tuple(crop_hw))
    else:
        img, _w = resize_with_aspect_pad(images, sizes, tuple(crop_hw))
    return {
        "image": normalize(img),
        "label": torch.as_tensor(np.asarray(batch["label"])).to(device),
        "label_length": torch.as_tensor(np.asarray(batch["label_length"])).to(device),
    }


def _recognition_prepare_augmented(batch: Dict, step: int = 0, crop_hw=(32, 100),
                                   device="cuda", seed: int = 0) -> Dict:
    """``_recognition_prepare`` with the augmentation stream of (seed, step)."""
    return _recognition_prepare(batch, crop_hw, device,
                                augment_gen=augment_generator(seed, step, device))


def _detection_prepare(batch: Dict, device="cuda") -> Dict:
    """Host GT maps (compact types) -> float32 maps on ``device``."""
    out = {"image": normalize(torch.as_tensor(np.asarray(batch["image"])).to(device).float())}
    for k in ("gt", "mask", "thresh_map", "thresh_mask"):
        out[k] = torch.as_tensor(np.asarray(batch[k])).to(device).float()
    return out


def _detection_prepare_device(batch: Dict, gt_kwargs: Optional[Dict] = None,
                              device="cuda") -> Dict:
    """Pages and polygon buffers -> pages and GT maps rasterized on ``device``;
    a batch that still carries host maps passes them through."""
    if "gt" in batch:
        return _detection_prepare(batch, device)
    image = torch.as_tensor(np.asarray(batch["image"])).to(device).float()
    maps = make_detection_gt(
        *(torch.as_tensor(np.asarray(batch[k])).to(device)
          for k in ("polys", "poly_valid", "poly_ignore")),
        hw=(image.shape[1], image.shape[2]), **(gt_kwargs or {}),
    )
    return {"image": normalize(image), **maps}


def _spotting_prepare(batch: Dict, box_margin: float = 2.0, device="cuda") -> Dict:
    """Host spotting batch -> pages, RoIs (B, P, 4) from the polygons'
    bounds widened by ``box_margin`` and clamped to the page, ``roi_valid``
    (valid and not ignored), labels; host GT maps, where present, as float32
    maps."""
    image = normalize(torch.as_tensor(np.asarray(batch["image"])).to(device).float())
    polys = torch.as_tensor(np.asarray(batch["polys"])).to(device)  # (B, P, 4, 2)
    H, W = image.shape[1], image.shape[2]
    m = box_margin
    rois = torch.stack([
        torch.clamp(polys[..., 0].amin(-1) - m, 0, W - 1),
        torch.clamp(polys[..., 1].amin(-1) - m, 0, H - 1),
        torch.clamp(polys[..., 0].amax(-1) + m, 1, W),
        torch.clamp(polys[..., 1].amax(-1) + m, 1, H),
    ], -1)
    as_dev = lambda k: torch.as_tensor(np.asarray(batch[k])).to(device)  # noqa: E731
    out = {"image": image, "rois": rois,
           "roi_valid": as_dev("poly_valid") & ~as_dev("poly_ignore"),
           "label": as_dev("label"), "label_length": as_dev("label_length")}
    for k in ("gt", "mask", "thresh_map", "thresh_mask"):
        if k in batch:
            out[k] = as_dev(k).float()
    return out


def _model_takes_crop_hw(node: Dict) -> None:
    """Give the model node the experiment's ``crop_hw`` where its class
    takes one and the node sets none: flax infers the 2D and attention
    nets' feature height from the first batch, the port builds it from
    ``crop_hw``."""
    from .core.registry import COMPONENTS

    model = node.get("model")
    if "crop_hw" not in node or not isinstance(model, dict) or "crop_hw" in model:
        return
    name = model.get("class")
    if name in COMPONENTS and "crop_hw" in inspect.signature(COMPONENTS.get(name)).parameters:
        model["crop_hw"] = node["crop_hw"]


class Experiment:
    """Model + dataset + optimizer + trainer wiring, for ``CTCRecognizer``,
    ``Ctc2dRecognizer`` and ``AttentionRecognizer`` (whose nets must be built
    for the same ``crop_hw``; the attention task's charset defaults to
    ``AttentionCharset``), ``SegDetector``, ``RoITextSpotter`` and
    ``SharedTrunkSpotter``.

    ``use_mesh`` goes to the trainer: data parallelism over the process
    group that is up (``parallel/mesh.py``), each rank on its share of the
    train set (``host_shard``). Its default stays False where the JAX
    package's is True: with no process group the mesh step is the plain
    step, and no YAML file sets it, so ``from_yaml`` needs no other."""

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
        device_gt: bool = True,
        max_polys: int = 16,
        loader_workers: int = 4,
        loader_worker_mode: str = "thread",
        seed: int = 0,
        name: str = "exp",
    ):
        self.model = model
        self.task = model.__class__.__name__
        if self.task not in RECOGNITION_TASKS | DETECTION_TASKS | SPOTTING_TASKS:
            raise ValueError(f"unknown task for model {self.task}")
        self.workspace = workspace
        self.name = name
        #: the seed of the initial weights' draw and of the augmentation
        #: stream. The JAX trainer draws the weights from PRNGKey(seed); here
        #: the model exists before the experiment, so ``from_yaml`` builds
        #: the YAML's graph under ``torch.manual_seed`` of it.
        self.seed = seed
        self.augment = augment
        self.crop_hw = tuple(crop_hw)
        self.charset = charset or default_charset(model)
        device = next(model.net.parameters()).device
        if self.task in RECOGNITION_TASKS:
            self.collate = functools.partial(
                recognition_collate, charset=self.charset, max_label_len=max_label_len
            )
            if augment:
                self.prepare = functools.partial(_recognition_prepare_augmented,
                                                 crop_hw=self.crop_hw, device=device, seed=seed)
            else:
                self.prepare = functools.partial(_recognition_prepare, crop_hw=self.crop_hw,
                                                 device=device)
        elif self.task in SPOTTING_TASKS:
            self.collate = functools.partial(spotting_collate, charset=self.charset,
                                             max_polys=max_polys, max_label_len=max_label_len)
            self.prepare = functools.partial(_spotting_prepare, device=device)
            if self.task != "SharedTrunkSpotter":  # the joint task trains on host GT maps
                for ds in (train_dataset, eval_dataset):
                    if ds is not None and hasattr(ds, "gt_maps"):
                        ds.gt_maps = False
        elif device_gt:
            self.collate = functools.partial(detection_collate_polys, max_polys=max_polys)
            gt_kwargs = {a: float(getattr(train_dataset, a)) for a in _GT_ATTRS
                         if getattr(train_dataset, a, None) is not None}
            self.prepare = functools.partial(_detection_prepare_device, gt_kwargs=gt_kwargs,
                                             device=device)
            for ds in (train_dataset, eval_dataset):
                if ds is not None and hasattr(ds, "gt_maps"):
                    ds.gt_maps = False  # no host rasterization
        else:
            self.collate = detection_collate
            self.prepare = functools.partial(_detection_prepare, device=device)
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
                return evaluate(self, state.module)

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
        """The ``experiment:`` node of a YAML file (``import:`` composed,
        dotted ``overrides`` applied) built through the port's registry; the
        weights are drawn under ``torch.manual_seed`` of its ``seed``."""
        from . import all as _all  # noqa: F401  (fills the registry, once)

        cfg = Config.load(path, overrides)
        node = cfg.get("experiment")
        seed = node.get("seed", 0) if isinstance(node, dict) else 0
        if isinstance(node, dict):
            _model_takes_crop_hw(node)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            graph = Config.compile(cfg)
        exp = graph.get("experiment") if isinstance(graph, dict) else graph
        if not isinstance(exp, Experiment):
            raise ValueError(f"{path} must define an 'experiment:' node with class: Experiment")
        return exp

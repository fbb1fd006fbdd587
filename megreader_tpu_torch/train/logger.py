"""Experiment workspace and metrics logging.

Scalars go to ``{workspace}/{name}_metrics.jsonl`` as ``{"step", "t", ...}``
lines, as in the JAX package, and a periodic "epoch/step/lr/means/speed" line
goes to stdout. There is no TensorBoard writer: ``use_tensorboard`` is
accepted and has no effect, as in the JAX package when TensorFlow is missing.
Only the primary process (rank 0, or the only one) writes.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict

from ..parallel.mesh import is_primary


class AverageMeter:
    """Running mean."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self):
        self.sum, self.count = 0.0, 0


class Logger:
    def __init__(self, workspace: str, name: str = "train", use_tensorboard: bool = True):
        self.workspace = workspace
        self.primary = is_primary()
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self._t0 = time.time()
        self._jsonl = None
        if self.primary:
            os.makedirs(workspace, exist_ok=True)
            self._jsonl = open(os.path.join(workspace, f"{name}_metrics.jsonl"), "a")

    def info(self, msg: str):
        if self.primary:
            print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        for k, v in scalars.items():
            self.meters[k].update(float(v))
        if not self.primary:
            return
        rec = {"step": step, "t": time.time() - self._t0, **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def report(self, epoch: int, step: int, lr: float, images_per_sec: float):
        parts = " ".join(f"{k}={m.avg:.4f}" for k, m in sorted(self.meters.items()))
        self.info(f"epoch {epoch} step {step} lr {lr:.5f} {parts} speed {images_per_sec:.1f} im/s")
        for m in self.meters.values():
            m.reset()

    def metrics(self, step: int, metrics: Dict[str, float], prefix: str = "eval"):
        self.info(f"{prefix}@{step}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        self.add_scalars(step, {f"{prefix}/{k}": v for k, v in metrics.items()})

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None

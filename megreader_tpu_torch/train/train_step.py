"""Optimizer, schedules and the train/eval steps.

A port of ``megreader_tpu/train/train_step.py`` with optax's update rules:

* ``OptimizerConfig.make_schedule()`` returns ``step -> lr`` equal to optax's
  ``constant``, ``polynomial`` (``poly``), ``cosine_decay`` (``cosine``) and,
  for ``warmup_cosine`` or any ``warmup_steps > 0``, a linear warm-up from 0
  joined to the base schedule, which then starts again at 0 (optax's
  ``join_schedules``).
* ``OptimizerConfig.make(params)`` returns an :class:`Optimizer`: optax's
  ``clip_by_global_norm`` written out, then ``torch.optim.SGD`` (decay added to
  the gradient, heavy-ball momentum without dampening: optax's
  ``add_decayed_weights`` + ``sgd``) or ``torch.optim.AdamW`` (b1 0.9, b2
  0.999, eps 1e-8, decay on every parameter: optax's ``adamw``), with the
  learning rate set to ``schedule(n)`` before the n-th update (n from 0, as
  optax counts).

A train step is prepare -> loss -> backward -> clip -> update, eagerly on the
module's device; its metrics stay on the device until a caller reads them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def _cosine_decay(init: float, steps: int) -> Schedule:
    if not steps > 0:
        raise ValueError(f"cosine decay needs positive total_steps, got {steps}")

    def schedule(count):
        return init * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


class OptimizerConfig:
    """Optimizer and schedule settings, with the JAX package's names and defaults."""

    def __init__(
        self,
        name: str = "sgd",
        lr: float = 0.007,
        momentum: float = 0.9,
        weight_decay: float = 1e-4,
        schedule: str = "poly",  # 'constant' | 'poly' | 'cosine' | 'warmup_cosine'
        total_steps: int = 100_000,
        warmup_steps: int = 0,
        power: float = 0.9,
        grad_clip: Optional[float] = None,
        accumulate_steps: int = 1,
    ):
        self.name = name
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.schedule = schedule
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.power = power
        self.grad_clip = grad_clip
        self.accumulate_steps = accumulate_steps

    def make_schedule(self) -> Schedule:
        if self.schedule == "constant":
            base = lambda count: self.lr  # noqa: E731
        elif self.schedule == "poly":
            base = _polynomial(self.lr, 0.0, self.power, self.total_steps)
        elif self.schedule in ("cosine", "warmup_cosine"):
            base = _cosine_decay(self.lr, self.total_steps)
        else:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.warmup_steps > 0 or self.schedule == "warmup_cosine":
            warm = max(self.warmup_steps, 1)
            base = _join(_polynomial(0.0, self.lr, 1.0, warm), base, warm)
        return base

    def make(self, params: Iterable[nn.Parameter]) -> "Optimizer":
        if self.accumulate_steps > 1:
            raise NotImplementedError(
                "accumulate_steps > 1 (optax.MultiSteps) is not ported (ROADMAP Queue 1 item 7)"
            )
        params = list(params)
        if self.name == "sgd":
            inner = torch.optim.SGD(params, lr=0.0, momentum=self.momentum,
                                    weight_decay=self.weight_decay)
        elif self.name in ("adam", "adamw"):
            inner = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=self.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {self.name!r}")
        return Optimizer(inner, self.make_schedule(), self.grad_clip)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Optimizer:
    """A torch optimizer driven by optax's schedule count and global-norm clip."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 grad_clip: Optional[float] = None):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = grad_clip
        #: updates applied so far (optax's schedule count)
        self.count = 0

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, set the learning rate, update; returns the global norm of the
        gradients before clipping (a device scalar)."""
        grads = [p.grad for group in self.inner.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = global_norm(grads)
        if self.grad_clip:
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.inner.load_state_dict(state["inner"])


@dataclass
class TrainState:
    """The step count, the module being trained, and its optimizer (which
    holds the optimizer state)."""

    step: int
    module: nn.Module
    optimizer: Optimizer


def create_train_state(model, optimizer: OptimizerConfig) -> TrainState:
    """A fresh state for ``model`` (a task wrapper with ``.net`` and ``.loss``)."""
    return TrainState(step=0, module=model.net, optimizer=optimizer.make(model.net.parameters()))


def make_train_step(model, prepare: Optional[Callable[[Dict], Dict]] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``step(state, batch) -> (state, metrics)``: prepare, the loss in train
    mode, backward, clip, update. Metrics: ``loss`` and ``grad_norm`` (before
    clipping), device scalars. The state's module is the model's net and is
    updated in place."""

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if prepare is not None:
            batch = prepare(batch)
        state.optimizer.zero_grad()
        loss, metrics = model.loss(batch, train=True)
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        return state, {**metrics, "grad_norm": grad_norm}

    return step


def make_eval_step(model) -> Callable[[TrainState, Dict], Dict]:
    """``step(state, batch) -> metrics``: the loss in eval mode, no gradient."""

    def step(state: TrainState, batch: Dict) -> Dict:
        with torch.no_grad():
            _, metrics = model.loss(batch, train=False)
        return metrics

    return step

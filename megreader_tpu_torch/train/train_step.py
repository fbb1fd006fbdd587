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
* ``accumulate_steps = k > 1`` is optax's ``MultiSteps(tx, k)``: each
  mini-step folds its gradients into a running mean (``acc + (g - acc) /
  (n + 1)``, MultiSteps' own arithmetic); every k-th mini-step clips,
  schedules and updates on that mean and counts one update, and between
  those the parameters stay as they are.

A train step is prepare -> loss -> backward -> clip -> update, eagerly on the
module's device; its metrics stay on the device until a caller reads them.
A prepare function that declares a ``step`` parameter gets the train state's
step (the JAX trainer's rule for step-keyed augmentation streams).

With a mesh (``parallel/mesh.py``) each rank steps on its local batch, and
the step is the JAX package's SPMD step on the global batch (the ranks'
batches stacked): the loss runs within ``parallel.global_batch``, so its
batch reductions (the CTC losses' and the DB loss's per-sample means, the
attention loss's token-weighted mean, the dice and L1 ratios of sums) sum
across the ranks and every rank holds the global batch's loss; each rank
back-propagates ``1 / world_size`` of it (the reductions' backward sums the
ranks' shares again), and the gradients are summed across the ranks
before the clip and the update. The metrics are the global batch's.
"""

from __future__ import annotations

import inspect
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
        params = list(params)
        if self.name == "sgd":
            inner = torch.optim.SGD(params, lr=0.0, momentum=self.momentum,
                                    weight_decay=self.weight_decay)
        elif self.name in ("adam", "adamw"):
            inner = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=self.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {self.name!r}")
        return Optimizer(inner, self.make_schedule(), self.grad_clip, self.accumulate_steps)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Optimizer:
    """A torch optimizer driven by optax's schedule count and global-norm clip,
    with MultiSteps' gradient accumulation when ``accumulate_steps > 1``."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 grad_clip: Optional[float] = None, accumulate_steps: int = 1):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.accumulate_steps = accumulate_steps
        #: updates applied so far (optax's schedule count)
        self.count = 0
        #: mini-steps folded into ``acc`` since the last update
        self.mini_step = 0
        #: the running mean of the cycle's gradients, one per parameter
        #: (None until the first mini-step)
        self.acc: Optional[list] = None

    def _params(self):
        return [p for group in self.inner.param_groups for p in group["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, set the learning rate, update; returns the global norm of the
        gradients before clipping (a device scalar). Under accumulation it
        folds the gradients into the cycle's mean, updates on that mean at
        the cycle's last mini-step only, and returns the mini-batch's norm."""
        if self.accumulate_steps <= 1:
            grads = [p.grad for p in self._params() if p.grad is not None]
            norm = global_norm(grads)
            self._update(grads, norm)
            return norm
        params = self._params()
        # a parameter without a gradient takes zeros, as a flax tree has them
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        norm = global_norm(grads)
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.mini_step + 1))
        self.mini_step += 1
        if self.mini_step == self.accumulate_steps:
            for p, a in zip(params, self.acc):
                p.grad = a.clone()
            mean = [p.grad for p in params]
            self._update(mean, global_norm(mean))
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        return norm

    def _update(self, grads, norm: torch.Tensor) -> None:
        if self.grad_clip:
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self) -> Dict:
        state = {"count": self.count, "inner": self.inner.state_dict()}
        if self.accumulate_steps > 1:
            state["mini_step"] = self.mini_step
            state["acc"] = [a.clone() for a in self.acc] if self.acc is not None else None
        return state

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state.get("mini_step", 0))
        acc = state.get("acc")
        self.acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype).clone() for a, p in zip(acc, self._params())]


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


def wants_step(prepare: Optional[Callable]) -> bool:
    """Whether a prepare function declares a ``step`` parameter."""
    if prepare is None:
        return False
    try:
        return "step" in inspect.signature(prepare).parameters
    except (TypeError, ValueError):
        return False


def make_train_step(model, prepare: Optional[Callable[[Dict], Dict]] = None, mesh=None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``step(state, batch) -> (state, metrics)``: prepare (given
    ``step=state.step`` when it declares ``step``), the loss in train mode,
    backward, clip, update. Metrics: ``loss`` and ``grad_norm`` (the
    mini-batch's, before clipping), device scalars. The state's module is the
    model's net and is updated in place. With ``mesh``, the global batch's
    step (see the module docstring)."""
    from ..parallel.mesh import all_reduce_sum_, global_batch

    with_step = wants_step(prepare)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if prepare is not None:
            batch = prepare(batch, step=state.step) if with_step else prepare(batch)
        state.optimizer.zero_grad()
        with global_batch(mesh):
            loss, metrics = model.loss(batch, train=True)
        if mesh is None:
            loss.backward()
        else:
            (loss / mesh.world_size).backward()
            all_reduce_sum_([p.grad for p in state.module.parameters() if p.grad is not None],
                            mesh)
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

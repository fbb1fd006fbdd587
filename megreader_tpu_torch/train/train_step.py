"""Optimizer, schedules and the train/eval steps.

A port of ``megreader_tpu/train/train_step.py`` with optax's update rules:

* ``OptimizerConfig.make_schedule()`` returns ``step -> lr`` equal to optax's
  ``constant``, ``polynomial`` (``poly``), ``cosine_decay`` (``cosine``) and,
  for ``warmup_cosine`` or any ``warmup_steps > 0``, a linear warm-up from 0
  joined to the base schedule, which then starts again at 0 (optax's
  ``join_schedules``).
* ``OptimizerConfig.make(module)`` returns an :class:`Optimizer` over the
  module's parameters: optax's
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
* ``Optimizer.load_optax_state(tree)`` takes the optax state of a JAX train
  state (the tree ``OptimizerConfig.make().init(params)`` builds, as flax's
  state dict: tuples as {"0": ..., "1": ...}, optax's named tuples as
  dicts, empty states as {}) and ``export_optax_state()`` gives it back:
  ``clip_by_global_norm``'s empty state; ``adamw``'s ``ScaleByAdamState(count,
  mu, nu)`` <-> AdamW's ``step``/``exp_avg``/``exp_avg_sq``; ``sgd``'s
  ``TraceState(trace)`` <-> the momentum buffer; the schedule's count <->
  ``count``; ``MultiStepsState(mini_step, gradient_step, inner_opt_state,
  acc_grads, skip_state)`` <-> ``mini_step``/``acc``. Moments match
  parameters by their flax paths (``compat/weights.py``'s name maps); a
  missing or leftover leaf, a shape that differs or counts that disagree
  raise.

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
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
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

    def make(self, module: nn.Module) -> "Optimizer":
        """An :class:`Optimizer` over ``module``'s parameters."""
        params = list(module.parameters())
        if self.name == "sgd":
            inner = torch.optim.SGD(params, lr=0.0, momentum=self.momentum,
                                    weight_decay=self.weight_decay)
        elif self.name in ("adam", "adamw"):
            inner = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=self.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {self.name!r}")
        return Optimizer(inner, module, self.make_schedule(), self.grad_clip,
                         self.accumulate_steps)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Optimizer:
    """A torch optimizer driven by optax's schedule count and global-norm clip,
    with MultiSteps' gradient accumulation when ``accumulate_steps > 1``."""

    def __init__(self, inner: torch.optim.Optimizer, module: nn.Module, schedule: Schedule,
                 grad_clip: Optional[float] = None, accumulate_steps: int = 1):
        self.inner = inner
        #: the module whose parameters ``inner`` steps, in its order (for the
        #: optax state's flax paths)
        self.module = module
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


    # -- the optax state of a JAX train state ---------------------------------
    def _named_params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self.module.named_parameters())

    def _per_param(self, tree: Dict) -> List[torch.Tensor]:
        """A flax params tree -> one tensor a parameter, on its device and dtype."""
        from ..compat.weights import port_arrays

        named = self._named_params()
        arrays = port_arrays(self.module, {"params": tree}, ("params",))
        return [torch.from_numpy(arrays[n]).to(device=p.device, dtype=p.dtype) for n, p in named]

    def _flax_tree(self, tensors: List[torch.Tensor]) -> Dict:
        from ..compat.weights import export_flax_variables

        named = self._named_params()
        out = export_flax_variables(self.module, {n: t for (n, _), t in zip(named, tensors)})
        return out.get("params", {})

    def _tx_layout(self) -> str:
        if isinstance(self.inner, torch.optim.AdamW):
            return "adamw"
        if isinstance(self.inner, torch.optim.SGD):
            return "sgd"
        raise ValueError(f"no optax state for {type(self.inner).__name__}")

    @torch.no_grad()
    def load_optax_state(self, tree: Dict) -> None:
        """Take a JAX optax state (see the module's docstring) in place."""
        params = self._params()
        if self.accumulate_steps > 1:
            _keys(tree, {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                         "skip_state"}, "MultiStepsState")
            mini_step = int(tree["mini_step"])
            acc = self._per_param(tree["acc_grads"])
            gradient_step = int(tree["gradient_step"])
            tree = tree["inner_opt_state"]
        if self.grad_clip:
            _keys(tree, {"0", "1"}, "chain(clip_by_global_norm, ...)")
            _keys(tree["0"], set(), "clip_by_global_norm's state")
            tree = tree["1"]
        state: Dict[int, Dict] = {}
        if self._tx_layout() == "adamw":
            _keys(tree, {"0", "1", "2"}, "adamw's chain")
            _keys(tree["0"], {"count", "mu", "nu"}, "ScaleByAdamState")
            _keys(tree["1"], set(), "add_decayed_weights' state")
            _keys(tree["2"], {"count"}, "ScaleByScheduleState")
            count = int(tree["2"]["count"])
            if int(tree["0"]["count"]) != count:
                raise ValueError(f"Adam's count {int(tree['0']['count'])} is not the "
                                 f"schedule's {count}")
            for i, (p, mu, nu) in enumerate(zip(params, self._per_param(tree["0"]["mu"]),
                                                self._per_param(tree["0"]["nu"]))):
                state[i] = {"step": torch.tensor(float(count), dtype=_scalar_dtype()),
                            "exp_avg": mu, "exp_avg_sq": nu}
        else:
            _keys(tree, {"0", "1"}, "chain(add_decayed_weights, sgd)")
            _keys(tree["0"], set(), "add_decayed_weights' state")
            _keys(tree["1"], {"0", "1"}, "sgd's chain")
            _keys(tree["1"]["0"], {"trace"}, "TraceState")
            _keys(tree["1"]["1"], {"count"}, "ScaleByScheduleState")
            count = int(tree["1"]["1"]["count"])
            for i, t in enumerate(self._per_param(tree["1"]["0"]["trace"])):
                state[i] = {"momentum_buffer": t}
        if self.accumulate_steps > 1:
            if gradient_step != count:
                raise ValueError(f"MultiSteps' gradient_step {gradient_step} is not the "
                                 f"schedule's count {count}")
            self.mini_step, self.acc = mini_step, acc
        sd = self.inner.state_dict()
        sd["state"] = state
        self.inner.load_state_dict(sd)
        self.count = count

    @torch.no_grad()
    def export_optax_state(self) -> Dict:
        """This optimizer's state as the JAX optax state (numpy leaves, flax
        layouts): the inverse of ``load_optax_state``."""
        params = self._params()
        zeros = [torch.zeros_like(p) for p in params]

        def leaf(i: int, key: str) -> torch.Tensor:
            return self.inner.state.get(params[i], {}).get(key, zeros[i])

        count = np.asarray(self.count, np.int32)
        if self._tx_layout() == "adamw":
            tree = {"0": {"count": count,
                          "mu": self._flax_tree([leaf(i, "exp_avg") for i in range(len(params))]),
                          "nu": self._flax_tree([leaf(i, "exp_avg_sq")
                                                 for i in range(len(params))])},
                    "1": {}, "2": {"count": count}}
        else:
            trace = self._flax_tree([leaf(i, "momentum_buffer") for i in range(len(params))])
            tree = {"0": {}, "1": {"0": {"trace": trace}, "1": {"count": count}}}
        if self.grad_clip:
            tree = {"0": {}, "1": tree}
        if self.accumulate_steps > 1:
            tree = {"mini_step": np.asarray(self.mini_step, np.int32),
                    "gradient_step": count, "inner_opt_state": tree,
                    "acc_grads": self._flax_tree(self.acc if self.acc is not None else zeros),
                    "skip_state": {}}
        return tree


def _keys(tree, want: set, what: str) -> None:
    if not isinstance(tree, dict) or set(tree) != want:
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise KeyError(f"{what}: expected keys {sorted(want)}, got {got}")


def _scalar_dtype() -> torch.dtype:
    """The dtype torch's Adam keeps its step count in."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


@dataclass
class TrainState:
    """The step count, the module being trained, and its optimizer (which
    holds the optimizer state)."""

    step: int
    module: nn.Module
    optimizer: Optimizer


def create_train_state(model, optimizer: OptimizerConfig) -> TrainState:
    """A fresh state for ``model`` (a task wrapper with ``.net`` and ``.loss``)."""
    return TrainState(step=0, module=model.net, optimizer=optimizer.make(model.net))


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

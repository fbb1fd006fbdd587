"""Checkpoint save and restore of a train state.

A checkpoint is one ``torch.save`` file, ``checkpoints/state_XXXXXXXX.pt``
under the workspace, holding the step, the module's state dict and the
optimizer's (the port's own format). Saves are synchronous, written to a
temporary name and renamed, and the newest ``keep`` files are kept.

The JAX package's msgpack checkpoints (``checkpoints/state_XXXXXXXX.msgpack``,
what its ``CheckpointManager(use_orbax=False)`` writes: flax's state dict of
its ``TrainState``) are read two ways: ``restore_jax_variables`` takes the
weights only (``params`` and ``batch_stats``, through ``compat/weights.py``'s
name maps), ``restore_jax_state`` the whole train state, the optax state and
the step included, so a JAX run continues in the port. ``export_jax_state``
writes a port state in that layout (``compat/msgpack.py::msgpack_serialize``
turns it into the file). Its orbax checkpoints are not read.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from ..compat.msgpack import msgpack_restore
from ..compat.weights import export_flax_variables, load_flax_variables
from .train_step import TrainState

_NAME = re.compile(r"state_(\d{8})\.pt$")
_JAX_NAME = re.compile(r"state_(\d+)\.msgpack$")


class CheckpointManager:
    def __init__(self, workspace: str, keep: int = 5, save_every_steps: int = 1000):
        self.dir = os.path.join(workspace, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.save_every_steps = save_every_steps

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"state_{step:08d}.pt")

    def _steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.dir) if (m := _NAME.match(f)))

    def save(self, state: TrainState, step: Optional[int] = None, force: bool = False) -> bool:
        """Save at ``step`` (default: the state's) if it is a multiple of
        ``save_every_steps`` or ``force``; returns whether it saved."""
        step = state.step if step is None else step
        if not force and self.save_every_steps and step % self.save_every_steps != 0:
            return False
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": step, "module": state.module.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
        self._prune()
        return True

    def _prune(self):
        for step in self._steps()[: -self.keep]:
            os.remove(self._path(step))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint at ``step`` (default: the latest) into ``state``
        in place; returns it (unchanged when there is no checkpoint)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        saved = self._read(step, state.module)
        state.module.load_state_dict(saved["module"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state

    def restore_variables(self, module, step: Optional[int] = None):
        """Load only the module's weights (parameters and buffers) from the
        checkpoint at ``step`` (default: the latest) into ``module`` in place,
        never the optimizer's state, so that evaluation and serving do not
        depend on how the model was trained; returns the module (unchanged
        when there is no checkpoint)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return module
        module.load_state_dict(self._read(step, module)["module"])
        return module

    def _jax_tree(self, jax_workspace: Optional[str], step: Optional[int]) -> dict:
        """The JAX msgpack train state at ``step`` (default: the latest) under
        ``jax_workspace`` (default: this manager's workspace)."""
        ckdir = self.dir if jax_workspace is None else os.path.join(jax_workspace, "checkpoints")
        names = os.listdir(ckdir) if os.path.isdir(ckdir) else []
        steps = {int(m.group(1)): f for f in names if (m := _JAX_NAME.match(f))}
        if step is None and steps:
            step = max(steps)
        if step not in steps:
            if any(_is_orbax_step(ckdir, f) for f in names):
                raise NotImplementedError(
                    f"{ckdir}: an orbax checkpoint; only the JAX package's msgpack checkpoints "
                    "are read (orbax and tensorstore are not installed with the port)")
            raise FileNotFoundError(f"{ckdir}: no JAX msgpack checkpoint"
                                    + ("" if step is None else f" at step {step}"))
        with open(os.path.join(ckdir, steps[step]), "rb") as f:
            tree = msgpack_restore(f.read())
        if not isinstance(tree, dict) or "params" not in tree:
            raise ValueError(f"{steps[step]}: not a JAX train state")
        return tree

    def has_jax_state(self) -> bool:
        """Whether the workspace holds a JAX train state: a msgpack file, or
        an orbax step directory (which ``restore_jax_state`` refuses)."""
        return any(_JAX_NAME.match(f) or _is_orbax_step(self.dir, f)
                   for f in os.listdir(self.dir))

    def restore_jax_variables(self, module, jax_workspace: Optional[str] = None,
                              step: Optional[int] = None) -> int:
        """Load the weights of a JAX package checkpoint into ``module`` in
        place and return its step.

        Reads ``checkpoints/state_XXXXXXXX.msgpack`` at ``step`` (default:
        the latest) under ``jax_workspace`` (default: this manager's
        workspace), decoded by ``compat/msgpack.py``; its ``params`` and
        ``batch_stats`` load through ``compat/weights.py``, which raises on a
        missing or leftover name or a shape that differs. The optax state is
        not read. An orbax checkpoint raises ``NotImplementedError``; no
        checkpoint at all ``FileNotFoundError``."""
        tree = self._jax_tree(jax_workspace, step)
        _load_jax_weights(module, tree)
        return int(tree["step"])

    def restore_jax_state(self, state: TrainState, jax_workspace: Optional[str] = None,
                          step: Optional[int] = None) -> TrainState:
        """Load a whole JAX train state into ``state`` in place and return it:
        ``params`` and ``batch_stats`` into the module (as
        ``restore_jax_variables``), ``opt_state`` into the optimizer
        (``Optimizer.load_optax_state``: the optimizer must be built as the
        JAX run's ``OptimizerConfig`` was) and ``step``. The same file
        lookup and refusals as ``restore_jax_variables``."""
        tree = self._jax_tree(jax_workspace, step)
        if "opt_state" not in tree:
            raise ValueError("the JAX checkpoint holds no opt_state")
        _load_jax_weights(state.module, tree)
        state.optimizer.load_optax_state(tree["opt_state"])
        state.step = int(tree["step"])
        return state

    def _read(self, step: int, module) -> dict:
        """The checkpoint at ``step``, its tensors on ``module``'s device."""
        device = next(module.parameters()).device
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def wait(self):
        """Saves are synchronous: nothing to wait for."""


def _is_orbax_step(ckdir: str, name: str) -> bool:
    """Whether ``name`` is one of the step directories orbax writes."""
    return name.isdigit() and os.path.isdir(os.path.join(ckdir, name))


def _load_jax_weights(module, tree: dict) -> None:
    variables = {"params": tree["params"]}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    load_flax_variables(module, variables)


def export_jax_state(state: TrainState) -> dict:
    """A port train state in the JAX package's layout: the state dict flax
    makes of its ``TrainState`` (``step``, ``params``, ``batch_stats``,
    ``opt_state``; numpy leaves), which ``msgpack_serialize`` turns into a
    file that ``restore_jax_state`` reads."""
    variables = export_flax_variables(state.module)
    return {"step": np.asarray(state.step, np.int32), "params": variables.get("params", {}),
            "batch_stats": variables.get("batch_stats", {}),
            "opt_state": state.optimizer.export_optax_state()}

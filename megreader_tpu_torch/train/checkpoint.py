"""Checkpoint save and restore of a train state.

A checkpoint is one ``torch.save`` file, ``checkpoints/state_XXXXXXXX.pt``
under the workspace, holding the step, the module's state dict and the
optimizer's (the port's own format). Saves are synchronous, written to a
temporary name and renamed, and the newest ``keep`` files are kept.

``restore_jax_variables`` reads the weights of the JAX package's msgpack
checkpoints (``checkpoints/state_XXXXXXXX.msgpack``, what its
``CheckpointManager(use_orbax=False)`` writes): ``params`` and
``batch_stats`` through ``compat/weights.py``'s name maps, never the optax
state. Its orbax checkpoints are not read.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..compat.msgpack import msgpack_restore
from ..compat.weights import load_flax_variables
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
        ckdir = self.dir if jax_workspace is None else os.path.join(jax_workspace, "checkpoints")
        names = os.listdir(ckdir) if os.path.isdir(ckdir) else []
        steps = {int(m.group(1)): f for f in names if (m := _JAX_NAME.match(f))}
        if step is None and steps:
            step = max(steps)
        if step not in steps:
            if any(f.isdigit() and os.path.isdir(os.path.join(ckdir, f)) for f in names):
                raise NotImplementedError(
                    f"{ckdir}: an orbax checkpoint; only the JAX package's msgpack checkpoints "
                    "are read (orbax and tensorstore are not installed with the port)")
            raise FileNotFoundError(f"{ckdir}: no JAX msgpack checkpoint"
                                    + ("" if step is None else f" at step {step}"))
        with open(os.path.join(ckdir, steps[step]), "rb") as f:
            tree = msgpack_restore(f.read())
        if not isinstance(tree, dict) or "params" not in tree:
            raise ValueError(f"{steps[step]}: not a JAX train state")
        variables = {"params": tree["params"]}
        if tree.get("batch_stats"):
            variables["batch_stats"] = tree["batch_stats"]
        load_flax_variables(module, variables)
        return int(tree["step"])

    def _read(self, step: int, module) -> dict:
        """The checkpoint at ``step``, its tensors on ``module``'s device."""
        device = next(module.parameters()).device
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

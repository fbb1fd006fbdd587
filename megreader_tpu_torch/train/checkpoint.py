"""Checkpoint save and restore of a train state.

A checkpoint is one ``torch.save`` file, ``checkpoints/state_XXXXXXXX.pt``
under the workspace, holding the step, the module's state dict and the
optimizer's (the port's own format: JAX msgpack checkpoints are not read,
ROADMAP Queue 1 item 7). Saves are synchronous, written to a temporary name
and renamed, and the newest ``keep`` files are kept.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .train_step import TrainState

_NAME = re.compile(r"state_(\d{8})\.pt$")


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

    def _read(self, step: int, module) -> dict:
        """The checkpoint at ``step``, its tensors on ``module``'s device."""
        device = next(module.parameters()).device
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

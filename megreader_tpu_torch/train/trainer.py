"""Trainer: the epoch loop on one device, or one device a rank.

restore -> for epoch: for batch: train step (prepare on the card, forward,
backward, update) -> log every ``log_every`` steps -> validate hook ->
checkpoint through the manager (which saves every ``save_every_steps``) -> a
final forced save. ``epochs`` is a total budget: a resumed run trains on
toward ``epochs * len(loader)`` steps and does nothing once there.

``train(resume=True)`` restores the latest port checkpoint of the workspace
or, when there is none and the workspace holds a JAX msgpack train state
(``checkpoints/state_XXXXXXXX.msgpack``), that state whole: weights, optax
state and step (``CheckpointManager.restore_jax_state``), so
``python -m megreader_tpu_torch.cli.train <yaml>`` continues a run the JAX
package began in the same workspace. What a resumed run draws: neither
package saves the loader's place, so a resumed run, in either package,
starts its loader at the top of an epoch. The port's first epoch shuffles
with seed + 1, its next with seed + 2, ... (the port builds the module
with its weights and draws no batch to initialize it); a resumed JAX run
draws one batch for flax's ``init`` first, so its first epoch shuffles with
seed + 2. A JAX run resumed in the port thus draws the batches a fresh port
run draws from its first step, and its device augmentation, keyed on
(seed, step), continues from the restored step as JAX's would.

``use_mesh=True`` trains data-parallel over the process group that is up
(``parallel/mesh.py``; a world of one without a group): rank 0's weights
replicated after the restore, BatchNorm on the global batch's statistics,
the global batch's gradient (``make_train_step(mesh=...)``), and the
checkpoints and logs written by rank 0 alone. The loader gives each rank its
share (``host_shard``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..parallel.mesh import barrier, is_primary, make_mesh, replicated, sync_batch_norm
from ..utils.signal_monitor import SignalMonitor
from .checkpoint import CheckpointManager
from .logger import Logger
from .train_step import OptimizerConfig, TrainState, create_train_state, make_train_step


class Trainer:
    def __init__(
        self,
        model,
        loader,
        optimizer: Optional[OptimizerConfig] = None,
        workspace: str = "/tmp/megreader_tpu_exp",
        epochs: int = 10,
        log_every: int = 50,
        validate_every_steps: int = 0,
        validate_fn: Optional[Callable] = None,
        checkpoint: Optional[CheckpointManager] = None,
        signal_monitor: Optional[SignalMonitor] = None,
        use_mesh: bool = False,
        prepare_batch: Optional[Callable[[Dict], Dict]] = None,
        debug_nans: bool = False,
    ):
        self.model = model
        self.mesh = make_mesh(next(model.net.parameters()).device) if use_mesh else None
        self.loader = loader
        self.optimizer = optimizer or OptimizerConfig()
        self.epochs = epochs
        self.log_every = log_every
        self.validate_every_steps = validate_every_steps
        self.validate_fn = validate_fn
        self.workspace = workspace
        self.logger = Logger(workspace)
        self.checkpoint = checkpoint or CheckpointManager(workspace)
        self.signal_monitor = signal_monitor or SignalMonitor()
        self.prepare_batch = prepare_batch
        #: anomaly detection in autograd: raises where a backward makes a NaN.
        #: Costly; for debugging runs only.
        self.debug_nans = debug_nans

    def train(self, resume: bool = True) -> TrainState:
        sched = self.optimizer.make_schedule()
        state = create_train_state(self.model, self.optimizer)
        if resume:
            if self.checkpoint.latest_step() is None and self.checkpoint.has_jax_state():
                state = self.checkpoint.restore_jax_state(state)
                self.logger.info(f"resumed the JAX train state at step {state.step}")
            else:
                state = self.checkpoint.restore(state)
                if state.step > 0:
                    self.logger.info(f"resumed at step {state.step}")
        if self.mesh is not None:
            replicated(state.module, self.mesh)
            sync_batch_norm(state.module, self.mesh)
        # the module is built with its weights, so no batch is drawn to
        # initialize it: the first epoch shuffles with seed + 1 (the JAX
        # trainer's init probe takes one loader pass, so its first epoch
        # shuffles with seed + 2)
        step_fn = make_train_step(self.model, prepare=self.prepare_batch, mesh=self.mesh)
        step = state.step
        target_steps = self.epochs * len(self.loader)
        if step >= target_steps:
            self.logger.info(f"already at step {step} >= target {target_steps}: no training")
            return state

        with torch.autograd.set_detect_anomaly(self.debug_nans):
            step = self._loop(state, step_fn, sched, target_steps)
        self._save(state, step, force=True)
        self.checkpoint.wait()
        barrier()
        self.logger.info(f"training done at step {step}")
        return state

    def _loop(self, state: TrainState, step_fn, sched, target_steps: int) -> int:
        step = state.step
        t_log = time.time()
        n_since = 0
        for epoch in range(self.epochs):
            if step >= target_steps:
                break
            for batch in self.loader:
                state, metrics = step_fn(state, batch)
                step += 1
                n_since += len(batch["image"])
                stop = step >= target_steps

                if step % self.log_every == 0:
                    self.logger.add_scalars(step, {k: float(v) for k, v in metrics.items()})
                    dt = time.time() - t_log
                    self.logger.report(epoch, step, sched(step), n_since / max(dt, 1e-6))
                    t_log, n_since = time.time(), 0
                    if self.signal_monitor.should_stop():
                        self.logger.info("signal file detected: saving and stopping")
                        stop = True

                if (self.validate_every_steps and self.validate_fn
                        and step % self.validate_every_steps == 0):
                    self.logger.metrics(step, self.validate_fn(self.model, state))

                self._save(state, step)
                if stop:
                    return step
        return step

    def _save(self, state: TrainState, step: int, force: bool = False) -> None:
        if self.mesh is None or is_primary(self.mesh):
            self.checkpoint.save(state, step, force=force)

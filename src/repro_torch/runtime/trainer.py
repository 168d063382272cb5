"""Fault-tolerant training loop.

The port of ``repro.runtime.trainer``.  Responsibilities: the step loop,
periodic async checkpoints, restart-on-failure (restore latest checkpoint,
rebuild the deterministic data stream at that step), straggler detection,
and metric history.  ``run_with_restarts`` is the cluster-controller
behavior: it survives injected failures and produces the loss trajectory of
an uninterrupted run.  A step ends when its loss is read to the host
(``float``), which waits for the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.tree import tree_leaves
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       StragglerDetector)


@dataclass
class Trainer:
    train_step: Callable                     # (state, batch) -> (state, metrics)
    batch_fn: Callable[[int], dict]          # step -> batch (deterministic)
    ckpt: CheckpointManager
    ckpt_every: int = 20
    injector: Optional[FailureInjector] = None
    straggler: StragglerDetector = field(default_factory=StragglerDetector)
    history: List[Dict] = field(default_factory=list)

    def _run(self, state, start_step: int, num_steps: int):
        step_fn = self.train_step
        for step in range(start_step, num_steps):
            if self.injector is not None:
                self.injector.check(step)
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            state, metrics = step_fn(state, batch)
            values = {k: float(v) for k, v in metrics.items()}   # waits
            dt = time.perf_counter() - t0
            self.straggler.observe(step, dt)
            self.history.append({"step": step, "seconds": dt, **values})
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        self.ckpt.save(num_steps, state, blocking=True)
        return state

    def run(self, state, num_steps: int, start_step: int = 0):
        return self._run(state, start_step, num_steps)

    def run_with_restarts(self, init_state, num_steps: int,
                          max_restarts: int = 10, shardings=None):
        """Cluster-controller loop: on failure, restore the latest
        checkpoint onto the device of ``init_state`` (or onto a mesh by
        ``shardings``, a tree of ``NamedSharding``s of the state, as the
        reference takes them) and continue."""
        state = init_state
        device = tree_leaves(init_state)[0].device
        start = 0
        restarts = 0
        while True:
            try:
                return self._run(state, start, num_steps), restarts
            except SimulatedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:       # failed before first checkpoint
                    state, start = init_state, 0
                else:
                    state, start = self.ckpt.restore(state, step=latest,
                                                     device=device,
                                                     shardings=shardings)
                # drop history after the restore point (it will be replayed)
                self.history = [h for h in self.history if h["step"] < start]

    def losses(self) -> np.ndarray:
        return np.asarray([h["loss"] for h in self.history], np.float32)

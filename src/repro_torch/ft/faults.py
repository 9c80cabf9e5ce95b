"""Fault tolerance for the training loop: failure injection, checkpoint
restart, elastic rescale, and straggler accounting — the port of
``repro/ft/faults.py``.

* ``FailureInjector`` — deterministic pseudo-random step failures
  (preemption / device loss) for tests and drills: the same Python
  ``random`` sequence as the reference's for the same seed.
* ``run_with_restarts`` — the supervisor loop: run steps, on failure restore
  the latest checkpoint and continue; bounded restart budget; counts lost
  steps (the recovery-cost metric).
* ``reshard_state`` — elastic rescale: every leaf onto its new placement's
  device (on one card, a device move).
* ``StragglerMonitor`` — flags steps ≥ k·median (tail-at-scale detection).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import tree_leaves_with_path, tree_unflatten


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    rate: float = 0.0               # per-step failure probability
    seed: int = 0
    fail_at: tuple[int, ...] = ()   # deterministic failure steps

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._pending = set(self.fail_at)     # deterministic faults fire once

    def check(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise InjectedFailure(f"injected failure at step {step}")
        if self.rate and self._rng.random() < self.rate:
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    steps_lost: int = 0
    steps_run: int = 0


def run_with_restarts(step_fn: Callable[[Any, int], Any], init_state: Any,
                      n_steps: int, ckpt, *,
                      injector: FailureInjector | None = None,
                      max_restarts: int = 10) -> tuple[Any, RestartStats]:
    """Supervisor: run ``state = step_fn(state, step)`` for n_steps with
    checkpoint/restart recovery. `ckpt` is a CheckpointManager. A restore
    lands on the devices of the live state's leaves."""
    stats = RestartStats()
    state = init_state
    step = 0
    while step < n_steps:
        try:
            if injector is not None:
                injector.check(step)
            state = step_fn(state, step)
            stats.steps_run += 1
            ckpt.maybe_save(step, state)
            step += 1
        except InjectedFailure:
            stats.restarts += 1
            if stats.restarts > max_restarts:
                raise
            try:
                state, restored_step = ckpt.restore(state)
            except Exception:
                state, restored_step = init_state, -1
            stats.steps_lost += step - (restored_step + 1)
            step = restored_step + 1
    ckpt.wait()
    return state, stats


def reshard_state(state: Any, shardings: Any) -> Any:
    """Elastic rescale: every leaf onto its placement's device (a tree of
    :class:`~repro_torch.parallel.sharding.NamedSharding` or devices)."""
    leaves = [x for _, x in tree_leaves_with_path(state)]
    places = [s for _, s in tree_leaves_with_path(shardings)]
    return tree_unflatten(state, [
        x.to(torch.device(getattr(s, "device", s))) for x, s in zip(leaves, places)])


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 50
    warmup: int = 5      # min samples before flagging (floored at 2: the
                         # first step's median is ITSELF, so any factor < 1
                         # would flag a run's very first step)

    def __post_init__(self):
        self._times: list[float] = []
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = float(np.median(self._times))
        # warmup is clamped into [2, window]: a window smaller than the
        # warmup must still be able to flag once it is full
        need = max(2, min(self.warmup, self.window))
        slow = len(self._times) >= need and seconds > self.factor * med
        if slow:
            self.flagged.append(step)
        return slow

"""Fault-tolerant training supervisor, the counterpart of
`repro/runtime/supervisor.py`.

Wraps a step function in a restart loop: on a worker crash (any exception,
including the injected ones used in tests) it restores the latest committed
checkpoint and resumes the data stream at the right step.  Bounded retries
with exponential backoff; heartbeat file for external watchdogs (a cluster
manager polls mtime).  A restore lands on the devices of the state that
`init_state()` builds (Checkpointer.restore follows its `like` tree).
This is the single-process skeleton of the N-host supervisor.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..checkpoint import Checkpointer


class TrainerCrash(RuntimeError):
    """Simulated/propagated worker failure."""


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps once."""
    fail_at: set = field(default_factory=set)
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise TrainerCrash(f"injected failure at step {step}")


@dataclass
class Supervisor:
    checkpointer: Checkpointer
    max_restarts: int = 3
    backoff_s: float = 0.01
    heartbeat_path: str | None = None
    checkpoint_every: int = 10

    def heartbeat(self, step: int):
        if self.heartbeat_path:
            with open(self.heartbeat_path, "w") as f:
                f.write(str(step))

    def run(self, *, init_state: Callable[[], Any],
            step_fn: Callable[[Any, int], Any], n_steps: int,
            injector: FailureInjector | None = None,
            on_restart: Callable[[int], None] | None = None) -> tuple[Any, dict]:
        """Run n_steps with checkpoint/restart.  Returns (state, report)."""
        report = {"restarts": 0, "completed_steps": 0, "restored_from": []}
        restarts = 0
        while True:
            try:
                latest = self.checkpointer.latest_step()
                if latest is not None:
                    state = self.checkpointer.restore(latest, init_state())
                    start = latest + 1
                    if restarts:
                        report["restored_from"].append(latest)
                        if on_restart:
                            on_restart(latest)
                else:
                    state = init_state()
                    start = 0
                for step in range(start, n_steps):
                    if injector is not None:
                        injector.check(step)
                    state = step_fn(state, step)
                    report["completed_steps"] = step + 1
                    self.heartbeat(step)
                    if (step + 1) % self.checkpoint_every == 0 or step == n_steps - 1:
                        self.checkpointer.save(step, state)
                self.checkpointer.wait()
                return state, report
            except TrainerCrash:
                restarts += 1
                report["restarts"] = restarts
                if restarts > self.max_restarts:
                    raise
                time.sleep(self.backoff_s * (2 ** (restarts - 1)))

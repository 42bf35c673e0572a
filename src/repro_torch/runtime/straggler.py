"""Straggler detection & mitigation, the counterpart of
`repro/runtime/straggler.py`.

SPMD lockstep means one slow host slows every step -- the detectable
signature is a rising step-time z-score.  Mitigations, in escalation order:
 1. deepen input prefetch (absorb jitter from the data pipeline),
 2. flag for re-mesh: report the suspect window so the supervisor can
    exclude the slow host and trigger the elastic restore path
    (`checkpoint.restore_with_resharding` onto the reduced mesh).
"""
from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    window: int = 32
    z_threshold: float = 3.0
    sustained: int = 4
    _times: collections.deque = field(default_factory=lambda: collections.deque(maxlen=256))
    _alerts: int = 0
    prefetch_depth: int = 2

    def record(self, step_time_s: float) -> dict | None:
        """Feed one step wall-time; returns an action dict when triggered."""
        self._times.append(step_time_s)
        if len(self._times) < self.window:
            return None
        hist = list(self._times)[:-1]
        mu = statistics.fmean(hist)
        sd = statistics.pstdev(hist) or 1e-9
        z = (step_time_s - mu) / sd
        if z > self.z_threshold:
            self._alerts += 1
        else:
            self._alerts = max(0, self._alerts - 1)
        if self._alerts == 1:
            self.prefetch_depth = min(self.prefetch_depth * 2, 16)
            return {"action": "increase_prefetch",
                    "prefetch_depth": self.prefetch_depth, "z": z}
        if self._alerts >= self.sustained:
            self._alerts = 0
            return {"action": "flag_remesh", "z": z,
                    "mean_s": mu, "last_s": step_time_s}
        return None

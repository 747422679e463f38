"""Straggler mitigation: detect slow hosts from step-time telemetry and pick
a response, with the expected makespan impact quantified by the simulator.

Policy knobs follow the standard large-fleet playbook:
  * ``slow_factor`` when a host's smoothed step time exceeds k x fleet median
    -> flag as straggler;
  * persistent stragglers -> recommend eviction (trigger the elastic path);
  * transient stragglers -> recommend backup execution of the affected stage
    (the Autotuner's ``straggler_factor`` quantifies the win of each option).

A copy of the JAX package's ``ft/straggler.py``; ``predicted_impact``
takes the port's ``core.autotuner.Autotuner``.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StepTimeMonitor:
    window: int = 32
    _times: dict[int, deque] = field(default_factory=lambda: defaultdict(deque))

    def record(self, host_id: int, step_time_s: float) -> None:
        q = self._times[host_id]
        q.append(step_time_s)
        if len(q) > self.window:
            q.popleft()

    def smoothed(self, host_id: int) -> Optional[float]:
        q = self._times.get(host_id)
        if not q:
            return None
        return float(np.median(np.asarray(q)))

    def fleet_median(self) -> Optional[float]:
        vals = [self.smoothed(h) for h in self._times]
        vals = [v for v in vals if v is not None]
        return float(np.median(np.asarray(vals))) if vals else None


@dataclass
class StragglerPolicy:
    slow_factor: float = 1.5
    evict_after: int = 3          # consecutive flags before eviction advice
    _strikes: dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def assess(self, monitor: StepTimeMonitor) -> dict[int, str]:
        """host -> "ok" | "backup" | "evict"."""
        fleet = monitor.fleet_median()
        out: dict[int, str] = {}
        if fleet is None:
            return out
        for h in monitor._times:
            mine = monitor.smoothed(h)
            if mine is None:
                continue
            if mine > self.slow_factor * fleet:
                self._strikes[h] += 1
                out[h] = (
                    "evict" if self._strikes[h] >= self.evict_after else "backup"
                )
            else:
                self._strikes[h] = 0
                out[h] = "ok"
        return out

    def predicted_impact(self, tuner, stage: int, factor: float) -> float:
        """Simulated slowdown of keeping the straggler (Autotuner-backed)."""
        base = tuner.evaluate(tuner.candidates()[0]).makespan_s
        tuner.straggler_stage = stage
        tuner.straggler_factor = factor
        slow = tuner.evaluate(tuner.candidates()[0]).makespan_s
        tuner.straggler_stage = None
        tuner.straggler_factor = 1.0
        return slow / base if base > 0 else 1.0

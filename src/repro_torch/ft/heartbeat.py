"""Failure detection: per-host heartbeat records.

On a real cluster each host periodically writes ``<dir>/host_<i>.hb`` (a
monotonic counter + wall time); the coordinator calls ``dead_hosts`` and
triggers the elastic re-mesh path when a host misses ``timeout_s``.  The
container has one host, so the logic is exercised in tests with synthetic
clocks — the interface is what matters for the 1000-node story.

A copy of the JAX package's ``ft/heartbeat.py``.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class HeartbeatMonitor:
    directory: str
    num_hosts: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.time

    def beat(self, host_id: int, step: int) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"host_{host_id}.hb")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": host_id, "step": step, "t": self.clock()}, f)
        os.replace(tmp, path)

    def last_seen(self, host_id: int) -> Optional[dict]:
        path = os.path.join(self.directory, f"host_{host_id}.hb")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        dead = []
        for h in range(self.num_hosts):
            seen = self.last_seen(h)
            if seen is None or now - seen["t"] > self.timeout_s:
                dead.append(h)
        return dead

    def quorum(self) -> bool:
        return len(self.dead_hosts()) == 0

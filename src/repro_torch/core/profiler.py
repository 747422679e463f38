"""Wall-clock timing of callables, the profiler's measuring primitive.

``OfflineProfiler`` and ``calibrate_host`` are not ported yet (ROADMAP A5).
On a CUDA device the timer synchronises the card before every clock read, so
a sample covers the device work that the callable queued.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import synchronize


def time_callable_samples(
    fn: Callable[[], object], repeats: int = 10, warmup: int = 3,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Raw per-call wall-clock samples of fn().

    At least one warmup call always runs, even when ``warmup=0`` is
    requested, so first-call costs (kernel builds, library heuristics) never
    land in a sample.  ``device``: the card to synchronise around each
    sample (None or CPU: fn must block until its result is ready).
    """
    for _ in range(max(warmup, 1)):
        fn()
    ts = []
    for _ in range(repeats):
        if device is not None:
            synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device is not None:
            synchronize(device)
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def time_callable(
    fn: Callable[[], object], repeats: int = 10, warmup: int = 3,
    device: Optional[torch.device] = None,
) -> tuple[float, float]:
    """(mean_s, std_s) of fn(); see :func:`time_callable_samples`."""
    a = time_callable_samples(fn, repeats=repeats, warmup=warmup,
                              device=device)
    return float(a.mean()), float(a.std())

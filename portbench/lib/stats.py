"""Order statistics of the benchmark.

:func:`percentile` is a frozen copy of ``repro_torch.serve.report.percentile``
(commit 62fbfb96d07a): nearest rank, no interpolation.
"""
from __future__ import annotations


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — deterministic."""
    if not values:
        return 0.0
    vs = sorted(values)
    rank = max(1, -(-int(len(vs) * q) // 100))  # ceil(n*q/100), >= 1
    return float(vs[min(rank, len(vs)) - 1])

"""Open-loop request-arrival traces (Poisson and bursty) + persistence.

A trace is the workload contract between the serving engine and its DES
twin: both replay the SAME list of :class:`TraceRequest` (arrival offset,
prompt length, output budget) through the shared scheduler.  Prompt token
*values* are derived deterministically from ``(trace seed, rid)`` so a
saved trace file fully reproduces an engine run without storing tokens.

All generators use ``numpy.default_rng`` with explicit seeds and all
floats survive a JSON round-trip exactly (Python serializes the shortest
repr that reparses to the same float64), so a committed trace file — e.g.
``benchmarks/traces/serve_acceptance.json`` — is bit-stable.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

import numpy as np


@dataclass(frozen=True)
class TraceRequest:
    rid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    seed: int = 0               # prompt-content seed (shared per trace)


def prompt_tokens(req: TraceRequest, vocab_size: int) -> np.ndarray:
    """Deterministic prompt for a trace request (ids in [1, vocab))."""
    rng = np.random.default_rng((req.seed, req.rid))
    return rng.integers(
        1, vocab_size, req.prompt_len, dtype=np.int32
    )


def _lens(rng, n, prompt_lens, max_new_tokens):
    pl = rng.choice(np.asarray(prompt_lens, np.int64), size=n)
    mt = rng.choice(np.asarray(max_new_tokens, np.int64), size=n)
    return pl, mt


def poisson_trace(
    n: int,
    rate_rps: float,
    *,
    prompt_lens: tuple[int, ...] = (8, 12, 16, 24),
    max_new_tokens: tuple[int, ...] = (4, 8, 12),
    seed: int = 0,
) -> list[TraceRequest]:
    """Open-loop Poisson arrivals: exponential inter-arrival gaps."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    arrivals = np.cumsum(gaps)
    pl, mt = _lens(rng, n, prompt_lens, max_new_tokens)
    return [
        TraceRequest(
            rid=i, arrival_s=float(arrivals[i]),
            prompt_len=int(pl[i]), max_new_tokens=int(mt[i]), seed=seed,
        )
        for i in range(n)
    ]


def bursty_trace(
    n_bursts: int,
    burst_size: int,
    gap_s: float,
    *,
    prompt_lens: tuple[int, ...] = (8, 12, 16, 24),
    max_new_tokens: tuple[int, ...] = (4, 8, 12),
    seed: int = 0,
) -> list[TraceRequest]:
    """Bursty open-loop load: ``burst_size`` simultaneous arrivals every
    ``gap_s`` seconds (the pathological case for continuous batching —
    queueing delay dominates TTFT inside a burst)."""
    rng = np.random.default_rng(seed)
    n = n_bursts * burst_size
    pl, mt = _lens(rng, n, prompt_lens, max_new_tokens)
    out = []
    for i in range(n):
        out.append(
            TraceRequest(
                rid=i, arrival_s=float((i // burst_size) * gap_s),
                prompt_len=int(pl[i]), max_new_tokens=int(mt[i]), seed=seed,
            )
        )
    return out


# -- persistence ----------------------------------------------------------------


def save_trace(path: str, trace: list[TraceRequest]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {"version": 1, "requests": [asdict(r) for r in trace]},
            f, indent=2, sort_keys=True,
        )
        f.write("\n")


def load_trace(path: str) -> list[TraceRequest]:
    with open(path) as f:
        raw = json.load(f)
    return [
        TraceRequest(
            rid=int(r["rid"]), arrival_s=float(r["arrival_s"]),
            prompt_len=int(r["prompt_len"]),
            max_new_tokens=int(r["max_new_tokens"]),
            seed=int(r.get("seed", 0)),
        )
        for r in raw["requests"]
    ]

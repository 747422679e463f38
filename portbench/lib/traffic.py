"""Open-loop traffic for the serve cells, from a cell's parameter file.

:class:`TraceRequest`, :func:`prompt_tokens`, :func:`poisson_trace` and
:func:`bursty_trace` are frozen copies of ``repro_torch.serve.trace``
(commit 62fbfb96d07a), so a later change to the program's generators does
not move the yardstick.  :func:`make_requests` is the one general
generator the cells' files drive.

Every seed serves the same work.  The prompt lengths, output budgets and
inter-arrival gaps are drawn from the traffic file's own ``sizes_seed``; the
run's ``--seed`` shuffles their order within consecutive blocks of
``order_block`` requests and draws the prompts' token values.  Runs of
different seeds then serve the same requests in another order, with the
load over each block's stretch of the window the same.
"""
from __future__ import annotations

from dataclasses import dataclass

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


# -- the general generator --------------------------------------------------------


def draw_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` integer lengths from a length spec:
    ``{"dist": "loguniform" | "uniform", "low": a, "high": b}`` (both ends
    included) or ``{"dist": "choice", "values": [...]}``."""
    dist = spec["dist"]
    if dist == "choice":
        return rng.choice(np.asarray(spec["values"], np.int64), size=n)
    lo, hi = int(spec["low"]), int(spec["high"])
    if not 1 <= lo <= hi:
        raise ValueError(f"length spec {spec}: need 1 <= low <= high")
    if dist == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if dist == "loguniform":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    raise ValueError(f"length spec {spec}: unknown dist {dist!r}")


def arrival_gaps(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` gaps before each arrival (the first is 0): ``{"process":
    "poisson", "rate": r}`` or ``{"process": "bursty", "rate": r,
    "burst": k}`` (``k`` requests at once, bursts ``k / r`` apart)."""
    proc, rate = spec["process"], float(spec["rate"])
    if rate <= 0:
        raise ValueError(f"arrival spec {spec}: rate must be positive")
    if proc == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n)
    elif proc == "bursty":
        k = int(spec["burst"])
        gaps = np.where(np.arange(n) % k == 0, k / rate, 0.0)
    else:
        raise ValueError(f"arrival spec {spec}: unknown process {proc!r}")
    gaps[0] = 0.0
    return gaps


def _block_permutation(rng: np.random.Generator, n: int,
                       block: int) -> np.ndarray:
    """A permutation of range(n) that shuffles within consecutive blocks."""
    out = np.arange(n)
    for lo in range(0, n, block):
        out[lo:lo + block] = lo + rng.permutation(min(block, n - lo))
    return out


def make_requests(traffic: dict, seed: int, seconds: float,
                  rate: float | None = None) -> list[TraceRequest]:
    """The requests due in a window of ``seconds``, in order of arrival.

    ``traffic``: a cell's file (``arrivals``, ``prompt_len``,
    ``output_len``, ``sizes_seed``, ``order_block``).  ``rate`` overrides
    the file's (the knee sweep).  The count is the rate times the window;
    the gaps are rescaled so that the last request is due inside it.  Sizes
    and gaps come from ``sizes_seed``; ``seed`` permutes them within blocks
    and seeds the prompts."""
    arrivals = dict(traffic["arrivals"])
    if rate is not None:
        arrivals["rate"] = rate
    n = max(1, int(round(float(arrivals["rate"]) * seconds)))
    base = np.random.default_rng(int(traffic["sizes_seed"]))
    prompts = draw_lengths(traffic["prompt_len"], n, base)
    outputs = draw_lengths(traffic["output_len"], n, base)
    gaps = arrival_gaps(arrivals, n, base)
    order = np.random.default_rng(seed)
    block = int(traffic.get("order_block", n))
    perm = _block_permutation(order, n, block)
    if arrivals["process"] == "poisson":
        gaps = np.concatenate([[0.0], gaps[1:][_block_permutation(
            order, n - 1, block)]])
    total = float(gaps.sum())
    if total >= seconds:          # keep the last arrival inside the window
        gaps = gaps * (seconds * (1.0 - 1.0 / (2 * n)) / total)
    due = np.cumsum(gaps)
    return [TraceRequest(rid=i, arrival_s=float(due[i]),
                         prompt_len=int(prompts[perm[i]]),
                         max_new_tokens=int(outputs[perm[i]]), seed=seed)
            for i in range(n)]

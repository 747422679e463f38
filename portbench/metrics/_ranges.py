"""What the readers of the program's own ranges share.

The port names its serving work with ``torch.profiler`` ranges
(``repro_torch.obs.prange``).  The engine's host loop (``serve.step``,
``serve.plan``, ``serve.inputs``, ``serve.prefill``, ``serve.decode``,
``serve.readback``, ``serve.commit``) is host events alone.  The paged
forward's ``paged.kv_gather`` and ``paged.head`` and the MoE FFN's
``moe.ffn`` are each a host event and a device-side range over the
operations launched inside it (the profiler gives an operation to the
innermost such range).  So a part's device time is read from its device
ranges, and which call it belongs to from the host: the k-th device range
of a name is the k-th host event of that name, and the host event lies
inside the call's host ``serve.decode`` or ``serve.prefill``.  Names are
matched exactly.  A program without the ranges gives no spans, and every
reader then returns None.
"""
from __future__ import annotations

import bisect
import itertools
import statistics

from portbench.lib import devtrace


def device_spans(t, name: str) -> list[tuple[float, float]]:
    """The device-side ranges named ``name``, in order."""
    return sorted((s, e) for n, s, e in t.ranges if n == name)


def host_spans(t, name: str) -> list[tuple[float, float]]:
    """The host events named ``name``, in order."""
    return sorted((h[1], h[2]) for h in t.host if h[0] == name)


def _within(spans, a: float, b: float) -> bool:
    """Whether one of the sorted, disjoint ``spans`` holds [a, b]."""
    i = bisect.bisect_right(spans, (a, float("inf"))) - 1
    return i >= 0 and b <= spans[i][1]


def paired(t, name: str):
    """[(host span, device span)] of the ranges named ``name``, in order;
    device ranges that start before the first host event (launched before
    the profiler started) are left out, host events past the last device
    range (cut off at its stop) too.  None where there are none, or a
    device range starts before its host event."""
    host = host_spans(t, name)
    if not host:
        return None
    dev = [d for d in device_spans(t, name) if d[0] >= host[0][0]]
    pairs = list(zip(host, dev))
    if not pairs or any(d[0] < h[0] for h, d in pairs):
        return None
    return pairs


def ms_per_call(run, part: str, call: str):
    """Device milliseconds of the operations inside the ``part`` ranges
    whose host events lie within a host ``call`` range (``serve.decode``
    or ``serve.prefill``), over the number of ``call`` ranges; None where
    either is missing."""
    t = run.trace
    if run.kind != "serve" or t is None or not t.ops:
        return None
    calls, pairs = host_spans(t, call), paired(t, part)
    if not calls or pairs is None:
        return None
    mine = [d for h, d in pairs if _within(calls, *h)]
    us = sum(e - s for _, s, e in t.ops if _within(mine, s, e))
    return 1e-3 * us / len(calls)


def decode_step_idle(run):
    """The device-idle milliseconds of each profiled decode-only step (a
    host ``serve.step`` holding one ``serve.decode`` and no
    ``serve.prefill``): (outside its ``serve.decode``, inside it).  Idle
    is a gap in the union of the device operations.  None where the trace
    has no such step or no device operation."""
    t = run.trace
    if run.kind != "serve" or t is None or not t.ops:
        return None
    decode = host_spans(t, "serve.decode")
    prefill = host_spans(t, "serve.prefill")
    busy = sorted((s, e) for _, s, e in t.ops)
    reach = list(itertools.accumulate((e for _, e in busy), max))
    starts = [s for s, _ in busy]

    def idle(a: float, b: float) -> float:
        i = bisect.bisect_left(reach, a)     # the first op reaching past a
        j = bisect.bisect_left(starts, b)    # the ops starting before b
        return 1e-3 * sum(e - s for s, e in devtrace.gaps_us(busy[i:j], a, b))

    out = []
    for s, e in host_spans(t, "serve.step"):
        dec = [d for d in decode if s <= d[0] and d[1] <= e]
        if len(dec) == 1 and not any(s <= p[0] and p[1] <= e
                                     for p in prefill):
            inner = idle(*dec[0])
            out.append((idle(s, e) - inner, inner))
    return out or None


def mean_of(pairs, k: int):
    """The mean of the ``k``-th item of ``pairs``; None where there are
    none."""
    return statistics.mean(p[k] for p in pairs) if pairs else None

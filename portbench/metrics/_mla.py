"""What the latent-attention readers share: the device time of the kernels
inside the program's device-side ``mla.attn`` ranges, found within each
profiled call's harness range (``_serve.matched``).

Both the ranges and the call's kernels are on the device's clock, so no
host event is paired with a device range: the profiler's host and device
clocks can differ by more than the gap between a range's host event and
its first kernel, and a reader that pairs them by rank then reads nothing.
"""
from __future__ import annotations

from portbench.metrics._ranges import _within
from portbench.metrics._serve import matched

RANGE = "mla.attn"


def ms_per_call(run, call: str):
    """Device milliseconds a profiled ``call`` (``decode`` or
    ``prefill``) of the kernels inside the ``mla.attn`` device ranges;
    None where the calls or the ranges are missing."""
    pairs = matched(run, call)
    if not pairs:
        return None
    mine = sorted((s, e) for n, s, e in run.trace.ranges if n == RANGE)
    if not mine:
        return None
    us = sum(e - s for _, ops in pairs for _, s, e in ops
             if _within(mine, s, e))
    return 1e-3 * us / len(pairs)

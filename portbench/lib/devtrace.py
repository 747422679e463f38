"""Reduction of a ``torch.profiler`` run to device intervals.

:data:`KERNEL_KINDS` is a frozen copy of ``chip_smoke.py``'s table (commit
62fbfb96d07a), and :func:`kind_of` its first-match rule.  The busy time is
the union of the device operations' intervals (kernels, copies, fills),
not their sum, so overlapping streams are counted once.

A :class:`DeviceTrace` holds the profiled stretch's device operations and
its named ranges on the device timeline (``record_function`` ranges of the
program, ``repro_torch::*`` and ``train_step.*``, and the harness's own
``portbench.*``), each as (name, start_us, end_us), plus the host-side
operations for attributing idle gaps.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

# kernel names -> kinds, first match wins
KERNEL_KINDS = (
    ("flash_attention kernel", ("flash_mma_kernel", "flash_combine_kernel",
                                "flash_f32_kernel")),
    ("ssd_scan kernel", ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                         "ssd_chunk_out_kernel", "ssd_scan_f32_kernel")),
    ("rmsnorm kernel", ("rmsnorm",)),
    ("gemm fp32", ("sgemm", "f32f32", "gemv")),
    ("gemm bf16", ("nvjet", "gemm", "cutlass", "xmma")),
    ("reduce", ("reduce",)),
    ("copy / cast", ("copy", "cat", "fill", "index")),
    ("elementwise", ("elementwise", "vectorized")),
)
# the flash-attention op's forward kernels (rows mode, keys mode and its
# combine, the fp32 body)
FLASH_FORWARD = ("flash_mma_kernel", "flash_combine_kernel",
                 "flash_f32_kernel")
# the harness's host range around the whole profiled stretch
WINDOW_RANGE = "portbench.window"
# device operations that are not kernels
NON_KERNEL = ("Memcpy", "Memset")


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_us(intervals: list[tuple[float, float]], start: float,
            end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


@dataclass
class DeviceTrace:
    ops: list[tuple[str, float, float]]          # device operations
    ranges: list[tuple[str, float, float]]       # named device ranges
    # host operations (name, start_us, end_us, thread)
    host: list[tuple] = field(default_factory=list)
    start_us: float = 0.0                        # the traced window
    end_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.ops]) / 1e6

    def kernels(self) -> list[tuple[str, float, float]]:
        return [o for o in self.ops if not o[0].startswith(NON_KERNEL)]

    def within(self, prefix: str) -> list[tuple[str, float, float]]:
        """Device operations inside a device range whose name starts with
        ``prefix``."""
        spans = sorted((s, e) for n, s, e in self.ranges
                       if n.startswith(prefix))
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op[1]) - 1
            if i >= 0 and op[2] <= spans[i][1]:
                out.append(op)
        return out

    def spans(self, prefix: str) -> list[tuple[float, float]]:
        return sorted((s, e) for n, s, e in self.ranges
                      if n.startswith(prefix))

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time, by name."""
        by: dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> list[list]:
        """Idle time on the device by what the host was doing: each of the
        ``longest`` gaps is put on the innermost host operation running at
        its midpoint on any thread (``host: idle`` where none was)."""
        gaps = gaps_us([(s, e) for _, s, e in self.ops], self.start_us,
                       self.end_us)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        mids = sorted((0.5 * (s + e), e - s) for s, e in gaps)
        best: list = [None] * len(mids)
        threads: dict = {}
        for h in self.host:
            threads.setdefault(h[3] if len(h) > 3 else 0, []).append(h)
        for evs in threads.values():
            evs.sort(key=lambda h: (h[1], -h[2]))
            stack: list = []
            i = 0
            for j, (mid, _) in enumerate(mids):
                while i < len(evs) and evs[i][1] <= mid:
                    while stack and stack[-1][2] < evs[i][1]:
                        stack.pop()
                    stack.append(evs[i])
                    i += 1
                while stack and stack[-1][2] < mid:
                    stack.pop()
                if stack:
                    top = stack[-1]
                    if best[j] is None or (top[2] - top[1]
                                           < best[j][2] - best[j][1]):
                        best[j] = top
        by: dict[str, float] = {}
        for (_, length), b in zip(mids, best):
            key = "host: idle" if b is None else f"host: {b[0][:100]}"
            by[key] = by.get(key, 0.0) + length / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]


def from_profiler(prof) -> DeviceTrace:
    """The device operations and ranges of a finished ``torch.profiler``
    run (``prof.events()``), and its host operations.  The traced window
    is the host range :data:`WINDOW_RANGE` where the harness opened one,
    else the span of the device operations."""
    from torch.autograd import DeviceType

    ops, ranges, host = [], [], []
    start_us = end_us = None
    for e in prof.events():
        dt = getattr(e, "device_type", None)
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if dt == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                ranges.append(span)
            else:
                ops.append(span)
        elif dt == DeviceType.CPU and not getattr(e, "is_async", False):
            host.append(span + (getattr(e, "thread", 0),))
            if e.name == WINDOW_RANGE and start_us is None:
                start_us, end_us = span[1], span[2]
    if start_us is None:
        start_us = min((s for _, s, _ in ops), default=0.0)
    if end_us is None:
        end_us = max((e for _, _, e in ops), default=0.0)
    return DeviceTrace(ops=ops, ranges=ranges, host=host, start_us=start_us,
                       end_us=end_us)

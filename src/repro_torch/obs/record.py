"""Structured span/counter recorder for real executors.

One :class:`Recorder` per launch.  Spans carry the simulator's node-uid
vocabulary as their ``name`` (``F0.1``, ``sendB2.0``, ``gradAR0``,
``step3/decode[4]`` ...) plus a ``device`` matching the simulated
placement (``stage0``, ``link:pp``, ``chip``), so
:mod:`repro_torch.obs.diff` can join real intervals to simulated ones by uid
with no translation table.

Design constraints, in order of importance:

* **Bit-identical measured durations.**  :meth:`Recorder.interval` is the
  measurement primitive the serving engine and the train loop use: it
  reads the clock exactly once at open and once at :meth:`_Interval.stop`,
  whether or not recording is enabled — so swapping ad-hoc
  ``time.perf_counter()`` arithmetic for an interval changes *nothing*
  about the measured value (the serve replay parity tests pin this).

* **Zero cost when disabled.**  ``Recorder(enabled=False).span(...)``
  returns a cached no-op context manager — no allocation, no clock read —
  and ``begin``/``end``/``counter``/``emit`` return immediately.

* **Deterministic export.**  Events are kept in append order and
  serialized with sorted keys, so the exported JSON is byte-identical
  across processes and ``PYTHONHASHSEED`` values (asserted in
  tests/test_obs.py, same convention as the serve sim determinism gate).

:func:`prange` is the port's one way to name a stretch of work for
``torch.profiler``: while a profiler runs, a range whose host event (and,
for a ``record_function``, device-side range) sits on the profiler's
clock beside the device operations; the shared no-op context otherwise.
The Recorder's spans are the simulator's vocabulary on the host clock;
the ranges are the profiler's, and neither feeds the other.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch.autograd import profiler as _profiler


class SpanError(RuntimeError):
    """Mismatched or unbalanced span open/close."""


@dataclass
class Span:
    """One recorded real interval, in the SimEvent schema plus labels."""

    name: str
    device: str
    start: float
    end: float
    kind: str = "span"
    depth: int = 0
    labels: dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "device": self.device,
            "start": self.start,
            "end": self.end,
            "kind": self.kind,
            "depth": self.depth,
            "labels": dict(self.labels),
        }


@dataclass
class Counter:
    """One counter sample (a "C" track point in the overlay)."""

    name: str
    device: str
    t: float
    value: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "device": self.device,
            "t": self.t,
            "value": self.value,
        }


class _NullSpan:
    """Shared no-op context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


def prange(name: str, device: bool = True):
    """A profiler range named ``name`` while a profiler runs; otherwise the
    shared no-op context, at the cost of one flag read
    (``record_function`` itself costs a dispatcher call with no profiler
    running).

    ``device=True``: a ``torch.profiler.record_function``, a host event
    and a device-side range.  The profiler gives each device operation to
    the innermost such range open at its launch, so a range's device side
    spans only the operations no inner range claims.  ``device=False``: a
    host event alone (the profiler's function scope, as an operator's),
    which leaves the operations launched inside it to the enclosing
    device range: the serve engine's loop uses it, so a caller's range
    around a step or a paged call keeps its device side."""
    if not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    if device:
        return torch.profiler.record_function(name)
    return torch._C._profiler._RecordFunctionFast(name)


class _Interval:
    """An open measurement: one clock read at open, one at stop."""

    __slots__ = ("_rec", "name", "device", "kind", "labels", "start")

    def __init__(self, rec: "Recorder", name: str, device: str, kind: str,
                 labels: dict[str, Any]):
        self._rec = rec
        self.name = name
        self.device = device
        self.kind = kind
        self.labels = labels
        self.start = rec.clock()

    def stop(self) -> float:
        """Close the interval; returns the measured duration.  Records a
        span only when the recorder is enabled — the duration itself is
        computed identically either way."""
        end = self._rec.clock()
        if self._rec.enabled:
            self._rec.emit(
                self.name, self.device, self.start, end,
                kind=self.kind, **self.labels,
            )
        return end - self.start


class _SpanCtx:
    """Context-manager wrapper over begin/end (enabled recorders only)."""

    __slots__ = ("_rec", "_name", "_device", "_kind", "_labels")

    def __init__(self, rec, name, device, kind, labels):
        self._rec = rec
        self._name = name
        self._device = device
        self._kind = kind
        self._labels = labels

    def __enter__(self) -> "_SpanCtx":
        self._rec.begin(
            self._name, self._device, kind=self._kind, **self._labels
        )
        return self

    def __exit__(self, *exc) -> None:
        self._rec.end(self._name)


class Recorder:
    """Span/counter recorder over a monotonic clock.

    ``clock`` defaults to ``time.perf_counter``; tests inject counting
    fakes.  All span timestamps are raw clock readings — alignment
    (t0-normalization) happens at export, never at record time.
    """

    def __init__(
        self,
        enabled: bool = True,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.enabled = enabled
        self.clock = clock
        self.spans: list[Span] = []
        self.counters: list[Counter] = []
        # open-span stack: (name, device, kind, labels, start, depth)
        self._stack: list[tuple] = []

    # -- structured spans ----------------------------------------------------

    def begin(self, name: str, device: str = "host", kind: str = "span",
              **labels: Any) -> None:
        if not self.enabled:
            return
        self._stack.append(
            (name, device, kind, labels, self.clock(), len(self._stack))
        )

    def end(self, name: Optional[str] = None) -> None:
        if not self.enabled:
            return
        if not self._stack:
            raise SpanError(
                f"end({name!r}) with no open span"
            )
        top, device, kind, labels, start, depth = self._stack.pop()
        if name is not None and name != top:
            raise SpanError(
                f"mismatched span close: end({name!r}) but the innermost "
                f"open span is {top!r}"
            )
        self.spans.append(
            Span(top, device, start, self.clock(), kind, depth, labels)
        )

    def span(self, name: str, device: str = "host", kind: str = "span",
             **labels: Any):
        """Context manager; the disabled path returns a cached singleton."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, device, kind, labels)

    # -- pre-measured spans and the bit-exact interval primitive --------------

    def emit(self, name: str, device: str, start: float, end: float,
             kind: str = "span", **labels: Any) -> None:
        """Record a span whose endpoints were measured by the caller."""
        if not self.enabled:
            return
        self.spans.append(
            Span(name, device, start, end, kind, len(self._stack), labels)
        )

    def interval(self, name: str, device: str = "host", kind: str = "span",
                 **labels: Any) -> _Interval:
        """Open a measurement: exactly one clock read now, one at
        ``stop()`` — enabled or not (see module docstring)."""
        return _Interval(self, name, device, kind, labels)

    # -- counters -------------------------------------------------------------

    def counter(self, name: str, device: str, value: float,
                t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self.counters.append(
            Counter(name, device, self.clock() if t is None else t,
                    float(value))
        )

    # -- export ---------------------------------------------------------------

    @property
    def open_spans(self) -> list[str]:
        return [s[0] for s in self._stack]

    def to_events(self) -> list[dict[str, Any]]:
        """Spans as SimEvent-schema dicts, in record order.  Raises on
        unbalanced spans — a half-open span has no duration to report."""
        if self._stack:
            raise SpanError(
                f"cannot export with open spans: {self.open_spans}"
            )
        return [s.to_dict() for s in self.spans]

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": "repro.obs/1",
            "spans": self.to_events(),
            "counters": [c.to_dict() for c in self.counters],
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        doc = json.dumps(self.to_dict(), indent=indent, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(doc + "\n")
        return doc

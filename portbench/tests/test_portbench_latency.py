"""TTFT and token gaps are taken on the harness's wall clock from each
request's due time, through the real window loop over a fake engine and a
fake clock."""
from dataclasses import dataclass, field

import pytest

from portbench.kinds import serve
from portbench.lib import stats
from portbench.lib.traffic import TraceRequest


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@dataclass
class _Slot:
    length: int = 0
    phase: str = "decode"


@dataclass
class _Sched:
    queue: list = field(default_factory=list)
    slots: list = field(default_factory=lambda: [_Slot()])
    live: list = field(default_factory=list)

    def outstanding(self):
        return bool(self.queue or self.live)


class FakeEngine:
    """Admits every submitted request at the next step; each step lasts
    ``dt`` on the fake clock and gives every live request one token."""

    def __init__(self, clock, dt, budget):
        self.clock, self.dt, self.budget = clock, dt, budget
        self.sched = _Sched()
        self.requests, self.finished = {}, []
        self.step_log, self.step_durations = [], []

    def submit(self, req):
        self.requests[req.rid] = req
        self.sched.queue.append(req)

    def step(self):
        self.sched.live += self.sched.queue
        self.sched.queue = []
        self.clock.t += self.dt
        for r in list(self.sched.live):
            r.output.append(1)
            if len(r.output) == self.budget:
                r.done = True
                self.finished.append(r)
                self.sched.live.remove(r)
        self.step_log.append((len(self.step_log), (), None, (0,)))
        self.step_durations.append(self.dt)
        return True


def test_due_time_ttft_and_gaps(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(serve.time, "sleep",
                        lambda s: setattr(clock, "t", clock.t + s))
    eng = FakeEngine(clock, dt=0.25, budget=3)
    reqs = [TraceRequest(rid=0, arrival_s=0.0, prompt_len=4,
                         max_new_tokens=3),
            TraceRequest(rid=1, arrival_s=0.1, prompt_len=4,
                         max_new_tokens=3)]
    win = serve.serve_window(eng, reqs, vocab=50, seconds=2.0, drain=5.0,
                             clock=clock)
    # request 0 is due at once: tokens at 0.25, 0.5, 0.75.  Request 1 is due
    # at 0.1 but waits for the step in flight: tokens at 0.5, 0.75, 1.0
    t0 = win["t0"]
    assert [t - t0 for t in win["times"][0]] == pytest.approx(
        [0.25, 0.5, 0.75])
    assert [t - t0 for t in win["times"][1]] == pytest.approx(
        [0.5, 0.75, 1.0])
    lat = serve.latencies(reqs, win, {0: 3, 1: 3})
    assert lat["ttft"] == pytest.approx([0.25, 0.4])
    assert sorted(lat["gaps"]) == pytest.approx([0.25] * 4)
    assert lat["failed"] == 0


def test_unfinished_request_counts_as_missing(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(serve.time, "sleep",
                        lambda s: setattr(clock, "t", clock.t + s))
    eng = FakeEngine(clock, dt=1.0, budget=100)
    reqs = [TraceRequest(rid=0, arrival_s=0.0, prompt_len=4,
                         max_new_tokens=100)]
    win = serve.serve_window(eng, reqs, vocab=50, seconds=2.0, drain=1.0,
                             clock=clock)
    lat = serve.latencies(reqs, win, {0: 100})
    assert lat["failed"] == 1
    # the missing tokens count at the run's end: the tail sees them
    assert lat["ttft"] == [pytest.approx(1.0)]
    assert stats.percentile(lat["gaps"], 95) >= 0.0
    assert len(lat["gaps"]) == 99


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0

"""The readers of the program's own ranges (``metrics/_ranges.py``) on a
hand-built trace laid out as the profiler lays out the port's: the serve
engine's ranges are host events alone, the paged forward's and the MoE
FFN's a host event and a device-side range each (the k-th device range of
a name belongs to the k-th host event).

Times in microseconds.  Three profiled steps:

* step 1, decode only: host ``serve.step`` [0, 110], ``serve.decode``
  [10, 60] holding host ``moe.ffn``, ``paged.kv_gather``, ``paged.head``;
  on the device ``moe.ffn`` [20, 45] (ops [20, 30], [32, 45]),
  ``paged.kv_gather`` [50, 56] (op [50, 55]), ``paged.head`` [60, 90]
  (ops [60, 80], [82, 90]);
* step 2, a chunk and a decode call: the chunk's ``moe.ffn`` (ops [215,
  225], [227, 240]) and ``paged.head`` (op [250, 280]); the decode call's
  ``moe.ffn`` (op [290, 310]), ``paged.kv_gather`` (op [312, 318]) and
  ``paged.head`` (op [320, 380]);
* step 3, decode only: host step [600, 700], decode [610, 650]; one
  ``moe.ffn`` op [615, 640].

One ``moe.ffn`` outside any serve call (host [490, 495], device [500,
520]) counts nowhere.
"""
import pytest

from portbench.kinds.common import Run
from portbench.lib import devtrace, discover

OPS = [("moe_gemm", 20, 30), ("moe_gemm", 32, 45), ("gather", 50, 55),
       ("head_cast", 60, 80), ("head_gemm", 82, 90),
       ("moe_gemm", 215, 225), ("moe_gemm", 227, 240), ("head", 250, 280),
       ("moe_gemm", 290, 310), ("gather", 312, 318), ("head", 320, 380),
       ("moe_gemm", 500, 520), ("moe_gemm", 615, 640)]
RANGES = [("portbench.decode", 20, 45),
          ("moe.ffn", 20, 45), ("paged.kv_gather", 50, 56),
          ("paged.head", 60, 90),
          ("moe.ffn", 215, 240), ("paged.head", 250, 280),
          ("moe.ffn", 290, 310), ("paged.kv_gather", 312, 318),
          ("paged.head", 320, 380),
          ("moe.ffn", 500, 520),
          ("moe.ffn", 615, 640)]
HOST = [("serve.step", 0, 110, 1), ("serve.plan", 1, 5, 1),
        ("serve.decode", 10, 60, 1), ("moe.ffn", 12, 18, 1),
        ("paged.kv_gather", 19, 20, 1), ("paged.head", 21, 25, 1),
        ("aten::mm", 22, 24, 1),
        ("serve.step", 200, 400, 1), ("serve.prefill", 210, 250, 1),
        ("moe.ffn", 212, 220, 1), ("paged.head", 221, 230, 1),
        ("serve.decode", 260, 300, 1), ("moe.ffn", 262, 270, 1),
        ("paged.kv_gather", 271, 272, 1), ("paged.head", 273, 280, 1),
        ("moe.ffn", 490, 495, 1),
        ("serve.step", 600, 700, 1), ("serve.decode", 610, 650, 1),
        ("moe.ffn", 611, 614, 1)]

# per decode call (3 calls), per chunk call (1), per decode-only step (2)
WANT = {
    "moe_ms.decode": 1e-3 * (10 + 13 + 20 + 25) / 3,
    "moe_ms.prefill": 1e-3 * (10 + 13),
    "kv_gather_ms.decode": 1e-3 * (5 + 6) / 3,
    "head_ms.decode": 1e-3 * (20 + 8 + 60) / 3,
    # step 1: [10, 20] [30, 32] [45, 50] [55, 60]; step 3: [610, 615]
    # [640, 650]
    "idle_launch_ms.decode": 1e-3 * (22 + 15) / 2,
    # step 1: [0, 10] [80, 82] [90, 110]; step 3: [600, 610] [650, 700]
    "idle_engine_ms.decode": 1e-3 * (32 + 60) / 2,
}


def _trace(ranges=RANGES, host=HOST, ops=OPS):
    return devtrace.DeviceTrace(ops=list(ops), ranges=list(ranges),
                                host=list(host), start_us=0.0, end_us=800.0)


def _run(kind="serve", trace=None):
    run = Run(kind=kind, dims={}, workload={})
    run.trace = trace
    return run


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_hand_computed_value(name):
    assert discover.reader(name)(_run(trace=_trace())) == \
        pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_where_the_ranges_are_not(name):
    read = discover.reader(name)
    assert read(_run("train", _trace())) is None
    assert read(_run(trace=None)) is None
    assert read(_run(trace=_trace(ranges=[], host=[
        ("portbench.step", 0, 110, 1), ("portbench.decode", 10, 60, 1)]))) \
        is None
    assert read(_run(trace=_trace(ops=[]))) is None


def test_the_two_idle_readers_split_the_steps_idle_time():
    """Launch idle plus engine idle is the device-idle time inside the
    decode-only steps (``devtrace.gaps_us``)."""
    t = _trace()
    busy = [(s, e) for _, s, e in t.ops]
    idle = sum(e - s for a, b in ((0, 110), (600, 700))
               for s, e in devtrace.gaps_us(busy, a, b))
    got = sum(discover.reader(n)(_run(trace=t)) for n in
              ("idle_launch_ms.decode", "idle_engine_ms.decode"))
    assert got == pytest.approx(1e-3 * idle / 2, rel=1e-12)


def test_the_split_of_a_decode_call_is_no_more_than_its_busy_time():
    """The decode calls' device operations are those of [20, 90], [290,
    380] and [615, 640]."""
    t = _trace()
    calls = [(20, 90), (290, 380), (615, 640)]
    busy = sum(e - s for _, s, e in t.ops
               if any(a <= s and e <= b for a, b in calls))
    parts = sum(discover.reader(n)(_run(trace=t)) for n in
                ("moe_ms.decode", "kv_gather_ms.decode", "head_ms.decode"))
    assert parts == pytest.approx(1e-3 * busy / len(calls), rel=1e-12)


def test_device_ranges_pair_with_host_events_in_order():
    """A device range launched before the profiler started has no host
    event and is left out; a host event whose device range the profiler's
    stop cut off pairs with nothing; a device range that starts before its
    host event reads nothing."""
    read = discover.reader("moe_ms.decode")
    early = _trace(ranges=[("moe.ffn", 2, 8)] + RANGES,
                   ops=[("moe_gemm", 2, 8)] + OPS)
    assert read(_run(trace=early)) == pytest.approx(WANT["moe_ms.decode"])
    cut = _trace(ranges=RANGES[:-1], ops=OPS[:-1])
    assert read(_run(trace=cut)) == pytest.approx(1e-3 * (10 + 13 + 20) / 3)
    late = [("moe.ffn", 295, 299, 1) if h[:2] == ("moe.ffn", 262) else h
            for h in HOST]
    assert read(_run(trace=_trace(host=late))) is None

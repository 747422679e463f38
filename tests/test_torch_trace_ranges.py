"""The port's ``torch.profiler`` ranges (``repro_torch.obs.prange``), on the
CPU.

* ``prange`` is the shared no-op context with no profiler running, and
  under ``torch.profiler.profile`` a ``record_function`` (a host event and a
  device-side range) or, with ``device=False``, a host event alone;
* a tiny MoE engine under the profiler: every step's ``serve.step`` holds
  ``serve.plan``, ``serve.inputs``, the paged call (``serve.prefill`` or
  ``serve.decode``), ``serve.readback`` and ``serve.commit``, and each paged
  call holds one ``moe.ffn`` and one ``paged.kv_gather`` a layer and one
  ``paged.head``;
* the engine's tokens, step log and clock reads are the same with and
  without the profiler;
* a profiled train step still shows its phases;
* no ``record_function`` is left in the port outside ``prange``.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as configs  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import prange  # noqa: E402
from repro_torch.obs.record import _NULL_SPAN  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
SERVE = dict(slots=2, max_len=48, block_size=8, chunk=8)
STEP_PARTS = ("serve.plan", "serve.inputs", "serve.readback", "serve.commit")


def _moe_cfg():
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get_config("qwen3-moe-235b-a22b")),
        num_layers=2)
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


@pytest.fixture(scope="module")
def moe_model():
    model = build_model(_moe_cfg())
    return model, model.init(torch.Generator().manual_seed(0))


def _serve(model, params, clock=None):
    """A fresh engine over two requests, one prompt chunked (20 tokens in
    chunks of 8), run to the end; returns the engine."""
    kw = {} if clock is None else {"clock": clock}
    eng = ServeEngine(model, params, device="cpu", **SERVE, **kw)
    rng = np.random.default_rng(7)
    for rid, n in enumerate((20, 5)):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, model.cfg.vocab_size, n).astype(np.int32), max_new_tokens=4))
    eng.run_until_done()
    return eng


def _host_ranges(prof, names):
    """(name, start_us, end_us) of the profiler's host events named in
    ``names``, in start order."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in names]
    return sorted(out, key=lambda r: r[1])


def _inside(ranges, outer):
    _, s, e = outer
    return [r for r in ranges if s <= r[1] and r[2] <= e and r is not outer]


def test_prange_is_the_null_context_without_a_profiler():
    for device in (True, False):
        assert prange("serve.step", device=device) is _NULL_SPAN
    with prange("moe.ffn") as got:
        assert got is _NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = prange("moe.ffn")
        assert isinstance(r, torch.profiler.record_function)
        with r:
            h = prange("serve.step", device=False)
            assert not isinstance(h, torch.profiler.record_function)
            with h:
                pass
    assert prange("moe.ffn") is _NULL_SPAN
    # a device range is a user annotation; a host range an operator's event
    kinds = {e.name: e.is_user_annotation for e in prof.events()
             if e.name in ("moe.ffn", "serve.step")}
    assert kinds == {"moe.ffn": True, "serve.step": False}


def test_engine_ranges_nest_under_the_profiler(moe_model):
    model, params = moe_model
    names = {"serve.step", "serve.prefill", "serve.decode", "moe.ffn",
             "paged.kv_gather", "paged.head", *STEP_PARTS}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng = _serve(model, params)
    ranges = _host_ranges(prof, names)
    steps = [r for r in ranges if r[0] == "serve.step"]
    assert len(steps) == len(eng.step_log)
    chunked = 0
    for outer, sig in zip(steps, eng.step_log):
        held = [r[0] for r in _inside(ranges, outer)]
        for part in STEP_PARTS:
            assert part in held, (sig, part)
        calls = [r for r in _inside(ranges, outer)
                 if r[0] in ("serve.prefill", "serve.decode")]
        assert [c[0] for c in calls] == (
            ["serve.prefill"] * (sig[2] is not None)
            + ["serve.decode"] * bool(sig[3]))
        chunked += sig[2] is not None
        for call in calls:
            inner = [r[0] for r in _inside(ranges, call)]
            assert inner.count("moe.ffn") == model.cfg.num_layers
            assert inner.count("paged.kv_gather") == model.cfg.num_layers
            assert inner.count("paged.head") == 1
    assert chunked == 4         # three chunks of the long prompt, one short
    assert len(eng.step_log) > chunked


def test_engine_is_the_same_under_the_profiler(moe_model):
    model, params = moe_model
    plain = _serve(model, params)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _serve(model, params)
    assert traced.step_log == plain.step_log
    assert ({r.rid: r.output for r in traced.finished}
            == {r.rid: r.output for r in plain.finished})


def test_engine_reads_the_clock_twice_a_step_with_and_without_ranges(
        moe_model):
    model, params = moe_model

    class Counting:
        def __init__(self):
            self.reads = 0

        def __call__(self):
            self.reads += 1
            return float(self.reads)

    plain, traced = Counting(), Counting()
    a = _serve(model, params, clock=plain)
    with profile(activities=[ProfilerActivity.CPU]):
        b = _serve(model, params, clock=traced)
    assert plain.reads == traced.reads == 2 * len(a.step_log)
    assert a.step_durations == b.step_durations == [1.0] * len(a.step_log)


def test_profiled_train_step_shows_its_phases():
    cfg = configs.smoke_variant(configs.get_config("llama3.2-1b"))
    model = build_model(cfg)
    opt = optim.adamw()
    state = init_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt, optim.cosine_with_warmup(1e-3, 1, 5))
    b = {k: torch.tensor(v) for k, v in
         SyntheticTokens(cfg.vocab_size, 16, 2).batch_at(0).items()}
    names = {"train_step.forward", "train_step.backward",
             "train_step.optimizer"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, b)
    assert {r[0] for r in _host_ranges(prof, names)} == names
    assert int(state.step) == 1


def test_no_profiler_range_outside_prange():
    found = []
    for root, _, files in os.walk(SRC):
        for f in files:
            path = os.path.join(root, f)
            rel = os.path.relpath(path, SRC)
            if not f.endswith(".py") or rel == os.path.join("obs",
                                                            "record.py"):
                continue
            with open(path) as fh:
                for n, line in enumerate(fh, 1):
                    code = line.split("#")[0]
                    if "record_function" in code or "RecordFunction" in code:
                        found.append(f"{rel}:{n}")
    assert found == []

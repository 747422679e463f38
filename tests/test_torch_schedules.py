"""The port's pipeline schedules are the JAX package's: every step table,
data dependency, tick table, executor plan and byte twin is identical over
schedule x stages x virtual stages x microbatches, and the port's schedule
checks and span names agree with the reference's.

``repro_torch.dist.schedules`` is a copy of a framework-neutral module, so
the comparison is exact (no tolerance).
"""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import schedule_checks as jax_checks  # noqa: E402
from repro.dist import pp as jax_pp  # noqa: E402
from repro.dist import schedules as jax_sched  # noqa: E402
from repro_torch.analysis import schedule_checks as port_checks  # noqa: E402
from repro_torch.dist import pp as port_pp  # noqa: E402
from repro_torch.dist import schedules as port_sched  # noqa: E402

torch.set_num_threads(2)

GRID = list(itertools.product(("gpipe", "1f1b", "interleaved_1f1b"),
                              (1, 2, 4), (1, 2), (4, 8)))


def _make(mod, name, S, v, M):
    try:
        return mod.make_schedule(name, S, M, v), None
    except ValueError as e:
        return None, str(e)


def _steps(schedule):
    return [(s.stage, s.vstage, s.microbatch, s.phase, s.name)
            for s in schedule.steps()]


@pytest.mark.parametrize("name,S,v,M", GRID)
def test_step_tables_and_twins_equal_reference(name, S, v, M):
    js, jerr = _make(jax_sched, name, S, v, M)
    ts, terr = _make(port_sched, name, S, v, M)
    assert (js is None) == (ts is None) and jerr == terr
    if js is None:
        return
    assert ts.describe() == js.describe()
    assert _steps(ts) == _steps(js)
    for st in range(S):
        assert ([s.key for s in ts.stage_steps(st)]
                == [s.key for s in js.stage_steps(st)])
    for tstep, jstep in zip(ts.steps(), js.steps()):
        assert ([d.key for d in ts.data_deps(tstep)]
                == [d.key for d in js.data_deps(jstep)])
    try:
        jt = {k.key: t for k, t in js.tick_table().items()}
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            ts.tick_table()
        return
    assert {k.key: t for k, t in ts.tick_table().items()} == jt
    assert ts.total_ticks() == js.total_ticks()
    assert ts.comm_steps() == js.comm_steps()
    assert ts.analytic_bubble_ticks() == js.analytic_bubble_ticks()
    for hop in (1.0, 8 * 2048 * 2048.0, 3.5):
        assert ts.comm_bytes(hop) == js.comm_bytes(hop)
    jp, tp = jax_sched.build_executor_plan(js), \
        port_sched.build_executor_plan(ts)
    for f in dataclasses.fields(jp):
        if f.name != "schedule":
            assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert tp.comm_bytes(4096.0) == jp.comm_bytes(4096.0)
    assert port_pp._extended_actions(tp) == jax_pp._extended_actions(jp)
    assert port_pp.schedule_span_names(ts) == jax_pp.schedule_span_names(js)
    assert (port_pp.schedule_transfer_bytes(ts, (2, 16, 64), "bfloat16")
            == jax_pp.schedule_transfer_bytes(js, (2, 16, 64), "bfloat16"))
    jr = jax_checks.lint_schedule(js)
    tr = port_checks.lint_schedule(ts)
    assert tr.codes() == jr.codes() and tr.metrics == jr.metrics
    jr = jax_checks.lint_executor_plan(jp)
    tr = port_checks.lint_executor_plan(tp)
    assert tr.codes() == jr.codes() and tr.metrics == jr.metrics


@pytest.mark.parametrize("S,M", [(1, 4), (2, 4), (4, 8), (3, 5)])
def test_wavefront_byte_twin_equals_reference(S, M):
    shape = (2, 16, 64)
    for dt in ("float32", "bfloat16"):
        for bwd in (True, False):
            assert port_pp.pipeline_transfer_bytes(
                S, M, shape, dt, backward=bwd
            ) == jax_pp.pipeline_transfer_bytes(S, M, shape, dt,
                                                backward=bwd)
        assert port_pp.boundary_bytes(shape, dt) == \
            jax_pp.boundary_bytes(shape, dt)

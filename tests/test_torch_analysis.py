"""The port's static analyzers (``repro_torch.analysis``) against the JAX
package's: the cases of ``tests/test_analysis.py`` and
``tests/test_serve_analysis.py``, each run through both packages on the
same inputs, with ``Report.to_dict()`` (codes, messages, metrics, extras)
required identical.  The serve coverage audit's calibration command names
each package's own launcher, the one substitution made before comparing.

Also: the launchers' ``--analyze`` / ``--analyze-plan`` gates, the
``--simulate`` timeline audit (both launchers exit 1 on an error-level
finding), and ``python -m repro_torch.analysis``.
"""
import dataclasses
import importlib
import json
import math
import os
import sys
import types

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TRACE_PATH = os.path.join(REPO, "benchmarks", "traces",
                          "serve_acceptance.json")
ARCH = "llama3.2-1b"

_MODULES = {
    "A": "analysis", "cov": "analysis.coverage",
    "sc": "analysis.serve_checks", "tl": "analysis.timeline_checks",
    "graph": "core.graph", "sim": "core.simulator",
    "strategy": "core.strategy", "sched": "dist.schedules",
    "base": "configs.base", "est": "core.estimator",
    "hw": "core.hardware", "db": "core.database", "cost": "serve.cost",
    "policy": "serve.policy", "trace": "serve.trace",
    "autotuner": "core.autotuner", "serve_sim": "serve.sim",
    "netprof": "netprof.pricing",
}


def _ns(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(pkg=pkg, **{
        k: importlib.import_module(f"{pkg}.{m}") for k, m in _MODULES.items()
    })


JAX, PORT = _ns("repro"), _ns("repro_torch")


def _norm(doc):
    """A report dict with the port's launcher name put back."""
    return json.loads(json.dumps(doc).replace("repro_torch.", "repro."))


def _both(case):
    """Run ``case`` through both packages; its reports must be identical."""
    j, t = case(JAX), case(PORT)
    if hasattr(j, "to_dict"):
        jd, td = j.to_dict(), t.to_dict()
        assert _norm(td) == jd
        return t
    assert t == j
    return t


# ---------------------------------------------------------------------------
# graph lints, accounting, the simulator's stall message
# ---------------------------------------------------------------------------


def _raw_graph(ns, specs):
    g = ns.graph.DataflowGraph("corpus")
    for uid, (name, deps, kw) in enumerate(specs):
        kw = dict(kw)
        g.nodes.append(ns.graph.OpNode(uid=uid, name=name,
                                       kind=kw.pop("kind", "op"),
                                       deps=list(deps), **kw))
    return g


def _acct_graph(ns, variant):
    g = ns.graph.DataflowGraph("acct")
    if variant == "a001":
        g.add("grads", "add")
        g.add("hop", "collective-permute", deps=[0], link_kind="ici",
              group_size=2, meta={"pp_hop": {"shape": (2, 16)}})
    else:
        g.add("ar", "all-reduce", link_kind="ici", group_size=4,
              comm_bytes=0.0 if variant == "a002" else 4096.0)
    return g


_GRAPH_CASES = {
    "g005_cycle": ([("a", [1], {}), ("b", [0], {}), ("c", [1], {})], "G005"),
    "g003_dangling": ([("a", [], {}), ("b", [7], {})], "G003"),
    "g004_self_dep": ([("a", [0], {})], "G004"),
}


@pytest.mark.parametrize("case", sorted(_GRAPH_CASES))
def test_graph_lints_match(case):
    specs, code = _GRAPH_CASES[case]
    rep = _both(lambda ns: ns.A.lint_graph(_raw_graph(ns, specs)))
    assert code in rep.codes() and not rep.ok
    assert _both(lambda ns: ns.A.find_cycle(_raw_graph(ns, specs).nodes))\
        == PORT.A.find_cycle(_raw_graph(PORT, specs).nodes)


def test_clean_graph_and_cycle_message_match():
    def clean(ns):
        g = ns.graph.DataflowGraph("ok")
        a = g.add("a", "op")
        g.add("b", "op", deps=[a.uid])
        return ns.A.lint_graph(g)

    assert _both(clean).ok

    def stall(ns):
        g = _raw_graph(ns, _GRAPH_CASES["g005_cycle"][0])
        with pytest.raises(RuntimeError) as ei:
            ns.sim.simulate(g, lambda n: 1.0)
        return str(ei.value)

    msg = _both(stall)
    assert "dependency cycle" in msg and "unreached nodes" in msg


@pytest.mark.parametrize("variant,code", [("a001", "A001"),
                                          ("a002", "A002"),
                                          ("a003", "A003")])
def test_accounting_lints_match(variant, code):
    def run(ns):
        est = None
        if variant == "a003":
            est = ns.est.OpTimeEstimator(ns.hw.TPU_V5E, db=ns.db.ProfileDB(),
                                         use_learned=False)
        return ns.A.lint_graph(_acct_graph(ns, variant), estimator=est)

    assert code in _both(run).codes()


# ---------------------------------------------------------------------------
# schedules and executor plans
# ---------------------------------------------------------------------------


def _tampered(ns, base, mutate):
    class Tampered(ns.sched.PipelineSchedule):
        name = "tampered"

        def __init__(self):
            super().__init__(base.n_stages, base.n_microbatches,
                             base.vstages)

        def stage_steps(self, stage):
            return mutate(ns, stage, list(base.stage_steps(stage)))

    return Tampered()


def _drop_first_fwd(ns, stage, steps):
    return steps[1:] if stage == 0 else steps


def _swap_last_stage(ns, stage, steps):
    if stage == 1:
        steps[0], steps[1] = steps[1], steps[0]
    return steps


def _misplace(ns, stage, steps):
    if stage == 0:
        steps[0] = ns.sched.Step(0, 1, 0, steps[0].phase)
    return steps


_SCHEDULE_CASES = {
    "clean_gpipe": (("gpipe", 4, 8, 1), None, None),
    "clean_1f1b": (("1f1b", 4, 8, 1), None, None),
    "clean_interleaved": (("interleaved_1f1b", 4, 8, 2), None, None),
    "s003_s005_dropped": (("1f1b", 2, 2, 1), _drop_first_fwd, "S005"),
    "s006_bwd_first": (("1f1b", 2, 2, 1), _swap_last_stage, "S006"),
    "s001_misplaced": (("gpipe", 2, 2, 1), _misplace, "S001"),
}


@pytest.mark.parametrize("case", sorted(_SCHEDULE_CASES))
def test_schedule_lints_match(case):
    args, mutate, code = _SCHEDULE_CASES[case]

    def run(ns):
        sch = ns.sched.make_schedule(*args)
        if mutate is not None:
            sch = _tampered(ns, sch, mutate)
        return ns.A.lint_schedule(sch)

    rep = _both(run)
    assert rep.ok if code is None else code in rep.codes()


@pytest.mark.parametrize("kw,n_layers,code", [
    (dict(pp=4, microbatches=6, schedule="interleaved_1f1b", vstages=2),
     16, "S012"),
    (dict(pp=4, microbatches=8, schedule="interleaved_1f1b", vstages=2),
     10, "S013"),
    (dict(pp=4, microbatches=8), 16, None),
])
def test_strategy_lints_match(kw, n_layers, code):
    rep = _both(lambda ns: ns.A.lint_strategy(ns.strategy.Strategy(**kw),
                                              n_layers=n_layers))
    assert rep.codes() == ([code] if code else [])


def _first_true(table, n):
    return next((t, s) for t, row in enumerate(table) for s in range(n)
                if row[s])


def _zero_recv(plan, n):
    t, s = _first_true(plan.recv_fwd_valid, n)
    plan.recv_fwd_valid[t][s] = 0


def _misroute(plan, n):
    t, s = _first_true(plan.recv_fwd_valid, n)
    plan.recv_fwd_mb[t][s] += 1


def _drop_send(plan, n):
    t, s = _first_true(plan.sends_fwd, n)
    plan.sends_fwd[t][s] = 0


@pytest.mark.parametrize("sched,tamper,code", [
    (("gpipe", 4, 8, 1), None, None),
    (("1f1b", 4, 8, 1), None, None),
    (("interleaved_1f1b", 4, 8, 2), None, None),
    (("1f1b", 4, 8, 1), _zero_recv, "S007"),
    (("interleaved_1f1b", 4, 8, 2), _misroute, "S008"),
    (("gpipe", 4, 8, 1), _drop_send, "S011"),
])
def test_executor_plan_lints_match(sched, tamper, code):
    def run(ns):
        sch = ns.sched.make_schedule(*sched)
        plan = ns.sched.build_executor_plan(sch)
        if tamper is not None:
            tamper(plan, sch.n_stages)
        return ns.A.lint_executor_plan(plan)

    rep = _both(run)
    assert rep.ok if code is None else code in rep.codes()


# ---------------------------------------------------------------------------
# timeline audit
# ---------------------------------------------------------------------------

_TIMELINES = {
    "t001_overlap": ([(0, "a", "op", "chip", 0.0, 1.0),
                      (1, "b", "op", "chip", 0.5, 1.5)], 1.5, False),
    "t002_causality": ([(0, "a", "op", "stage0", 0.0, 1.0),
                        (1, "b", "op", "stage1", 0.5, 1.5)], 1.5, True),
    "t003_t004_intervals": ([(0, "neg", "op", "chip", 1.0, 0.5),
                             (1, "nan", "op", "chip", 0.0, math.nan),
                             (2, "runaway", "op", "chip", 0.0, 9.0)],
                            2.0, False),
    "t010_link_overlap": ([(0, "g0", "all-reduce", "link:dp0", 0.0, 1.0),
                           (1, "g1", "all-reduce", "link:dp1", 0.5, 1.5),
                           (2, "g2", "all-reduce", "link:dp1", 2.0, 2.5),
                           (3, "p0", "collective-permute", "link:pp", 3.0,
                            4.0)], 4.0, False),
}


def _timeline(ns, case):
    events, makespan, with_graph = _TIMELINES[case]
    res = ns.sim.SimResult(makespan=makespan, device_busy={},
                           events=[ns.sim.SimEvent(*e) for e in events],
                           time_by_kind={})
    g = None
    if with_graph:
        g = ns.graph.DataflowGraph("causal")
        g.add("a", "op", device="stage0")
        g.add("b", "op", deps=[0], device="stage1")
    return res, g


@pytest.mark.parametrize("case", sorted(_TIMELINES))
def test_timeline_audit_matches(case):
    rep = _both(lambda ns: ns.tl.audit_timeline(*_timeline(ns, case)))
    assert rep.findings
    json.dumps(_both(lambda ns: ns.tl.link_contention(_timeline(ns,
                                                                case)[0])))


def test_real_simulated_timeline_audit_matches():
    def run(ns):
        cfg = ns.base.get_config(ARCH)
        cost = ns.autotuner.layer_cost_from_config(cfg, 1, 128, 1)
        g = ns.strategy.pipeline_graph(
            cfg.num_layers, cost, ns.strategy.Strategy(pp=4, microbatches=8))
        res = ns.sim.simulate(g, lambda n: 1e-3, record_events=True)
        return ns.tl.audit_timeline(res, g)

    assert _both(run).ok


# ---------------------------------------------------------------------------
# whole-plan entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,model_graph", [
    (dict(pp=4, microbatches=8), False),
    (dict(pp=4, microbatches=6, schedule="interleaved_1f1b", vstages=2),
     False),
    (dict(pp=2, microbatches=4, dp=2, compression="int8"), True),
    (dict(pp=2, microbatches=4, schedule="interleaved_1f1b", vstages=2),
     True),
])
def test_analyze_training_plan_matches(kw, model_graph):
    def run(ns):
        cfg = ns.base.smoke_variant(ns.base.get_config(ARCH)) \
            if model_graph else ns.base.get_config(ARCH)
        return ns.A.analyze_training_plan(
            cfg, ns.strategy.Strategy(**kw), micro_batch=1, seq=128,
            use_model_graph=model_graph)

    rep = _both(run)
    assert rep.ok == (kw.get("microbatches") != 6)


@pytest.fixture
def jax_archs(monkeypatch):
    """The port's sweeps over the archs both packages register (the port
    registers granite-4.0-h-small besides, which the JAX package has not
    to compare with)."""
    from repro.configs import base as jax_base
    from repro_torch.configs import base as port_base

    monkeypatch.setattr(port_base, "list_archs", jax_base.list_archs)


@pytest.mark.parametrize("run_sim", [False, True])
def test_analyze_all_configs_matches(run_sim, jax_archs):
    rep = _both(lambda ns: ns.A.analyze_all_configs(run_sim=run_sim,
                                                    seq=64))
    assert rep.ok and rep.metrics["plans_analyzed"] > 0


# ---------------------------------------------------------------------------
# serve plans: the ledger (R codes) and ProfileDB coverage (A005+)
# ---------------------------------------------------------------------------


def _scfg(ns, **kw):
    base = dict(slots=2, max_len=64, block_size=8, chunk=8)
    base.update(kw)
    return ns.policy.ServeConfig(**base)


def _trace(ns):
    return ns.trace.load_trace(TRACE_PATH)


def _plan(ns):
    return ns.sc.extract_serve_plan(_trace(ns), _scfg(ns))


def _db(ns, slot_grid=(1, 2, 4), buckets=(1, 2, 4, 8, 16, 32), arch=ARCH):
    db = ns.db.ProfileDB()
    scfg = _scfg(ns)
    ns.cost.synthetic_serve_calibration(
        db, arch, "cpu_host", views=(scfg.view_len,), buckets=buckets,
        slot_grid=slot_grid)
    return db


def test_acceptance_trace_plan_matches(tmp_path):
    rep = _both(lambda ns: ns.sc.audit_serve_plan(_trace(ns), _scfg(ns)))
    assert rep.ok and rep.metrics["serve_plan_requests"] == 16
    assert _both(lambda ns: _plan(ns).to_dict())
    path = str(tmp_path / "plan.json")
    _plan(JAX).save(path)
    loaded = PORT.sc.ServePlan.load(path)
    assert loaded.to_dict() == _plan(PORT).to_dict()


def test_trace_lint_matches():
    def run(ns):
        T = ns.trace.TraceRequest
        rep = ns.sc.lint_serve_trace(
            [T(rid=0, arrival_s=0.0, prompt_len=65, max_new_tokens=4),
             T(rid=0, arrival_s=0.0, prompt_len=8, max_new_tokens=4)],
            _scfg(ns))
        rep.extend(ns.sc.lint_serve_trace(
            [T(rid=1, arrival_s=0.0, prompt_len=60, max_new_tokens=4)],
            _scfg(ns, num_blocks=3)))
        return rep

    assert {"R003", "R004", "R005"} <= set(_both(run).codes())


def _replace_step(plan, i, **kw):
    steps = list(plan.steps)
    steps[i] = dataclasses.replace(steps[i], **kw)
    return dataclasses.replace(plan, steps=steps)


def _first(plan, attr):
    return next(i for i, s in enumerate(plan.steps) if getattr(s, attr))


def _r001(plan):
    i = max(i for i, s in enumerate(plan.steps) if s.freed)
    return _replace_step(plan, i, freed=())


def _r002(plan):
    i = _first(plan, "freed")
    s = plan.steps[i]
    return _replace_step(plan, i, freed=s.freed + (s.freed[0],))


def _r003(plan):
    i = _first(plan, "admitted")
    adm = plan.steps[i].admitted
    bad = dataclasses.replace(
        adm[0], blocks=(plan.num_blocks + 7,) + adm[0].blocks[1:])
    return _replace_step(plan, i, admitted=(bad,) + adm[1:])


def _r004(plan):
    i = _first(plan, "admitted")
    adm = plan.steps[i].admitted
    bad = dataclasses.replace(adm[0], budget=adm[0].budget + 50)
    return _replace_step(plan, i, admitted=(bad,) + adm[1:])


def _r005(plan):
    arrivals = {int(r["rid"]): float(r["arrival_s"]) for r in plan.requests}
    for i, s in enumerate(plan.steps):
        for adm in s.admitted:
            if arrivals[adm.rid] > 0:
                return _replace_step(plan, i,
                                     clock_s=arrivals[adm.rid] - 1.0)
    raise AssertionError("every request arrives at t=0")


def _r006(plan):
    i = _first(plan, "decode_slots")
    s = plan.steps[i]
    return _replace_step(plan, i,
                         decode_slots=s.decode_slots + (s.decode_slots[0],))


def _r007(plan):
    i = next(i for i, s in enumerate(plan.steps) if s.prefill is not None)
    slot, rid, start, width, final = plan.steps[i].prefill
    return _replace_step(plan, i, prefill=(slot, rid, start, width + 100,
                                           final))


_TAMPERS = {"R001": _r001, "R002": _r002, "R003": _r003, "R004": _r004,
            "R005": _r005, "R006": _r006, "R007": _r007}


@pytest.mark.parametrize("code", sorted(_TAMPERS))
def test_tampered_plan_reports_match(code):
    rep = _both(lambda ns: ns.sc.check_serve_plan(
        _TAMPERS[code](_plan(ns)), name=f"tamper:{code}"))
    assert not rep.ok and code in rep.codes()


@pytest.mark.parametrize("slots,chunk", [(1, 4), (2, 8), (4, 16)])
def test_untampered_plans_match(slots, chunk):
    rep = _both(lambda ns: ns.sc.check_serve_plan(ns.sc.extract_serve_plan(
        _trace(ns), _scfg(ns, slots=slots, chunk=chunk))))
    assert rep.ok


def _cov_doc(cov):
    """A coverage result as one comparable document."""
    return types.SimpleNamespace(to_dict=lambda: {
        "report": cov.report.to_dict(), "coverage": cov.to_dict()})


_COVERAGE = {
    "exact": {},
    "interp": {"slot_grid": (1, 4)},
    "extrap": {"buckets": (1, 2), "slot_grid": (1, 2, 4)},
    "fallback": {"arch": "mamba2-2.7b"},
}


@pytest.mark.parametrize("case", sorted(_COVERAGE))
def test_serve_coverage_matches(case):
    def run(ns):
        cov = ns.cov.audit_serve_coverage(_trace(ns), ARCH, _scfg(ns),
                                          _db(ns, **_COVERAGE[case]))
        return _cov_doc(cov)

    doc = _both(run).to_dict()
    ok = doc["report"]["ok"]
    assert ok == (case != "fallback")
    if case == "interp":
        assert "repro_torch.launch.serve" in json.dumps(doc)


def test_calibration_grid_closes_the_gaps_in_both():
    def run(ns):
        scfg = _scfg(ns)
        db = _db(ns, slot_grid=(1, 4), buckets=(1, 2))
        first = ns.cov.audit_serve_coverage(_trace(ns), ARCH, scfg, db)
        for e in first.grid:
            db.add("cpu_host", e["family"], ns.db.ProfileEntry(
                args=dict(e["args"]), mean_s=1e-3, std_s=0.0, n=1,
                flops=0.0, bytes=0.0))
        second = ns.cov.audit_serve_coverage(_trace(ns), ARCH, scfg, db)
        return (first.grid, second.grid,
                second.report.metrics["coverage_exact"])

    first, second, exact = _both(run)
    assert first and second == [] and exact > 0


def test_serve_query_enumeration_matches():
    def run(ns):
        return [(q.family, q.args_dict, q.count) for q in
                ns.cov.enumerate_serve_queries(_trace(ns), ARCH, _scfg(ns))]

    assert {f for f, _, _ in _both(run)} == {"serve_prefill",
                                             "serve_decode"}


@pytest.mark.parametrize("case", sorted(_COVERAGE))
def test_serve_classification_matches_stamped_provenance(case):
    ns = PORT
    db = _db(ns, **_COVERAGE[case])
    scfg = _scfg(ns)
    cfg = ns.base.smoke_variant(ns.base.get_config(ARCH))
    est = ns.est.OpTimeEstimator(ns.hw.CPU_HOST, db=db, use_learned=False)
    res = ns.serve_sim.simulate_serve(_trace(ns), cfg, scfg, est)
    pricer = ns.cost.ServePricer(db, "cpu_host")
    xkey = ns.cost._XKEY
    classes = {(q.family, q.args_dict[xkey[q.family]]):
               ns.cov.classify_serve_query(pricer, q)
               for q in ns.cov.enumerate_serve_queries(_trace(ns), cfg.name,
                                                       scfg)}
    checked = 0
    for node in res.graph.nodes:
        serve = node.meta.get("serve")
        if serve is None:
            continue
        cls = classes[(serve["family"], serve[xkey[serve["family"]]])]
        assert node.meta["time_provenance"] in \
            ns.cov.CLASS_TO_PROVENANCE[cls]
        checked += 1
    assert checked == len(res.graph.nodes) > 0


def test_collective_coverage_matches(tmp_path):
    from repro.netprof.sweep import synthetic_calibration

    jdb = JAX.db.ProfileDB()
    synthetic_calibration(jdb, JAX.hw.TPU_V5E.name, groups=(2, 4),
                          payload_bytes=(4096, 65536),
                          collectives=("all-reduce",))
    path = str(tmp_path / "net.json")
    jdb.save(path)

    def run(ns):
        db = ns.db.ProfileDB.load(path)
        pricer = ns.netprof.CollectivePricer(db, ns.hw.TPU_V5E)
        g = ns.graph.DataflowGraph("cov")
        for name, kind, b in (("exact", "all-reduce", 4096.0),
                              ("interp", "all-reduce", 16000.0),
                              ("extrap", "all-reduce", 2.0 ** 30),
                              ("fallback", "all-gather", 4096.0)):
            g.add(name, kind, link_kind="ici", group_size=4, comm_bytes=b)
        return _cov_doc(ns.cov.audit_collective_coverage(
            g, pricer, db_path="db.json"))

    doc = _both(run).to_dict()
    assert "A005" in [f["code"] for f in doc["report"]["findings"]]


def test_analyze_serve_entry_points_match(jax_archs):
    rep = _both(lambda ns: ns.A.analyze_serve_trace(
        _trace(ns), ARCH, _scfg(ns), db=_db(ns)))
    assert rep.ok and rep.extras["coverage"][ARCH]["queries"]
    merged = _both(lambda ns: ns.A.analyze_serve_sweep(_trace(ns)))
    assert merged.ok and merged.metrics["serve_plans_analyzed"] > 0


# ---------------------------------------------------------------------------
# launchers and the CLI
# ---------------------------------------------------------------------------


def test_launch_serve_analyze_gate(tmp_path, capsys):
    from repro_torch.analysis import PlanVerificationError
    from repro_torch.launch import serve as launcher

    shape = ["--arch", ARCH, "--smoke", "--device", "cpu", "--slots", "2",
             "--max-len", "64", "--block-size", "8", "--chunk", "8"]
    out_json = str(tmp_path / "analyze.json")
    assert launcher.main(shape + ["--trace-file", TRACE_PATH, "--analyze",
                                  "--synthetic-db", "--analyze-report",
                                  out_json]) == 0
    doc = json.loads(open(out_json).read())
    assert doc["ok"] and doc["extras"]["run_spec"]["slots"] == 2
    assert "[analyze]" in capsys.readouterr().out
    good, bad = str(tmp_path / "good.json"), str(tmp_path / "bad.json")
    _plan(PORT).save(good)
    _r002(_plan(PORT)).save(bad)
    assert launcher.main(shape + ["--analyze-plan", good]) == 0
    with pytest.raises(PlanVerificationError) as ei:
        launcher.main(shape + ["--analyze-plan", bad])
    assert "R002" in str(ei.value)


def _strip_stamp(real):
    """A ``simulate_serve`` whose timeline has one serve node unstamped:
    an error-level finding (A004) for the timeline audit."""
    def run(*a, **kw):
        res = real(*a, **kw)
        node = next(n for n in res.graph.nodes if n.meta.get("serve"))
        del node.meta["time_provenance"]
        return res
    return run


def test_simulate_audit_exits_1_in_both_launchers(monkeypatch, capsys):
    import repro.serve.sim as jsim
    import repro_torch.serve.sim as tsim
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch

    argv = ["--smoke", "--trace-file", TRACE_PATH, "--slots", "2",
            "--max-len", "64", "--block-size", "8", "--chunk", "8",
            "--simulate", "--synthetic-db"]
    assert tlaunch.main(argv + ["--device", "cpu"]) == 0
    monkeypatch.setattr(jsim, "simulate_serve",
                        _strip_stamp(jsim.simulate_serve))
    monkeypatch.setattr(tsim, "simulate_serve",
                        _strip_stamp(tsim.simulate_serve))
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert jlaunch.main() == 1
    jout = capsys.readouterr().out
    assert tlaunch.main(argv + ["--device", "cpu"]) == 1
    tout = capsys.readouterr().out
    audit = [ln for ln in jout.splitlines() if ln.startswith("[serve] AUDIT")]
    assert audit and audit[0].startswith("[serve] AUDIT A004")
    assert [ln for ln in tout.splitlines()
            if ln.startswith("[serve] AUDIT")] == audit


def _synthetic_netprof_db(ns, path):
    """A calibrated interconnect DB for ``cpu_host`` (the sweep's exact
    α–β ground truth), written by package ``ns``."""
    from importlib import import_module

    db = ns.db.ProfileDB()
    import_module(f"{ns.pkg}.netprof.sweep").synthetic_calibration(
        db, "cpu_host")
    db.save(str(path))
    return str(path)


def test_train_launcher_analyze_raises_on_a_bad_plan(capsys, tmp_path):
    from repro_torch.analysis import PlanVerificationError
    from repro_torch.launch import train as launcher

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
            "--seq", "32", "--analyze"]
    launcher.main(base + ["--batch", "8", "--ranks", "4", "--pp", "2",
                          "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "[analyze] plan:" in out and "0 errors" in out
    assert "metric sim_makespan_s" in out
    # interleaving 2 stages needs microbatches divisible by 2: S012 (the
    # launcher's plan builder refuses it too, so the report is asked alone)
    cfg = PORT.base.smoke_variant(PORT.base.get_config(ARCH))
    with pytest.raises(PlanVerificationError, match="S012"):
        launcher.plan_analysis_report(
            cfg, PORT.strategy.Strategy(pp=2, microbatches=3, vstages=2,
                                        schedule="interleaved_1f1b"),
            micro_batch=1, seq=32,
            estimator=PORT.est.OpTimeEstimator(PORT.hw.CPU_HOST))
    # --netprof-db: the plan is priced on the calibrated host, its
    # collectives from the measured chain, at the analyze, plan and parity
    # reports (the flag raised before the collective sweep was ported)
    db = _synthetic_netprof_db(PORT, tmp_path / "netprof.json")
    launcher.main(base + ["--batch", "8", "--ranks", "4", "--pp", "2",
                          "--microbatches", "2", "--compression", "int8",
                          "--netprof-db", db])
    out = capsys.readouterr().out
    assert f"[netprof] {db}: platform cpu_host" in out
    assert "[analyze] plan:" in out and "0 errors" in out
    assert "[netprof] ring-fallback nodes for profiled collectives: 0" in out
    assert "[netprof] comm nodes ring-priced: 0" in out
    assert "[netprof] all-reduce: 2 measured-fit" in out


def test_analysis_cli_matches(tmp_path, jax_archs):
    from repro.analysis.__main__ import main as jmain
    from repro_torch.analysis.__main__ import main as tmain

    docs = []
    for main, name in ((jmain, "j"), (tmain, "t")):
        out = str(tmp_path / f"{name}.json")
        serve = str(tmp_path / f"{name}_serve.json")
        assert main(["--json", out, "--seq", "64", "--serve-trace",
                     TRACE_PATH, "--serve-json", serve]) == 0
        docs.append((json.load(open(out)), json.load(open(serve))))
    assert _norm(docs[1]) == _norm(docs[0])
    # --netprof-db (it raised before the collective sweep was ported): both
    # CLIs price every plan through the same calibrated DB, identically
    db = _synthetic_netprof_db(JAX, tmp_path / "netprof.json")
    docs = []
    for main, name in ((jmain, "jn"), (tmain, "tn")):
        out = str(tmp_path / f"{name}.json")
        assert main(["--json", out, "--seq", "64", "--netprof-db", db]) == 0
        docs.append(json.load(open(out)))
    assert _norm(docs[1]) == _norm(docs[0])
    assert "A003" not in json.dumps(docs[1])

"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

* ``obs/diff.py`` and ``obs/overlay.py`` are copies: the cases of
  ``tests/test_obs.py`` (a clean join, each O code on its tampered corpus,
  the structural step spans, the capped findings, a recorder as input; the
  overlay's tracks, provenance args, counter tracks and a real-only trace)
  run through both packages on the same inputs, and the divergence report
  (``Report.to_dict()``) and the overlay trace must be identical.
* ``obs/replay.py`` re-executes every node of a smoke pp = 2 x dp = 2
  plan on the port's logical-rank mesh: each node once, under its uid and
  its simulated device, the mesh's byte counters untouched.
* The launchers' ``--obs --trace-out`` on the CPU.
"""
import importlib
import json
import os
import types

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

_MODULES = {"obs": "obs", "record": "obs.record", "sim": "core.simulator",
            "strategy": "core.strategy", "pricing": "pricing",
            "pp": "dist.pp", "analysis": "analysis"}


def _ns(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{pkg}.{m}") for k, m in _MODULES.items()
    })


JAX, PORT = _ns("repro"), _ns("repro_torch")


class FakeClock:
    def __init__(self):
        self.reads = 0

    def __call__(self) -> float:
        self.reads += 1
        return float(self.reads - 1)


def _sim(ns, events):
    busy: dict[str, float] = {}
    for e in events:
        busy[e[3]] = busy.get(e[3], 0.0) + (e[5] - e[4])
    return ns.sim.SimResult(
        makespan=max((e[5] for e in events), default=0.0),
        device_busy=busy, events=[ns.sim.SimEvent(*e) for e in events],
        time_by_kind={},
    )


def _graph(ns, n_layers=2):
    S = ns.strategy
    g = S.pipeline_graph(
        n_layers, S.LayerCost(fwd_flops=1e6, fwd_bytes=1e4,
                              boundary_bytes=64),
        S.Strategy(pp=2, microbatches=1))
    for n in g.nodes:
        n.meta["time_provenance"] = ns.pricing.PROV_DB
    return g


# -- divergence attribution ------------------------------------------------

_JOINED = [
    (0, "F0.0", "fwd", "stage0", 0.0, 1.0),
    (1, "sendF0.0", "collective-permute", "link:pp", 1.0, 1.5),
    (2, "B0.0", "bwd", "stage0", 1.5, 3.5),
]


def _spans():
    return [
        {"name": "F0.0", "device": "stage0", "start": 0.0, "end": 1.2,
         "kind": "fwd", "labels": {}},
        {"name": "sendF0.0", "device": "link:pp", "start": 1.2, "end": 1.8,
         "kind": "collective-permute", "labels": {}},
        {"name": "B0.0", "device": "stage0", "start": 1.8, "end": 4.0,
         "kind": "bwd", "labels": {}},
    ]


def _bogus(spans, ns):
    spans.append({"name": "mystery_op", "device": "stage0", "start": 4.0,
                  "end": 4.5, "kind": "fwd", "labels": {}})
    return (spans,), {}


def _unobserved(spans, ns):
    del spans[1]
    return (spans,), {}


def _class_error(spans, ns):
    spans[0]["end"] = spans[0]["start"] + 50.0
    return (spans, _graph(ns)), {}


def _class_loose(spans, ns):
    spans[0]["end"] = spans[0]["start"] + 50.0
    return (spans, _graph(ns)), {
        "class_tolerances": {ns.pricing.PROV_DB: 100.0}}


def _structural(spans, ns):
    spans.append({"name": "train_step0", "device": "host", "start": 0.0,
                  "end": 9.0, "kind": "train-step",
                  "labels": {"role": "step"}})
    return (spans,), {}


def _capped(spans, ns):
    for i in range(12):
        spans.append({"name": f"ghost{i}", "device": "host",
                      "start": 5.0 + i, "end": 5.5 + i, "kind": "x",
                      "labels": {}})
    return (spans,), {"top_k": 3}


def _recorder(spans, ns):
    rec = ns.record.Recorder(clock=FakeClock())
    rec.emit("F0.0", "stage0", 0.0, 1.1, kind="fwd")
    rec.emit("sendF0.0", "link:pp", 1.1, 1.6, kind="collective-permute")
    rec.emit("B0.0", "stage0", 1.6, 3.7, kind="bwd")
    return (rec,), {"measured_total_s": 4.0, "sim_total_s": 3.0}


_DIFF_CASES = {
    "clean": (lambda spans, ns: ((spans,), {}), ["O000"]),
    "o001_bogus_real_span": (_bogus, ["O000", "O001"]),
    "o002_unobserved_node": (_unobserved, ["O000", "O002"]),
    "o003_class_error": (_class_error, ["O000", "O003"]),
    "o003_loose_bound_silent": (_class_loose, ["O000"]),
    "structural_step_spans": (_structural, ["O000"]),
    "o001_capped": (_capped, ["O000"] + ["O001"] * 9),
    "recorder_input": (_recorder, ["O000"]),
}


@pytest.mark.parametrize("case", sorted(_DIFF_CASES))
def test_divergence_report_matches(case):
    build, codes = _DIFF_CASES[case]
    docs = []
    for ns in (JAX, PORT):
        (real, *graph), kw = build(_spans(), ns)
        rep = ns.obs.divergence_report(real, _sim(ns, _JOINED), *graph,
                                       **kw)
        docs.append(rep.to_dict())
    assert docs[1] == docs[0]
    assert sorted(f["code"] for f in docs[1]["findings"]) == codes


def test_divergence_report_reexported_from_analysis():
    assert PORT.analysis.divergence_report is PORT.obs.divergence_report


# -- overlay export --------------------------------------------------------

_OVERLAY_EVENTS = [
    (0, "F0.0", "fwd", "stage0", 0.0, 1.0),
    (1, "sendF0.0", "collective-permute", "link:pp", 1.0, 1.2),
    (2, "F1.0", "fwd", "stage1", 1.2, 2.2),
    (3, "B1.0", "bwd", "stage1", 2.2, 4.2),
    (4, "B0.0", "bwd", "stage0", 4.4, 6.4),
]


def _overlay_inputs(ns):
    rec = ns.record.Recorder(clock=FakeClock())
    rec.emit("F0.0", "stage0", 100.0, 101.1, kind="fwd")
    rec.emit("F1.0", "stage1", 101.3, 102.5, kind="fwd")
    rec.counter("live_slots", "chip", 2.0, t=100.5)
    return _sim(ns, _OVERLAY_EVENTS), rec


_OVERLAY_CASES = {
    "tracks": lambda ns, res, rec: ns.obs.overlay_chrome_trace(res, rec),
    "provenance_args": lambda ns, res, rec: ns.obs.overlay_chrome_trace(
        res, rec, graph=_graph(ns)),
    "real_only": lambda ns, res, rec: ns.obs.overlay_chrome_trace(None, rec),
    "sim_counters": lambda ns, res, rec: [
        (c.name, c.device, c.t, c.value)
        for c in ns.obs.derive_sim_counters(res)],
}


@pytest.mark.parametrize("case", sorted(_OVERLAY_CASES))
def test_overlay_matches(case, tmp_path):
    outs = [_OVERLAY_CASES[case](ns, *_overlay_inputs(ns))
            for ns in (JAX, PORT)]
    assert outs[1] == outs[0]
    if case == "tracks":
        path = str(tmp_path / "t.json")
        PORT.obs.overlay_chrome_trace(*_overlay_inputs(PORT), path)
        assert json.load(open(path)) == json.loads(json.dumps(outs[0]))


@pytest.mark.parametrize("schedule,vstages", [
    ("gpipe", 1), ("1f1b", 1), ("interleaved_1f1b", 2)])
def test_schedule_span_names_match_the_graph_and_jax(schedule, vstages):
    names = []
    for ns in (JAX, PORT):
        S = ns.strategy
        strat = S.Strategy(pp=4, microbatches=8, schedule=schedule,
                           vstages=vstages)
        g = S.pipeline_graph(8, S.LayerCost(fwd_flops=1e6, fwd_bytes=1e4,
                                            boundary_bytes=64), strat)
        spans = ns.pp.schedule_span_names(strat.make_pipeline_schedule())
        assert set(spans) == {(n.name, n.device) for n in g.nodes if n.kind
                              in ("fwd", "bwd", "collective-permute")}
        names.append(spans)
    assert names[1] == names[0]


# -- op replay on the logical-rank mesh ------------------------------------


def _smoke_plan(schedule="1f1b", vstages=1, microbatches=2,
                arch="llama3.2-1b"):
    import dataclasses

    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan

    cfg = smoke_variant(get_config(arch))
    if cfg.moe is not None:     # the graph prices EP dispatch a2a nodes
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl="ep_a2a"))
    plan = make_plan(cfg, 2, microbatches, schedule=schedule,
                     vstages=vstages)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    return cfg, plan, params


@pytest.mark.parametrize("schedule,vstages,compression,arch", [
    ("1f1b", 1, "none", "llama3.2-1b"), ("gpipe", 1, "int8", "llama3.2-1b"),
    ("interleaved_1f1b", 2, "none", "llama3.2-1b"),
    ("1f1b", 1, "none", "qwen3-moe-235b-a22b")])
def test_replay_measures_every_node_once_under_its_uid(schedule, vstages,
                                                       compression, arch):
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.dist import mesh as M
    from repro_torch.obs import Recorder, replay_pipeline_ops

    cfg, plan, params = _smoke_plan(schedule, vstages, arch=arch)
    mesh = M.make_mesh((2, 2), ("data", "stage"), "cpu")
    graph = model_pipeline_graph(
        cfg, plan.strategy(dp=2, compression=compression), 2, 16)
    rec = Recorder(enabled=True)
    M.reset_traffic()
    M.TRAFFIC["ppermute"] = 7
    counts = replay_pipeline_ops(rec, graph, cfg=cfg, plan=plan, mesh=mesh,
                                 params=params, micro_batch=2, seq=16,
                                 log_fn=lambda s: None)
    assert counts == {"measured": len(graph.nodes), "skipped": 0}
    spans = [(s.name, s.device, s.kind) for s in rec.spans]
    assert sorted(spans) == sorted((n.name, n.device, n.kind)
                                   for n in graph.nodes)
    assert all(s.end >= s.start for s in rec.spans)
    kinds = {"fwd", "bwd", "collective-permute", "all-reduce"}
    if cfg.moe is not None:     # the dispatch a2a over data's 2 ranks
        kinds.add("all-to-all")
    assert {n.kind for n in graph.nodes} == kinds
    assert M.TRAFFIC == {"ppermute": 7}       # the replay's own hops undone


def test_replay_raises_on_a_vocabulary_mismatch():
    from repro_torch.core.graph import DataflowGraph
    from repro_torch.dist import mesh as M
    from repro_torch.obs import Recorder, replay_pipeline_ops

    cfg, plan, params = _smoke_plan()
    with pytest.raises(AssertionError, match="span names"):
        replay_pipeline_ops(Recorder(), DataflowGraph("empty"), cfg=cfg,
                            plan=plan, params=params, micro_batch=1, seq=8,
                            mesh=M.make_mesh((1, 2), ("data", "stage"),
                                             "cpu"))


def test_replay_skips_links_a_one_rank_axis_lacks():
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.dist import mesh as M
    from repro_torch.obs import Recorder, replay_pipeline_ops

    cfg, plan, params = _smoke_plan()
    graph = model_pipeline_graph(cfg, plan.strategy(dp=2), 1, 8)
    logs = []
    counts = replay_pipeline_ops(
        Recorder(), graph, cfg=cfg, plan=plan, params=params, micro_batch=1,
        seq=8, mesh=M.make_mesh((1, 2), ("data", "stage"), "cpu"),
        log_fn=logs.append)
    n_ar = sum(n.kind == "all-reduce" for n in graph.nodes)
    assert n_ar and counts["skipped"] == n_ar
    assert counts["measured"] == len(graph.nodes) - n_ar
    assert logs and "O002" in logs[0]


# -- the launchers ---------------------------------------------------------


def test_train_launcher_obs_writes_report_and_overlay(tmp_path, capsys):
    from repro_torch.launch import train as launcher

    out = str(tmp_path / "train_overlay.json")
    got = {}
    cfg, _, _ = _smoke_plan()
    launcher.train(cfg, steps=2, seq=16, batch=8, ranks=4, pp=2,
                   microbatches=2, obs=True, trace_out=out, device="cpu",
                   on_obs=lambda r, c: got.update(report=r, counts=c))
    rep, counts = got["report"], got["counts"]
    assert counts["skipped"] == 0 and counts["measured"] > 0
    m = rep.metrics
    assert m["obs_unmatched_real"] == m["obs_unmatched_sim"] == 0.0
    assert m["obs_gap_attributed_frac"] == 1.0 and m["obs_step_mean_s"] > 0
    trace = json.load(open(out))
    assert any(e["ph"] == "X" for e in trace["traceEvents"])
    doc = json.load(open(str(tmp_path / "train_overlay_report.json")))
    assert doc["metrics"]["obs_joined_ops"] == counts["measured"]
    # through main(argv): the spec flags, the run spec in the report
    launcher.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                   "--steps", "1", "--seq", "16", "--batch", "8",
                   "--ranks", "4", "--pp", "2", "--microbatches", "2",
                   "--obs", "--trace-out", out])
    text = capsys.readouterr().out
    assert "[obs] train-obs:" in text and "overlay trace written" in text
    doc = json.load(open(str(tmp_path / "train_overlay_report.json")))
    assert doc["extras"]["run_spec"]["obs"] is True
    assert doc["extras"]["run_spec"]["pp"] == 2


def test_train_launcher_obs_without_pp_keeps_real_tracks(tmp_path, capsys):
    from repro_torch.launch import train as launcher

    out = str(tmp_path / "t.json")
    launcher.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                   "--steps", "2", "--seq", "16", "--batch", "2", "--obs",
                   "--trace-out", out])
    assert "no pipeline plan" in capsys.readouterr().out
    names = {e["name"] for e in json.load(open(out))["traceEvents"]
             if e["ph"] == "X"}
    assert names == {"train_step0", "train_step1"}
    assert not os.path.exists(str(tmp_path / "t_report.json"))


@pytest.mark.parametrize("shard", [False, True])
def test_serve_launcher_obs(tmp_path, capsys, shard):
    from repro_torch.launch import serve as launcher

    out = str(tmp_path / "serve_overlay.json")
    argv = ["--smoke", "--device", "cpu", "--trace", "bursty",
            "--requests", "6", "--burst-size", "3", "--burst-gap", "0.01",
            "--max-len", "64", "--chunk", "8", "--block-size", "8",
            "--obs", "--trace-out", out]
    if shard:
        argv += ["--shard", "--ranks", "2", "--synthetic-db"]
    assert launcher.main(argv) == 0
    text = capsys.readouterr().out
    assert "[obs] serve-obs:" in text
    doc = json.load(open(str(tmp_path / "serve_overlay_report.json")))
    m = doc["metrics"]
    assert m["obs_unmatched_real"] == m["obs_unmatched_sim"] == 0.0
    assert m["obs_joined_ops"] > 0 and m["obs_engine_step_s"] > 0
    assert doc["extras"]["run_spec"]["trace_out"] == out
    trace = json.load(open(out))
    labels = {e["args"]["name"] for e in trace["traceEvents"]
              if e["name"] == "process_name"}
    assert {"sim:chip", "real:chip", "real:host"} <= labels

"""Whole-plan analysis: one entry point per plan representation, composed.

``analyze_training_plan`` is the load-bearing path: given an arch config
and a :class:`repro_torch.core.strategy.Strategy` it verifies, in order,

1. the **schedule** — table legality via
   :func:`repro_torch.analysis.schedule_checks.lint_strategy` plus ppermute
   pairing over the compiled executor plan (what the real shard_map
   executor would deadlock on);
2. the **graph** — structure, placement, and accounting completeness of
   the DataflowGraph the simulator prices (with netprof provenance audit
   when the estimator carries a calibrated pricer);
3. the **timeline** — the DES run itself, audited for serialization /
   causality violations and the link-overlap divergence metric.

Each phase only runs when the previous one is clean: simulating a graph
with a known cycle just reproduces the stall the static pass already
named.  ``launch/train.py --analyze`` raises
:class:`repro_torch.analysis.PlanVerificationError` on any error-level finding;
``scripts/check.sh analyze`` sweeps every registered config.

A copy of the JAX package's ``analysis/analyzer.py`` with its imports
rewritten.  Its default estimator stays ``TPU_V5E``, so its reports equal
the reference's (``tests/test_torch_analysis.py``); the port's launchers
always pass their own (the card's platform, or ``CPU_HOST``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.diagnostics import Report, merge_reports
from repro_torch.analysis.graph_lints import lint_graph
from repro_torch.analysis.schedule_checks import lint_executor_plan, lint_strategy
from repro_torch.analysis.timeline_checks import audit_timeline


def _synthetic_moe_a2a(cfg, strategy, micro_batch: int, seq: int):
    """The ``moe_a2a`` annotation dict for a synthetic (config-derived)
    pipeline graph — mirrors ``model_pipeline_graph`` without importing the
    model layer, so the analyzer sweep stays cheap."""
    if cfg.moe is None or cfg.moe.impl != "ep_a2a":
        return None
    if strategy.ep <= 1 and strategy.dp <= 1:
        return None
    from repro_torch.core.strategy import moe_a2a_node_meta

    V = strategy.pp * strategy.vstages
    per = cfg.num_layers // V
    itemsize = 4 if str(cfg.compute_dtype) == "float32" else 2
    tokens_local = micro_batch * seq
    return {
        "meta": moe_a2a_node_meta(
            cfg.moe, tokens_local, cfg.d_model, itemsize=itemsize
        ),
        "comm_bytes": float(tokens_local * cfg.d_model * itemsize),
        "group_size": strategy.ep if strategy.ep > 1 else strategy.dp,
        "layers_per_vstage": [
            sum(
                1
                for i in range(k * per, (k + 1) * per)
                if i % cfg.moe.every_k == cfg.moe.offset
            )
            for k in range(V)
        ],
    }


def analyze_graph(graph, estimator=None, result=None, name=None) -> Report:
    """Graph lints plus, when a simulated ``result`` is supplied, the
    timeline audit."""
    report = lint_graph(graph, estimator=estimator, name=name)
    if result is not None:
        report.extend(audit_timeline(result, graph, name=report.name))
    return report


def analyze_training_plan(
    cfg,
    strategy,
    *,
    micro_batch: int,
    seq: int,
    estimator=None,
    run_sim: bool = True,
    use_model_graph: bool = False,
    name: Optional[str] = None,
) -> Report:
    """Statically verify one (config, strategy) training plan end to end.

    ``use_model_graph=True`` lints the model-derived partition graph
    (``repro_torch.core.strategy.model_pipeline_graph`` — the launcher's case,
    exact per-stage gradient trees and ppermute payload annotations);
    the default synthetic graph covers the same schedule and collective
    classes from the analytic cost model alone, which is what the CI
    sweep over every registered config uses.
    """
    report = Report(
        name or f"plan:{cfg.name}:{strategy.describe()}"
    )
    report.extend(lint_strategy(strategy, cfg.num_layers, name=report.name))
    if not report.ok:
        return report

    from repro_torch.dist.schedules import build_executor_plan

    schedule = strategy.make_pipeline_schedule()
    report.extend(
        lint_executor_plan(build_executor_plan(schedule), name=report.name)
    )
    if not report.ok:
        return report

    if use_model_graph:
        from repro_torch.core.strategy import model_pipeline_graph

        graph = model_pipeline_graph(cfg, strategy, micro_batch, seq)
    else:
        from repro_torch.core.autotuner import layer_cost_from_config
        from repro_torch.core.strategy import pipeline_graph

        cost = layer_cost_from_config(cfg, micro_batch, seq, strategy.tp)
        graph = pipeline_graph(
            cfg.num_layers, cost, strategy,
            moe_a2a=_synthetic_moe_a2a(cfg, strategy, micro_batch, seq),
        )
    report.extend(lint_graph(graph, estimator=estimator, name=report.name))
    if not report.ok:
        return report

    pricer = getattr(estimator, "collective_pricer", None)
    if pricer is not None:
        from repro_torch.analysis.coverage import audit_collective_coverage

        cov = audit_collective_coverage(
            graph, pricer,
            comm_bytes_fn=getattr(estimator, "comm_bytes_fn", None),
            name=report.name,
        )
        report.extend(cov.report)
        report.extras.setdefault("coverage", {})[report.name] = cov.to_dict()
        if not report.ok:
            return report

    if run_sim:
        from repro_torch.core.estimator import OpTimeEstimator
        from repro_torch.core.hardware import TPU_V5E
        from repro_torch.core.simulator import simulate

        est = estimator
        if est is None:
            est = OpTimeEstimator(TPU_V5E)
        # price WITH the fitted link-contention model whenever the
        # estimator carries one (netprof DB with a concurrent sweep), and
        # tell the auditor a model was available: a timeline with T010
        # overlap priced without an available model is a T011 warning
        cm = getattr(est, "contention_model", None)
        res = simulate(graph, est.duration, record_events=True, contention=cm)
        report.extend(audit_timeline(
            res, graph, name=report.name,
            contention_available=cm is not None,
        ))
        report.metrics["sim_makespan_s"] = res.makespan
        if res.contention is not None:
            report.metrics["sim_contention_applied"] = 1.0
    return report


def analyze_all_configs(
    *,
    pp: int = 4,
    microbatches: int = 8,
    schedules=(("1f1b", 1), ("gpipe", 1), ("interleaved_1f1b", 2)),
    micro_batch: int = 1,
    seq: int = 512,
    estimator=None,
    run_sim: bool = True,
    log_fn=None,
    serve_trace=None,
    serve_cfg=None,
) -> Report:
    """The CI sweep: every registered arch config through every schedule
    family its layer count can realize.  When a config cannot realize the
    requested ``pp`` (prime layer counts exist in the registry), the sweep
    degrades to the largest compatible stage count rather than skipping
    the config — every config gets analyzed; only schedule families that
    NO stage count can realize (e.g. interleaving an odd layer count) are
    reported as skipped."""
    from repro_torch.configs.base import get_config, list_archs
    from repro_torch.core.strategy import Strategy

    def usable_pp(n_layers: int, sched: str, v: int):
        for p in range(pp, 0, -1):
            if n_layers % (p * v) == 0 and (
                sched != "interleaved_1f1b" or microbatches % p == 0
            ):
                return p
        return None

    reports = []
    skipped = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sched, v in schedules:
            p = usable_pp(cfg.num_layers, sched, v)
            if p is None:
                skipped.append(f"{arch}:{sched}v{v}")
                continue
            strat = Strategy(
                pp=p, microbatches=microbatches, schedule=sched, vstages=v
            )
            r = analyze_training_plan(
                cfg, strat, micro_batch=micro_batch, seq=seq,
                estimator=estimator, run_sim=run_sim,
            )
            if log_fn is not None:
                c = r.counts()
                log_fn(
                    f"[analyze] {r.name}: {c['error']} errors, "
                    f"{c['warning']} warnings"
                )
            reports.append(r)
    merged = merge_reports("all-configs", reports)
    merged.metrics["plans_analyzed"] = float(len(reports))
    merged.metrics["plans_skipped_shape"] = float(len(skipped))
    if log_fn is not None and skipped:
        log_fn(
            f"[analyze] skipped (no stage count realizes the shape): "
            f"{', '.join(skipped)}"
        )
    if serve_trace is not None:
        merged.extend(
            analyze_serve_sweep(serve_trace, serve_cfg, log_fn=log_fn)
        )
    return merged


# -- serve plans ----------------------------------------------------------------

# the sweep's serving shape: mirrors benchmarks/bench_sim_accuracy.serve_rows
# (slots small enough that the acceptance trace exercises head-of-line
# blocking, chunk 8 so prompts split into multiple pow2 buckets)
SWEEP_SERVE_CFG = dict(slots=2, max_len=64, block_size=8, chunk=8)


def analyze_serve_trace(
    trace,
    arch: str,
    scfg,
    *,
    db=None,
    platform: str = "cpu_host",
    db_path: str = "<db.json>",
    name: Optional[str] = None,
) -> Report:
    """Statically verify one serve plan: resource ledger + DB coverage.

    Runs the R-code sanitizer (``repro_torch.analysis.serve_checks``) over the
    trace's scheduler replay, then — when a ProfileDB is supplied — the
    A005+ coverage audit (``repro_torch.analysis.coverage``) over the exact
    query set the priced simulation would issue.  The coverage document
    lands in ``report.extras["coverage"][arch]``.
    """
    from repro_torch.analysis.serve_checks import audit_serve_plan

    report = audit_serve_plan(trace, scfg, name=name or f"serve:{arch}")
    if db is not None and report.ok:
        from repro_torch.analysis.coverage import audit_serve_coverage

        cov = audit_serve_coverage(
            trace, arch, scfg, db, platform,
            db_path=db_path, name=report.name,
        )
        report.extend(cov.report)
        report.extras.setdefault("coverage", {})[arch] = cov.to_dict()
    return report


def analyze_serve_sweep(
    trace,
    serve_cfg=None,
    *,
    archs=None,
    log_fn=None,
) -> Report:
    """Serve half of the CI sweep: one ledger check for the trace, plus a
    per-arch coverage audit against that arch's synthetic serve grid (the
    same deterministic grid the serve determinism/bench gates price from,
    so a fully-covered trace classifies 100% exact)."""
    from repro_torch.configs.base import list_archs
    from repro_torch.core.database import ProfileDB
    from repro_torch.serve.cost import synthetic_serve_calibration
    from repro_torch.serve.policy import ServeConfig

    scfg = serve_cfg or ServeConfig(**SWEEP_SERVE_CFG)
    reports = []
    for arch in archs or list_archs():
        db = ProfileDB()
        synthetic_serve_calibration(
            db, arch, "cpu_host", views=(scfg.view_len,),
            slot_grid=(1, 2, scfg.slots, 2 * scfg.slots),
        )
        r = analyze_serve_trace(trace, arch, scfg, db=db)
        if log_fn is not None:
            c = r.counts()
            log_fn(
                f"[analyze] {r.name}: {c['error']} errors, "
                f"{c['warning']} warnings"
            )
        reports.append(r)
    merged = merge_reports("serve-sweep", reports)
    merged.metrics["serve_plans_analyzed"] = float(len(reports))
    return merged

"""repro_torch.analysis — static plan verification and sim-lint.

The paper's pitch is evaluating plans *without* running them; this package
closes the loop by proving a plan well-formed, deadlock-free, and fully
priced before a single simulated or real second is spent.  Three plan
representations, three lint families, one diagnostics engine:

* :mod:`repro_torch.analysis.graph_lints` — DataflowGraph structure, device
  placement, and accounting completeness (G*/A* codes);
* :mod:`repro_torch.analysis.schedule_checks` — step-table legality, deadlock
  detection with the stuck wait chain named, ppermute send/recv pairing
  over the compiled executor plan (S* codes);
* :mod:`repro_torch.analysis.timeline_checks` — DES serialization/causality
  invariants and the link-overlap divergence audit (T* codes);
* :mod:`repro_torch.analysis.serve_checks` — symbolic replay of the serve
  scheduler's KV-block ledger over a request trace (R* codes);
* :mod:`repro_torch.analysis.coverage` — ProfileDB coverage audit: classifies
  every pricing query a plan will issue as exact / interpolation /
  extrapolation / fallback before anything runs, and emits the minimal
  calibration grid that would close the gaps (A005+ codes).

One runtime family lives outside this package: :mod:`repro_torch.obs.diff`
joins *real* recorded spans to simulated intervals and reports through
the same engine (O* codes); its :func:`~repro_torch.obs.diff.divergence_report`
is re-exported here for symmetry.

Load-bearing consumers: ``launch/train.py --analyze`` (raises
:class:`PlanVerificationError` before executing a bad plan),
``launch/serve.py --analyze`` / ``--analyze-plan``, ``core/autotuner.py``
(prunes statically-illegal candidates before simulating), and
``python -m repro_torch.analysis`` (the sweep over every registered
config).  Every module is a copy of the JAX package's with its imports
rewritten; ``tests/test_torch_analysis.py`` holds their reports equal.
"""
from repro_torch.analysis.analyzer import (  # noqa: F401
    analyze_all_configs,
    analyze_graph,
    analyze_serve_sweep,
    analyze_serve_trace,
    analyze_training_plan,
)
from repro_torch.analysis.coverage import (  # noqa: F401
    CoverageResult,
    PricingQuery,
    audit_collective_coverage,
    audit_serve_coverage,
    classify_collective_query,
    classify_serve_query,
    enumerate_collective_queries,
    enumerate_serve_queries,
)
from repro_torch.analysis.diagnostics import (  # noqa: F401
    DIAGNOSTIC_CODES,
    Diagnostic,
    PlanVerificationError,
    Report,
    merge_reports,
)
from repro_torch.analysis.graph_lints import (  # noqa: F401
    cycle_names,
    find_cycle,
    lint_graph,
    unsimulated_summary,
)
from repro_torch.analysis.schedule_checks import (  # noqa: F401
    lint_executor_plan,
    lint_schedule,
    lint_strategy,
)
from repro_torch.analysis.serve_checks import (  # noqa: F401
    ServePlan,
    audit_serve_plan,
    check_serve_plan,
    extract_serve_plan,
    lint_serve_trace,
)
from repro_torch.analysis.timeline_checks import (  # noqa: F401
    audit_serve_timeline,
    audit_timeline,
    link_contention,
)


def __getattr__(name: str):
    # lazy: repro_torch.obs.diff imports this package's diagnostics engine, so a
    # module-level import here would be circular whenever repro_torch.obs loads
    # first
    if name == "divergence_report":
        from repro_torch.obs.diff import divergence_report

        return divergence_report
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )

"""Divergence attributor: join real spans to simulated intervals by uid.

The join key is the node name itself — the recorder's span vocabulary IS
the simulator's uid vocabulary, so ``F1.3`` measured on the real mesh
lines up with the ``F1.3`` the DES priced, with no translation table.
The output is a :class:`repro_torch.analysis.Report` (the launchers print and
serialize it next to the overlay trace):

* per-op rows — real vs simulated seconds, absolute and relative error,
  ranked; the top-k gap contributors land in
  ``report.extras["obs_diff"]["top"]``;
* per-provenance-class aggregates — the estimator stamps every priced
  collective/serve node with ``time_provenance`` (``measured-db`` /
  ``measured-fit`` / ``ring`` / ``analytic``; see repro_torch.pricing), so sim
  error decomposes by *pricing source*: a host whose measured-db class is
  accurate but whose analytic class is 40x off needs calibration, not a
  better simulator;
* the O diagnostic family —

  - **O001** a real span carries a node uid the simulation never priced
    (the twin vocabularies drifted, or the real executor ran extra work);
  - **O002** a simulated node was never observed on the real side (the
    replay/engine skipped it — sim coverage is untested there);
  - **O003** a provenance class whose aggregate relative error exceeds
    its tolerance (default: only the *calibrated* classes are held to a
    bound — an uncalibrated host's analytic roofline is expected to be
    off, and flagging it would make every un-measured launch red).

Spans whose ``role`` label is in ``STRUCTURAL_ROLES`` (the per-step
``train_step{i}`` / ``step{i}`` wrappers) are structural: their total is
reported as the ``obs_step_total_s`` metric but they are never joined, so
they can't fire O001 and never enter the attributed gap.

A copy of the JAX package's ``obs/diff.py`` with its imports rewritten
(``tests/test_torch_obs.py``).
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Union

from repro_torch.analysis.diagnostics import Report
from repro_torch.pricing import PROV_ANALYTIC, PROV_DB, PROV_FIT

# real spans that wrap whole steps rather than individual ops
STRUCTURAL_ROLES = frozenset({"step"})

# default per-provenance-class relative-error tolerances: only classes
# priced from this host's measurements are bounded — see module docstring
DEFAULT_CLASS_TOLERANCES: dict[str, float] = {
    PROV_DB: 1.0,
    PROV_FIT: 2.0,
}

_EPS = 1e-12

# cap per-finding emission so a fully-divergent run stays readable; the
# full counts are always in the metrics
_MAX_FINDINGS_PER_CODE = 8


def _as_span_dicts(real: Union["object", Iterable[dict]]) -> list[dict]:
    """Accept a Recorder or an iterable of span dicts."""
    to_events = getattr(real, "to_events", None)
    if callable(to_events):
        return list(to_events())
    return [dict(s) for s in real]


def _sim_durations(sim_result) -> dict[str, float]:
    out: dict[str, float] = {}
    for e in sim_result.events:
        out[e.name] = out.get(e.name, 0.0) + (e.end - e.start)
    return out


def _provenance_by_name(graph) -> dict[str, str]:
    if graph is None:
        return {}
    return {
        n.name: str(n.meta.get("time_provenance") or PROV_ANALYTIC)
        for n in graph.nodes
    }


def divergence_report(
    real: Union["object", Iterable[dict]],
    sim_result,
    graph=None,
    *,
    name: str = "obs-diff",
    top_k: int = 10,
    class_tolerances: Optional[dict[str, float]] = None,
    measured_total_s: Optional[float] = None,
    sim_total_s: Optional[float] = None,
) -> Report:
    """Attribute the sim-vs-real step-time gap to named node uids.

    ``real`` is a :class:`repro_torch.obs.record.Recorder` or a list of span
    dicts; ``sim_result`` a :class:`repro_torch.core.simulator.SimResult` (or
    anything with ``.events``); ``graph`` the priced DataflowGraph whose
    node meta carries the provenance stamps.

    ``measured_total_s`` / ``sim_total_s`` define the gap being
    attributed.  Defaults: the summed real *op* spans and the summed
    simulated op durations — the two sides of the per-op join — so the
    attributed fraction measures *coverage*: it is 1.0 exactly when every
    second of the gap lives in a joined named op, and is eaten into by
    O001 spans (real seconds with no sim twin) and O002 nodes (sim
    seconds never observed).  Whole-step ``role="step"`` structural spans
    are never part of the gap (they include executor dispatch overhead no
    named op can own); their total is reported separately as the
    ``obs_step_total_s`` metric.
    """
    tol = (DEFAULT_CLASS_TOLERANCES if class_tolerances is None
           else class_tolerances)
    report = Report(name)
    spans = _as_span_dicts(real)
    sim_by_name = _sim_durations(sim_result) if sim_result is not None else {}
    prov_by_name = _provenance_by_name(graph)

    step_spans = []
    op_real: dict[str, dict[str, Any]] = {}
    for s in spans:
        labels = s.get("labels") or {}
        if labels.get("role") in STRUCTURAL_ROLES:
            step_spans.append(s)
            continue
        agg = op_real.setdefault(
            s["name"],
            {"real_s": 0.0, "count": 0, "device": s.get("device", ""),
             "kind": s.get("kind", "")},
        )
        agg["real_s"] += s["end"] - s["start"]
        agg["count"] += 1

    # -- per-op rows and O001/O002 -------------------------------------------
    rows: list[dict[str, Any]] = []
    unmatched_real = sorted(set(op_real) - set(sim_by_name))
    unmatched_sim = sorted(set(sim_by_name) - set(op_real))
    for nm in sorted(set(op_real) & set(sim_by_name)):
        real_s = op_real[nm]["real_s"]
        sim_s = sim_by_name[nm]
        rows.append({
            "name": nm,
            "device": op_real[nm]["device"],
            "kind": op_real[nm]["kind"],
            "provenance": prov_by_name.get(nm, PROV_ANALYTIC),
            "real_s": real_s,
            "sim_s": sim_s,
            "abs_err_s": real_s - sim_s,
            "rel_err": abs(real_s - sim_s) / max(sim_s, _EPS),
            "count": op_real[nm]["count"],
        })
    for nm in unmatched_real[:_MAX_FINDINGS_PER_CODE]:
        report.warning(
            "O001",
            f"real span {nm!r} ({op_real[nm]['real_s'] * 1e3:.3f}ms) has "
            f"no simulated twin",
            node=nm, device=op_real[nm]["device"],
        )
    if len(unmatched_real) > _MAX_FINDINGS_PER_CODE:
        report.warning(
            "O001",
            f"... and {len(unmatched_real) - _MAX_FINDINGS_PER_CODE} more "
            f"real spans without simulated twins",
        )
    for nm in unmatched_sim[:_MAX_FINDINGS_PER_CODE]:
        report.warning(
            "O002",
            f"simulated node {nm!r} ({sim_by_name[nm] * 1e3:.3f}ms priced) "
            f"was never observed on the real side",
            node=nm,
        )
    if len(unmatched_sim) > _MAX_FINDINGS_PER_CODE:
        report.warning(
            "O002",
            f"... and {len(unmatched_sim) - _MAX_FINDINGS_PER_CODE} more "
            f"simulated nodes never observed",
        )

    # -- per-provenance-class aggregates and O003 -----------------------------
    classes: dict[str, dict[str, float]] = {}
    for r in rows:
        c = classes.setdefault(
            r["provenance"], {"real_s": 0.0, "sim_s": 0.0, "ops": 0.0}
        )
        c["real_s"] += r["real_s"]
        c["sim_s"] += r["sim_s"]
        c["ops"] += 1
    for cls in sorted(classes):
        c = classes[cls]
        c["abs_err_s"] = c["real_s"] - c["sim_s"]
        c["rel_err"] = abs(c["abs_err_s"]) / max(c["sim_s"], _EPS)
        bound = tol.get(cls)
        if bound is not None and c["rel_err"] > bound:
            report.warning(
                "O003",
                f"provenance class {cls!r}: aggregate relative error "
                f"{c['rel_err']:.2f} exceeds tolerance {bound:.2f} "
                f"(real {c['real_s'] * 1e3:.3f}ms vs sim "
                f"{c['sim_s'] * 1e3:.3f}ms over {int(c['ops'])} ops)",
                provenance=cls,
            )

    # -- gap attribution -------------------------------------------------------
    if measured_total_s is None:
        measured_total_s = sum(v["real_s"] for v in op_real.values())
    if sim_total_s is None:
        sim_total_s = sum(sim_by_name.values())
    gap = measured_total_s - sim_total_s
    attributed = sum(r["abs_err_s"] for r in rows)
    if abs(gap) <= _EPS:
        frac = 1.0
    else:
        # same-sign contribution, saturating at 1: "the named ops account
        # for at least the whole gap"
        frac = max(0.0, min(attributed / gap, 1.0))
    rows.sort(key=lambda r: (-abs(r["abs_err_s"]), r["name"]))

    report.metrics["obs_step_total_s"] = float(
        sum(s["end"] - s["start"] for s in step_spans)
    )
    report.metrics["obs_measured_s"] = float(measured_total_s)
    report.metrics["obs_sim_s"] = float(sim_total_s)
    report.metrics["obs_gap_s"] = float(gap)
    report.metrics["obs_gap_attributed_frac"] = float(frac)
    report.metrics["obs_real_spans"] = float(len(op_real))
    report.metrics["obs_sim_nodes"] = float(len(sim_by_name))
    report.metrics["obs_joined_ops"] = float(len(rows))
    report.metrics["obs_unmatched_real"] = float(len(unmatched_real))
    report.metrics["obs_unmatched_sim"] = float(len(unmatched_sim))
    report.extras["obs_diff"] = {
        "rows": rows,
        "top": rows[:top_k],
        "classes": classes,
        "tolerances": {k: v for k, v in sorted(tol.items())},
    }
    if rows:
        worst = rows[0]
        report.info(
            "O000",
            f"attributed {frac * 100:.1f}% of the "
            f"{gap * 1e3:+.3f}ms step-time gap to {len(rows)} named ops; "
            f"top contributor {worst['name']!r} "
            f"({worst['abs_err_s'] * 1e3:+.3f}ms, "
            f"priced {worst['provenance']})",
        )
    return report

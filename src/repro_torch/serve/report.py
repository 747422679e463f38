"""Shared latency reporting + the engine-vs-twin serve parity report.

Both sides of the serving pair reduce their per-request records through
ONE :func:`latency_report` (nearest-rank percentiles — deterministic, no
interpolation float fuzz, so "bit-identical report" is a meaningful
determinism gate).  :func:`serve_parity_report` is the serve edition of
the house parity convention: it compares the engine's executed step
compositions against the scheduler-twin replay step for step, and the
measured latency percentiles against the priced simulation within a
tolerance.
"""
from __future__ import annotations

import json
from typing import Optional


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — deterministic."""
    if not values:
        return 0.0
    vs = sorted(values)
    rank = max(1, -(-int(len(vs) * q) // 100))  # ceil(n*q/100), >= 1
    return float(vs[min(rank, len(vs)) - 1])


def latency_report(records: list[dict], makespan_s: float) -> dict:
    """Percentile report from per-request records.

    Each record: ``{"rid", "arrival_s", "ttft_s", "token_gaps_s": [...],
    "e2e_s", "n_tokens"}`` — produced by ``records_from_requests`` (engine)
    or ``repro_torch.serve.sim`` (twin).  Goodput counts completed-request tokens
    over the span from first arrival to last completion.
    """
    ttft = [r["ttft_s"] for r in records if r["ttft_s"] is not None]
    gaps = [g for r in records for g in r["token_gaps_s"]]
    e2e = [r["e2e_s"] for r in records if r["e2e_s"] is not None]
    total_tokens = sum(r["n_tokens"] for r in records)
    return {
        "requests": len(records),
        "total_tokens": int(total_tokens),
        "makespan_s": float(makespan_s),
        "goodput_tok_per_s": (
            total_tokens / makespan_s if makespan_s > 0 else 0.0
        ),
        "ttft_p50_s": percentile(ttft, 50),
        "ttft_p99_s": percentile(ttft, 99),
        "per_token_p50_s": percentile(gaps, 50),
        "per_token_p99_s": percentile(gaps, 99),
        "e2e_p50_s": percentile(e2e, 50),
        "e2e_p99_s": percentile(e2e, 99),
    }


def records_from_requests(requests) -> list[dict]:
    """Latency records from finished engine :class:`Request` objects."""
    out = []
    for r in sorted(requests, key=lambda r: r.rid):
        times = list(r.token_times_s)
        gaps = [b - a for a, b in zip(times, times[1:])]
        out.append(
            {
                "rid": r.rid,
                "arrival_s": r.arrival_s,
                "ttft_s": r.ttft_s,
                "token_gaps_s": gaps,
                "e2e_s": r.e2e_s,
                "n_tokens": len(r.output),
            }
        )
    return out


def serve_parity_report(
    engine_steps: list[tuple],
    twin_steps: list[tuple],
    engine_latency: Optional[dict] = None,
    sim_latency: Optional[dict] = None,
    tol_rel: float = 0.5,
) -> dict:
    """Engine-vs-twin parity verdict.

    *Composition parity* (hard): the engine's executed step signatures must
    equal the scheduler twin's, step for step — shared policy code makes
    any mismatch a real divergence (an engine bypassing its scheduler, or
    state leaking between steps).  *Latency accuracy* (soft, priced sim vs
    measured engine): per-token p50/p99 relative error within ``tol_rel``.
    """
    mismatches = []
    for i, (a, b) in enumerate(zip(engine_steps, twin_steps)):
        if a != b:
            mismatches.append({"step": i, "engine": list(a), "twin": list(b)})
            if len(mismatches) >= 8:
                break
    report: dict = {
        "engine_steps": len(engine_steps),
        "twin_steps": len(twin_steps),
        "composition_mismatches": mismatches,
        "composition_ok": (
            not mismatches and len(engine_steps) == len(twin_steps)
        ),
    }
    if engine_latency is not None and sim_latency is not None:
        errs = {}
        for key in ("per_token_p50_s", "per_token_p99_s", "ttft_p50_s"):
            real = engine_latency[key]
            sim = sim_latency[key]
            errs[key] = abs(sim - real) / real if real > 0 else 0.0
        report["latency_rel_err"] = errs
        report["latency_tol_rel"] = tol_rel
        report["latency_ok"] = all(v <= tol_rel for v in errs.values())
        report["engine_latency"] = engine_latency
        report["sim_latency"] = sim_latency
    report["ok"] = report["composition_ok"] and report.get("latency_ok", True)
    return report


def render_parity(report: dict) -> str:
    lines = [
        f"serve parity: {'OK' if report['ok'] else 'FAIL'} "
        f"({report['engine_steps']} engine steps vs "
        f"{report['twin_steps']} twin steps)"
    ]
    for m in report["composition_mismatches"]:
        lines.append(f"  step {m['step']}: engine {m['engine']} "
                     f"!= twin {m['twin']}")
    for key, err in report.get("latency_rel_err", {}).items():
        lines.append(
            f"  {key}: sim {report['sim_latency'][key]:.6g}s vs engine "
            f"{report['engine_latency'][key]:.6g}s "
            f"({100 * err:.1f}% err, tol {100 * report['latency_tol_rel']:.0f}%)"
        )
    return "\n".join(lines)


def save_report(path: str, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")

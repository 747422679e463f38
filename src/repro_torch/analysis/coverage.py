"""ProfileDB coverage auditor: classify every pricing query before a run.

Dooly's (PAPERS.md) lesson is that simulation-driven search is only sound
when you know *which* configurations the offline profile grid actually
covers; everything else is model output, not measurement.  This pass makes
that knowledge static: given a training graph or a serve trace it
enumerates every (family, args) query the plan will push through
:class:`~repro_torch.netprof.pricing.CollectivePricer` /
:class:`~repro_torch.serve.cost.ServePricer`, classifies each against the
supplied DB **before anything runs**, and emits the minimal calibration
grid that would close the gaps.

Classes (mirroring the pricers' fallback chains exactly — the
classification-vs-provenance parity is asserted in
tests/test_serve_analysis.py):

=============  =========================  =============================
class          pricer behaviour           provenance stamp
=============  =========================  =============================
exact          DB point hit               ``measured-db``
interpolation  within the measured grid   ``measured-fit``
extrapolation  beyond the measured grid   ``measured-fit``
fallback       no measurements at all     ``analytic`` / ``ring``
=============  =========================  =============================

Diagnostics: A005 (error) a query will silently fall back despite the
supplied DB; A006 (warning) extrapolation; A007 (info) interpolation;
A008 (warning) a family's exact-hit ratio is below threshold; A009 (info)
the emitted calibration grid, consumable by ``scripts/calibrate_net.py``
(collectives) and ``launch/serve.py --calibrate`` / ``calibrate_serve``
(serve kernels).

The serve query set is statically enumerable because prefill chunking is
timing-independent — chunk widths are ``min(chunk, remaining)`` and the
jit bucket is :meth:`~repro_torch.serve.policy.ServeConfig.bucket` — and the
decode kernel always runs at the full static batch (``slots``).  Decode
*node counts* depend on batching dynamics, so coverage reasons about
distinct queries; counts are informational.

A copy of the JAX package's ``analysis/coverage.py`` with its imports
rewritten (``tests/test_torch_analysis.py``); the serve calibration command
it emits names the port's launcher, ``repro_torch.launch.serve``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.analysis.diagnostics import Report
from repro_torch.pricing import PROV_ANALYTIC, PROV_DB, PROV_FIT, PROV_RING
from repro_torch.serve.policy import ServeConfig
from repro_torch.serve.trace import TraceRequest

CLASS_EXACT = "exact"
CLASS_INTERP = "interpolation"
CLASS_EXTRAP = "extrapolation"
CLASS_FALLBACK = "fallback"

# classification -> the time_provenance stamps the pricer may produce
# (the canonical tags from repro_torch.pricing — the classification-vs-stamp
# parity is what makes this audit sound)
CLASS_TO_PROVENANCE: dict[str, tuple[str, ...]] = {
    CLASS_EXACT: (PROV_DB,),
    CLASS_INTERP: (PROV_FIT,),
    CLASS_EXTRAP: (PROV_FIT,),
    CLASS_FALLBACK: (PROV_ANALYTIC, PROV_RING),
}


@dataclass(frozen=True)
class PricingQuery:
    """One distinct (family, args) the plan will price, with multiplicity."""

    family: str
    args: tuple[tuple[str, Any], ...]    # sorted items, hashable
    count: int

    @property
    def args_dict(self) -> dict[str, Any]:
        return dict(self.args)

    def describe(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.args)
        return f"{self.family}({inner})"


def _query(family: str, args: dict[str, Any], count: int) -> PricingQuery:
    return PricingQuery(
        family=family, args=tuple(sorted(args.items())), count=count
    )


@dataclass
class CoverageResult:
    """Report + machine-readable coverage document of one audit."""

    report: Report
    queries: list[dict] = field(default_factory=list)
    # family -> {"queries": n, "exact": n, ..., "exact_ratio": r}
    families: dict[str, dict[str, float]] = field(default_factory=dict)
    grid: list[dict] = field(default_factory=list)
    commands: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        """The coverage-report JSON schema (documented in docs/analysis.md)."""
        return {
            "name": self.report.name,
            "ok": self.report.ok,
            "queries": list(self.queries),
            "families": {k: dict(v) for k, v in self.families.items()},
            "calibration_grid": list(self.grid),
            "commands": list(self.commands),
        }


# -- serve queries ---------------------------------------------------------------


def enumerate_serve_queries(
    trace: list[TraceRequest],
    arch: str,
    scfg: ServeConfig,
) -> list[PricingQuery]:
    """Every distinct serve pricing query the trace will issue.

    Prefill: walk each prompt in ``chunk`` strides and bucket each chunk
    width exactly as the scheduler does — purely arithmetic, no scheduler
    state.  Decode: one distinct query at the full static batch whenever
    any request decodes past its prefill token (effective budget >= 2);
    its count is the total decode-token events, an upper bound on nodes.
    """
    from repro_torch.serve.cost import FAMILY_DECODE, FAMILY_PREFILL

    view = scfg.view_len
    buckets: dict[int, int] = {}
    decode_tokens = 0
    for r in trace:
        pos = 0
        while pos < r.prompt_len:
            w = min(scfg.chunk, r.prompt_len - pos)
            b = scfg.bucket(w)
            buckets[b] = buckets.get(b, 0) + 1
            pos += w
        eff = scfg.effective_max_tokens(r.prompt_len, r.max_new_tokens)
        decode_tokens += max(eff - 1, 0)
    out = [
        _query(FAMILY_PREFILL, {"arch": arch, "tokens": b, "view": view}, n)
        for b, n in sorted(buckets.items())
    ]
    if decode_tokens > 0:
        out.append(
            _query(FAMILY_DECODE,
                   {"arch": arch, "slots": scfg.slots, "view": view},
                   decode_tokens)
        )
    return out


def classify_serve_query(pricer, query: PricingQuery) -> str:
    """Mirror :meth:`repro_torch.serve.cost.ServePricer.price` stage for stage."""
    from repro_torch.serve.cost import _XKEY

    args = query.args_dict
    arch, view = str(args["arch"]), int(args["view"])
    x = int(args[_XKEY[query.family]])
    hit = pricer.db.lookup(
        pricer.platform, query.family,
        {"arch": arch, _XKEY[query.family]: x, "view": view},
    )
    if hit is not None and hit.mean_s > 0:
        return CLASS_EXACT
    views = pricer.curves.get((query.family, arch))
    if not views:
        return CLASS_FALLBACK
    lx = math.log(max(float(x), 1.0))

    def on_curve(v: int) -> bool:
        log_x, _ = views[v]
        return len(log_x) > 1 and log_x[0] <= lx <= log_x[-1]

    vkeys = sorted(views)
    if view in views:
        return CLASS_INTERP if on_curve(view) else CLASS_EXTRAP
    if view < vkeys[0] or view > vkeys[-1]:
        return CLASS_EXTRAP          # np.interp clamps to the edge view
    lo = max(v for v in vkeys if v < view)
    hi = min(v for v in vkeys if v > view)
    return (
        CLASS_INTERP if on_curve(lo) and on_curve(hi) else CLASS_EXTRAP
    )


# -- collective queries ----------------------------------------------------------


def enumerate_collective_queries(
    graph,
    comm_bytes_fn: Optional[Callable] = None,
) -> list[PricingQuery]:
    """Every distinct collective pricing query a graph will issue.

    Payload bytes are resolved through the same hook the estimator uses
    (``comm_bytes_fn``, default :func:`repro_torch.core.estimator.dist_comm_bytes`)
    so compressed gradients / MoE a2a / pp-hop annotations price-enumerate
    identically.  Unresolvable nodes are skipped — the A001 graph lint
    already names them.
    """
    if comm_bytes_fn is None:
        from repro_torch.core.estimator import dist_comm_bytes

        comm_bytes_fn = dist_comm_bytes
    acc: dict[tuple[str, int, int], int] = {}
    for node in graph.nodes:
        if not node.is_collective or node.group_size <= 1:
            continue
        try:
            nbytes = float(comm_bytes_fn(node))
        except Exception:
            continue
        key = (node.kind, int(round(nbytes)), int(node.group_size))
        acc[key] = acc.get(key, 0) + 1
    return [
        _query(kind, {"per_device_bytes": b, "devices": g}, n)
        for (kind, b, g), n in sorted(acc.items())
    ]


def classify_collective_query(pricer, query: PricingQuery) -> str:
    """Mirror :meth:`repro_torch.netprof.pricing.CollectivePricer._resolve`."""
    args = query.args_dict
    nbytes, group = float(args["per_device_bytes"]), int(args["devices"])
    if pricer.exact_hit(query.family, nbytes, group):
        return CLASS_EXACT
    model = pricer.models.get(query.family)
    if model is None:
        return CLASS_FALLBACK
    curve = model.curves.get(group)
    if curve is None:
        return CLASS_EXTRAP          # cross-group α–β recombination
    lb = math.log(max(nbytes, 1.0))
    return (
        CLASS_INTERP
        if len(curve.log_bytes) > 1
        and curve.log_bytes[0] <= lb <= curve.log_bytes[-1]
        else CLASS_EXTRAP
    )


# -- the audit -------------------------------------------------------------------


def _grade(
    result: CoverageResult,
    queries: list[PricingQuery],
    classify: Callable[[PricingQuery], str],
    *,
    exact_ratio_threshold: float,
) -> None:
    """Shared grading: findings, per-family ratios, coverage metrics."""
    report = result.report
    counts = {
        CLASS_EXACT: 0, CLASS_INTERP: 0, CLASS_EXTRAP: 0, CLASS_FALLBACK: 0,
    }
    fam_totals: dict[str, dict[str, float]] = {}
    for q in queries:
        cls = classify(q)
        counts[cls] += 1
        fam = fam_totals.setdefault(
            q.family,
            {"queries": 0.0, CLASS_EXACT: 0.0, CLASS_INTERP: 0.0,
             CLASS_EXTRAP: 0.0, CLASS_FALLBACK: 0.0},
        )
        fam["queries"] += 1
        fam[cls] += 1
        result.queries.append(
            {"family": q.family, "args": q.args_dict, "count": q.count,
             "class": cls}
        )
        where = dict(q.args_dict, family=q.family, count=q.count)
        if cls == CLASS_FALLBACK:
            report.error(
                "A005",
                f"{q.describe()} ({q.count}x) has no measurements in the "
                f"supplied DB — it will be priced analytically at run time",
                **where,
            )
            result.grid.append({"family": q.family, "args": q.args_dict})
        elif cls == CLASS_EXTRAP:
            report.warning(
                "A006",
                f"{q.describe()} ({q.count}x) extrapolates beyond the "
                f"measured grid",
                **where,
            )
            result.grid.append({"family": q.family, "args": q.args_dict})
        elif cls == CLASS_INTERP:
            report.info(
                "A007",
                f"{q.describe()} ({q.count}x) interpolates between "
                f"measured grid points",
                **where,
            )
            result.grid.append({"family": q.family, "args": q.args_dict})
    for fam, tot in sorted(fam_totals.items()):
        ratio = tot[CLASS_EXACT] / tot["queries"] if tot["queries"] else 1.0
        tot["exact_ratio"] = ratio
        result.families[fam] = tot
        report.metrics[f"coverage_{fam}_exact_ratio"] = ratio
        if ratio < exact_ratio_threshold:
            report.warning(
                "A008",
                f"family {fam}: {int(tot[CLASS_EXACT])} of "
                f"{int(tot['queries'])} queries are exact hits "
                f"(ratio {ratio:.2f} < threshold "
                f"{exact_ratio_threshold:.2f})",
                family=fam, exact_ratio=ratio,
            )
    report.metrics["coverage_queries"] = float(len(queries))
    for cls, n in counts.items():
        report.metrics[f"coverage_{cls}"] = float(n)


def audit_serve_coverage(
    trace: list[TraceRequest],
    arch: str,
    scfg: ServeConfig,
    db,
    platform: str = "cpu_host",
    *,
    db_path: str = "<db.json>",
    exact_ratio_threshold: float = 1.0,
    name: Optional[str] = None,
) -> CoverageResult:
    """Classify every serve query of a trace against a ProfileDB."""
    from repro_torch.serve.cost import ServePricer

    result = CoverageResult(Report(name or f"serve-coverage:{arch}"))
    pricer = ServePricer(db, platform)
    queries = enumerate_serve_queries(trace, arch, scfg)
    _grade(
        result, queries, lambda q: classify_serve_query(pricer, q),
        exact_ratio_threshold=exact_ratio_threshold,
    )
    if result.grid:
        cmd = (
            f"python -m repro_torch.launch.serve --arch {arch} --calibrate "
            f"--db {db_path} --slots {scfg.slots} --max-len {scfg.max_len} "
            f"--block-size {scfg.block_size} --chunk {scfg.chunk}"
        )
        result.commands.append(cmd)
        result.report.info(
            "A009",
            f"calibration grid: {len(result.grid)} missing serve "
            f"measurement(s); close the gaps with `{cmd}`",
            entries=len(result.grid), commands=list(result.commands),
        )
    return result


def audit_collective_coverage(
    graph,
    pricer,
    *,
    comm_bytes_fn: Optional[Callable] = None,
    db_path: str = "<db.json>",
    exact_ratio_threshold: float = 1.0,
    name: Optional[str] = None,
) -> CoverageResult:
    """Classify every collective query of a graph against a pricer's DB."""
    result = CoverageResult(Report(name or "collective-coverage"))
    queries = enumerate_collective_queries(graph, comm_bytes_fn)
    _grade(
        result, queries, lambda q: classify_collective_query(pricer, q),
        exact_ratio_threshold=exact_ratio_threshold,
    )
    if result.grid:
        by_kind: dict[str, list[int]] = {}
        groups: set[int] = set()
        for g in result.grid:
            by_kind.setdefault(g["family"], []).append(
                int(g["args"]["per_device_bytes"])
            )
            groups.add(int(g["args"]["devices"]))
        for kind, payloads in sorted(by_kind.items()):
            result.commands.append(
                f"python scripts/calibrate_net.py --db {db_path} "
                f"--collectives {kind} "
                f"--payloads {','.join(str(b) for b in sorted(set(payloads)))}"
            )
        result.report.info(
            "A009",
            f"calibration grid: {len(result.grid)} missing collective "
            f"measurement(s) over groups {sorted(groups)}; close the gaps "
            f"with scripts/calibrate_net.py (commands in the coverage "
            f"report)",
            entries=len(result.grid), commands=list(result.commands),
        )
    return result

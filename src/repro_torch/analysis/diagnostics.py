"""Diagnostics engine for the static plan verifier (repro_torch.analysis).

A :class:`Diagnostic` is one finding — a stable code, a severity, a human
message, and a ``where`` provenance dict (node uid/name, schedule step,
device, tick, ...).  A :class:`Report` collects the findings of one analyzed
plan plus free-form numeric ``metrics`` (bubble fractions, link-overlap
seconds), renders human summary lines, and serializes to a machine-readable
JSON document consumed by ``scripts/check.sh analyze`` and the launcher.

Codes are STABLE: tools (CI gates, the autotuner's pruner, tests) key on
them, so a code is never renumbered or reused — see docs/analysis.md for
the full table.  Prefixes: ``G`` graph lints, ``A`` accounting
completeness (including ProfileDB coverage, A005+), ``S`` schedule static
checks, ``T`` timeline (DES) audit, ``R`` serve-plan resource ledger,
``O`` observability / sim-vs-real divergence attribution
(:mod:`repro_torch.obs.diff`).

A copy of the JAX package's ``analysis/diagnostics.py``; the port uses
its :class:`Report` for the schedule checks.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)

# code -> one-line description.  Append-only; never renumber.
DIAGNOSTIC_CODES: dict[str, str] = {
    # -- graph lints (repro_torch.analysis.graph_lints) ---------------------------
    "G001": "duplicate node uid",
    "G002": "node uid does not match its position in the node list",
    "G003": "dangling dependency: dep uid not defined in the graph",
    "G004": "node depends on itself",
    "G005": "dependency cycle (offending cycle named)",
    "G006": "topological-order violation: dep uid >= node uid",
    "G010": "collective node placed on a non-link device",
    "G011": "compute node placed on a link device",
    "G012": "cross-device dependency without a transfer node",
    "G013": "group_size > 1 but no link_kind: node will be priced as compute",
    # -- accounting completeness -------------------------------------------
    "A001": "collective not resolvable by estimator.dist_comm_bytes",
    "A002": "collective resolves to zero payload bytes with group_size > 1",
    "A003": "collective silently ring-priced despite a supplied netprof DB",
    "A004": "priced serve node missing time_provenance",
    # -- ProfileDB coverage audit (repro_torch.analysis.coverage) -----------------
    "A005": "pricing query will fall back to analytic/ring despite a "
            "supplied ProfileDB (family/arch has no measurements)",
    "A006": "pricing query extrapolates beyond the measured grid",
    "A007": "pricing query interpolates between measured grid points",
    "A008": "per-family exact-hit coverage ratio below threshold",
    "A009": "calibration grid emitted: measuring it would close the gaps",
    # -- schedule static checks (repro_torch.analysis.schedule_checks) -----------
    "S001": "step scheduled on the wrong device for its virtual stage",
    "S002": "duplicate step in the table",
    "S003": "incomplete table: a (vstage, microbatch, phase) cell is missing",
    "S004": "step indices out of range (microbatch or vstage)",
    "S005": "schedule deadlock: greedy per-device execution wedges",
    "S006": "phase violation: bwd ordered before its fwd on one device",
    "S007": "unpaired ppermute: send with no matching receive",
    "S008": "ppermute receive conflict: orphaned or misrouted receive slot",
    "S009": "send scheduled after the final tick",
    "S010": "per-device bubble below the analytic fill/drain lower bound",
    "S011": "comm accounting twin mismatch (table vs executor plan)",
    "S012": "schedule not constructible for these dimensions",
    "S013": "layer count not divisible by the virtual-stage count",
    # -- timeline (DES) audit (repro_torch.analysis.timeline_checks) -------------
    "T001": "two events overlap on one serial device (DES invariant broken)",
    "T002": "causality violation: event starts before a dependency finishes",
    "T003": "event with negative, NaN, or infinite duration",
    "T004": "event extends beyond the reported makespan",
    "T010": "link streams concurrently busy (serialization-divergence audit)",
    "T011": "timeline priced without the available link-contention model "
            "despite nonzero link overlap (silent serialized pricing)",
    # -- serve-plan resource ledger (repro_torch.analysis.serve_checks) -----------
    "R001": "KV block leak: a block allocated to a request is never freed",
    "R002": "KV block double-free, or free of a block the request never "
            "owned",
    "R003": "block reservation violates the pool: worst-case live "
            "reservations exceed the usable pool, a block is double-booked, "
            "or an id is outside the pool range",
    "R004": "effective_max_tokens capacity cap violated: admitted budget or "
            "prompt exceeds what the KV cache can hold",
    "R005": "FIFO admission order broken: a request jumped an earlier "
            "arrival (or was admitted before it arrived)",
    "R006": "decode-slot exclusivity broken: a slot decoded twice, decoded "
            "while prefilling, or was used without an admitted request",
    "R007": "per-request token-count bounds broken: tokens emitted outside "
            "[1, effective_max_tokens] (EOS may finish early, never late)",
    # -- observability / divergence attribution (repro_torch.obs.diff) ------------
    "O000": "divergence attribution summary: fraction of the sim-vs-real "
            "step-time gap accounted for by named node uids",
    "O001": "real span carries a node uid the simulation never priced "
            "(span vocabulary drift, or the executor ran unmodeled work)",
    "O002": "simulated node never observed on the real side (replay or "
            "engine skipped it: sim coverage untested there)",
    "O003": "pricing provenance class aggregate relative error exceeds its "
            "tolerance (the calibration for that class is stale or wrong)",
}


class PlanVerificationError(RuntimeError):
    """Raised by :meth:`Report.raise_on_errors` when a plan has error-level
    findings.  Carries the report for machine consumption."""

    def __init__(self, report: "Report"):
        self.report = report
        errors = report.errors
        lines = [f"plan {report.name!r} failed static verification "
                 f"({len(errors)} error{'s' if len(errors) != 1 else ''}):"]
        lines += [f"  {d.code}: {d.message}" for d in errors[:8]]
        if len(errors) > 8:
            lines.append(f"  ... and {len(errors) - 8} more")
        super().__init__("\n".join(lines))


@dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str
    message: str
    # provenance: node uid/name, step, device, tick, ... — JSON-serializable
    where: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "code": self.code,
            "severity": self.severity,
            "description": DIAGNOSTIC_CODES.get(self.code, ""),
            "message": self.message,
            "where": dict(self.where),
        }


class Report:
    """Findings + metrics of one analyzed plan."""

    def __init__(self, name: str = "plan"):
        self.name = name
        self.findings: list[Diagnostic] = []
        self.metrics: dict[str, float] = {}
        # structured side-documents (e.g. the coverage report), serialized
        # under "extras" only when present so legacy reports are unchanged
        self.extras: dict[str, Any] = {}

    # -- construction --------------------------------------------------------

    def add(
        self, code: str, severity: str, message: str, **where: Any
    ) -> Diagnostic:
        if code not in DIAGNOSTIC_CODES:
            raise KeyError(f"unregistered diagnostic code {code!r}")
        if severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}")
        d = Diagnostic(code, severity, message, where)
        self.findings.append(d)
        return d

    def error(self, code: str, message: str, **where: Any) -> Diagnostic:
        return self.add(code, ERROR, message, **where)

    def warning(self, code: str, message: str, **where: Any) -> Diagnostic:
        return self.add(code, WARNING, message, **where)

    def info(self, code: str, message: str, **where: Any) -> Diagnostic:
        return self.add(code, INFO, message, **where)

    def extend(self, other: "Report") -> "Report":
        """Merge another report's findings, metrics, and extras into this
        one (dict-valued extras merge key-wise: per-arch coverage documents
        from a sweep must not clobber each other)."""
        self.findings.extend(other.findings)
        self.metrics.update(other.metrics)
        for key, val in other.extras.items():
            mine = self.extras.get(key)
            if isinstance(mine, dict) and isinstance(val, dict):
                mine.update(val)
            else:
                self.extras[key] = val
        return self

    # -- queries --------------------------------------------------------------

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.findings if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.findings if d.severity == WARNING]

    @property
    def infos(self) -> list[Diagnostic]:
        return [d for d in self.findings if d.severity == INFO]

    @property
    def ok(self) -> bool:
        """True when the plan has no error-level findings."""
        return not self.errors

    def codes(self) -> list[str]:
        return sorted({d.code for d in self.findings})

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.findings if d.code == code]

    def raise_on_errors(self) -> "Report":
        if not self.ok:
            raise PlanVerificationError(self)
        return self

    # -- rendering -------------------------------------------------------------

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in _SEVERITIES}
        for d in self.findings:
            out[d.severity] += 1
        return out

    def summary_lines(self, max_findings: int = 20) -> list[str]:
        c = self.counts()
        lines = [
            f"{self.name}: {c[ERROR]} errors, {c[WARNING]} warnings, "
            f"{c[INFO]} info"
        ]
        shown = sorted(
            self.findings, key=lambda d: (_SEVERITIES.index(d.severity),)
        )[:max_findings]
        lines += [f"  [{d.severity.upper()}] {d.code}: {d.message}"
                  for d in shown]
        if len(self.findings) > max_findings:
            lines.append(f"  ... {len(self.findings) - max_findings} more")
        for k in sorted(self.metrics):
            lines.append(f"  metric {k} = {self.metrics[k]:.6g}")
        return lines

    def to_dict(self) -> dict[str, Any]:
        doc = {
            "name": self.name,
            "ok": self.ok,
            "counts": self.counts(),
            "findings": [d.to_dict() for d in self.findings],
            "metrics": dict(self.metrics),
        }
        if self.extras:
            doc["extras"] = dict(self.extras)
        return doc

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        doc = json.dumps(self.to_dict(), indent=indent, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(doc + "\n")
        return doc


def merge_reports(name: str, reports: Iterable[Report]) -> Report:
    """One roll-up report (used by the all-configs CLI sweep)."""
    out = Report(name)
    for r in reports:
        out.extend(r)
    return out

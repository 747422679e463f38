"""The one pricing protocol every cost chain in the repo speaks.

Three pricers grew up separately — ``netprof.pricing.CollectivePricer``
(collectives: exact DB hit -> fitted model -> ring),
``serve.cost.ServePricer`` (serve steps: exact -> interpolated curve ->
analytic), and ``core.estimator.OpTimeEstimator``'s compute chain (DB ->
MLP -> roofline).  They already share the *shape* of the paper's fallback
chain; this module makes them share the API:

* **provenance constants** — ``PROV_DB`` .. ``PROV_ANALYTIC`` live here
  (``netprof.pricing`` re-exports them for back-compat), so the coverage
  auditor's class->provenance map and every ``time_provenance`` stamp
  come from one definition;
* **one signature** — ``price_query(PriceQuery) -> (seconds, provenance)``
  implemented by both measured pricers, so chain-level extensions (the
  link-contention model, future hierarchical-tier pricing) plug in once
  and both the training and serve paths inherit them;
* **one ledger** — :class:`Ledger` is the per-kind provenance tally that
  ``CollectivePricer.stats`` and serve pricing reports both are.

``repro_torch.analysis.coverage`` classifies queries against the same chain
stages; the parity between its classes and these provenance tags is
asserted in tests (``CLASS_TO_PROVENANCE``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable

# provenance tags, most-measured first — the canonical definitions
# (re-exported by repro_torch.netprof.pricing for existing call sites)
PROV_DB = "measured-db"       # exact measurement at the queried point
PROV_FIT = "measured-fit"     # fitted-model interpolation/extrapolation
PROV_RING = "ring"            # analytic spec-sheet collective fallback
PROV_NOOP = "noop"            # group <= 1: no collective happens
PROV_ANALYTIC = "analytic"    # roofline on node features (serve/compute)

# every tag a pricer may stamp, in decreasing order of measuredness
PROVENANCES = (PROV_DB, PROV_FIT, PROV_RING, PROV_ANALYTIC, PROV_NOOP)


@dataclass(frozen=True)
class PriceQuery:
    """One pricing question: a kind (collective family or serve family)
    plus kind-specific arguments, canonically ordered so queries hash and
    compare stably (the coverage auditor deduplicates on this)."""

    kind: str
    args: tuple[tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, kind: str, **args: Any) -> "PriceQuery":
        return cls(kind, tuple(sorted(args.items())))

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.args:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        return {"kind": self.kind, "args": dict(self.args)}


class Ledger:
    """Per-kind provenance tally.  ``stats[kind][provenance] -> count``;
    the dict itself is exposed (``CollectivePricer.stats`` is a Ledger's
    ``stats``) so existing reports and tests keep reading it directly."""

    def __init__(self, zero_provs: tuple[str, ...] = ()):
        # provenances pre-seeded to 0 for every kind that gets priced, so
        # report lines always show the full chain even at count 0
        self._zero = tuple(zero_provs)
        self.stats: dict[str, dict[str, int]] = {}

    def count(self, kind: str, prov: str) -> None:
        row = self.stats.setdefault(kind, {p: 0 for p in self._zero})
        row[prov] = row.get(prov, 0) + 1

    def total(self, prov: Optional[str] = None) -> int:
        return sum(
            n for row in self.stats.values()
            for p, n in row.items()
            if prov is None or p == prov
        )

    def report_lines(self) -> list[str]:
        lines = []
        for kind in sorted(self.stats):
            row = self.stats[kind]
            parts = " / ".join(
                f"{row[p]} {p.split('-')[-1]}" for p in sorted(
                    row, key=lambda p: PROVENANCES.index(p)
                    if p in PROVENANCES else len(PROVENANCES)
                )
            )
            lines.append(f"{kind}: {parts}")
        return lines


@runtime_checkable
class Pricer(Protocol):
    """What every measured pricing chain implements.

    ``price_query`` resolves one :class:`PriceQuery` to ``(seconds,
    provenance)`` and tallies the winning stage in ``ledger``; a pricer
    that cannot answer at all (no measurements, caller should fall back
    to its own analytic model) returns ``None`` instead.
    """

    ledger: Ledger

    def price_query(
        self, query: PriceQuery
    ) -> Optional[tuple[float, str]]: ...


@dataclass
class PricedValue:
    """A resolved query, for reports that carry the full triple."""

    query: PriceQuery
    seconds: float
    provenance: str
    meta: dict = field(default_factory=dict)

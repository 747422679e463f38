"""Collective pricing chain: exact DB hit -> fitted model -> ring fallback.

:class:`CollectivePricer` is the measured-time counterpart of the
estimator's compute fallback chain.  Every priced node gets a provenance
tag (written into ``node.meta["time_provenance"]`` by the estimator) so
timelines and launch reports can show *which* model produced each number —
the difference between "the simulator is self-consistent" and "the
simulator is accurate on this host".
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.database import ProfileDB
from repro_torch.core.hardware import LinkSpec, PlatformSpec, collective_time
from repro_torch.netprof.model import COLLECTIVES, CollectiveModel, fit_collective_models

# provenance tags: canonical definitions live in repro_torch.pricing (the unified
# Pricer protocol); re-exported here because this was their original home
# and most call sites import them from repro_torch.netprof.pricing
from repro_torch.pricing import (  # noqa: F401  (re-exports)
    PROV_ANALYTIC,
    PROV_DB,
    PROV_FIT,
    PROV_NOOP,
    PROV_RING,
    Ledger,
    PriceQuery,
)


class CollectivePricer:
    """Prices one platform's collectives from its ProfileDB measurements.

    Chain per node (unit-tested in tests/test_netprof.py):

      1. exact DB hit — a sweep entry at exactly (kind, payload bytes,
         group size); multiple matching entries (sub-axis vs flat mesh,
         different dtypes) are averaged;
      2. fitted :class:`CollectiveModel` — log-log interpolation within the
         measured grid, α–β extrapolation beyond it;
      3. ring model — kinds with no measurements at all.
    """

    def __init__(self, db: ProfileDB, platform: PlatformSpec):
        self.platform = platform
        self.models: dict[str, CollectiveModel] = fit_collective_models(
            db, platform.name
        )
        self._exact: dict[tuple[str, int, int], float] = {}
        acc: dict[tuple[str, int, int], list[float]] = {}
        for kind in COLLECTIVES:
            for e in db.entries(platform.name, kind):
                b = e.args.get("per_device_bytes")
                g = e.args.get("devices")
                if b and g and e.mean_s > 0.0:
                    acc.setdefault((kind, int(b), int(g)), []).append(
                        float(e.mean_s)
                    )
        self._exact = {k: float(np.mean(v)) for k, v in acc.items()}
        # per-kind provenance ledger (repro_torch.pricing.Ledger), filled as
        # nodes are priced; ``stats`` stays the raw dict existing reports
        # and tests read
        self.ledger = Ledger(zero_provs=(PROV_DB, PROV_FIT, PROV_RING))
        self.stats = self.ledger.stats

    # -- queries --------------------------------------------------------------

    def profiled_kinds(self) -> list[str]:
        return sorted(self.models)

    def exact_hit(self, kind: str, nbytes: float, group: int) -> bool:
        """True when (kind, payload, group) has an exact sweep entry — the
        same key :meth:`_resolve` consults, exposed for the static coverage
        auditor (``repro_torch.analysis.coverage``)."""
        return (kind, int(round(nbytes)), int(group)) in self._exact

    def price(
        self, kind: str, nbytes: float, group: int, link: LinkSpec
    ) -> tuple[float, str]:
        """(seconds, provenance tag) for one collective node."""
        if group <= 1:
            return 0.0, PROV_NOOP
        t, prov = self._resolve(kind, nbytes, group, link)
        self.ledger.count(kind, prov)
        return t, prov

    def price_query(self, query: PriceQuery) -> tuple[float, str]:
        """The unified :class:`repro_torch.pricing.Pricer` entry point.

        ``query.args``: ``nbytes`` (effective wire payload after the
        dist-layer annotations are resolved), ``group``, and optionally
        ``link_kind`` (default ``"ici"``) resolved against the pricer's
        platform.
        """
        link = self.platform.link_for(query.get("link_kind") or "ici")
        return self.price(
            query.kind,
            float(query.get("nbytes", 0.0)),
            int(query.get("group", 1)),
            link,
        )

    def _resolve(
        self, kind: str, nbytes: float, group: int, link: LinkSpec
    ) -> tuple[float, str]:
        hit = self._exact.get((kind, int(round(nbytes)), int(group)))
        if hit is not None:
            return hit, PROV_DB
        model = self.models.get(kind)
        if model is not None:
            return model.predict(nbytes, group), PROV_FIT
        return collective_time(kind, nbytes, group, link), PROV_RING

    def ring_fallbacks_for_profiled(self) -> int:
        """Ring-priced nodes of kinds that DO have measurements (must be 0:
        a fitted model never declines to predict)."""
        return sum(
            self.stats.get(kind, {}).get(PROV_RING, 0) for kind in self.models
        )

    def report_lines(self) -> list[str]:
        """Human provenance summary, one line per priced collective kind."""
        lines = []
        for kind in sorted(self.stats):
            s = self.stats[kind]
            lines.append(
                f"{kind}: {s[PROV_DB]} db / {s[PROV_FIT]} fit / "
                f"{s[PROV_RING]} ring"
            )
        unpriced = sorted(set(self.models) - set(self.stats))
        if unpriced:
            lines.append(f"profiled but unused: {', '.join(unpriced)}")
        return lines or ["no collective nodes priced"]


def graph_provenance(graph) -> dict[str, dict[str, int]]:
    """Per-kind provenance counts from node meta after a simulation.

    Estimators write ``node.meta["time_provenance"]`` as they price; this
    reads the annotated graph back — the timeline-side view of the same
    ledger :attr:`CollectivePricer.stats` keeps."""
    out: dict[str, dict[str, int]] = {}
    for n in graph.nodes:
        prov = n.meta.get("time_provenance")
        if prov is None or prov == PROV_NOOP:
            continue
        k = out.setdefault(n.kind, {})
        k[prov] = k.get(prov, 0) + 1
    return out


def netprof_meta(db: ProfileDB, platform: str) -> Optional[dict]:
    """The sweep's calibration stamp, or None if never calibrated."""
    meta = db.meta(platform).get("netprof")
    return dict(meta) if isinstance(meta, dict) else None

"""Fitted collective time models over measured ProfileDB sweeps.

One :class:`CollectiveModel` per (platform, collective kind).  Within a
measured group size the model is a piecewise log-log interpolation over the
measured payload grid (the grid is log-spaced, so straight lines in log-log
space track the latency->bandwidth knee well); outside the grid it extends
bandwidth-linearly from the boundary point using the group's fitted α–β
parameters.  For group sizes never measured it falls back to the α–β
structure itself: per-hop latency α/steps and inverse wire bandwidth are
interpolated across the measured groups and recombined through the ring
wire-byte factor — principled extrapolation, not a table miss.

The α–β decomposition is the classic postal model: ``t(B, g) = α(g) +
wire_bytes(kind, B, g) / bw`` with ``wire_bytes`` the same ring factors the
analytic fallback uses, so a fitted model degrades gracefully toward the
ring model as measurements thin out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.database import ProfileDB, ProfileEntry
from repro_torch.core.hardware import COLLECTIVE_KINDS, wire_bytes

# canonical sweep / model coverage (re-exported as repro_torch.netprof.COLLECTIVES)
COLLECTIVES = COLLECTIVE_KINDS


def latency_steps(kind: str, group: int) -> float:
    """Serialized link hops of one collective (the ring model's α factor)."""
    if group <= 1:
        return 0.0
    return 1.0 if kind == "collective-permute" else float(group - 1)


@dataclass(frozen=True)
class GroupCurve:
    """Measured payload->time curve for ONE (collective, group size)."""

    group: int
    log_bytes: np.ndarray      # sorted, distinct
    log_time: np.ndarray       # mean log-time per payload
    alpha: float               # fitted latency term (s)
    sec_per_wire_byte: float   # fitted inverse bandwidth (s/byte on the wire)

    @property
    def min_bytes(self) -> float:
        return float(math.exp(self.log_bytes[0]))

    @property
    def max_bytes(self) -> float:
        return float(math.exp(self.log_bytes[-1]))


def _fit_alpha_beta(
    kind: str, group: int, payload: np.ndarray, t: np.ndarray
) -> tuple[float, float]:
    """Least-squares ``t = α + w·c`` over wire bytes w; clamped physical."""
    w = np.asarray([wire_bytes(kind, b, group) for b in payload])
    if len(payload) == 1 or np.ptp(w) == 0.0:
        return 0.0, float(t[-1] / max(w[-1], 1.0))
    A = np.stack([np.ones_like(w), w], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha, c = float(coef[0]), float(coef[1])
    if c <= 0.0:
        # bandwidth term degenerate (flat curve): pure-latency regime
        alpha, c = float(t.mean()), float(t[-1] / max(w[-1], 1.0)) * 1e-3
    return max(alpha, 0.0), c


@dataclass
class CollectiveModel:
    """Measured time model for one collective kind on one platform."""

    platform: str
    kind: str
    curves: dict[int, GroupCurve]

    # -- fitting ------------------------------------------------------------

    @staticmethod
    def fit(
        platform: str, kind: str, entries: list[ProfileEntry]
    ) -> Optional["CollectiveModel"]:
        """Fit from ProfileDB entries carrying (per_device_bytes, devices).

        Entries from different sweep axes / dtypes at the same (payload,
        group) are averaged — the Dooly-style configuration-agnostic grid:
        a size-g sub-axis group of a 2-D mesh and a size-g flat mesh feed
        the same curve.
        """
        samples: dict[int, dict[int, list[float]]] = {}
        for e in entries:
            b = e.args.get("per_device_bytes")
            g = e.args.get("devices")
            if not b or not g or int(g) < 2 or e.mean_s <= 0.0:
                continue
            samples.setdefault(int(g), {}).setdefault(int(b), []).append(
                float(e.mean_s)
            )
        curves: dict[int, GroupCurve] = {}
        for g, by_bytes in sorted(samples.items()):
            payload = np.asarray(sorted(by_bytes), dtype=np.float64)
            t = np.asarray(
                [float(np.mean(by_bytes[int(b)])) for b in payload]
            )
            alpha, c = _fit_alpha_beta(kind, g, payload, t)
            curves[g] = GroupCurve(
                group=g,
                log_bytes=np.log(payload),
                log_time=np.log(np.maximum(t, 1e-12)),
                alpha=alpha,
                sec_per_wire_byte=c,
            )
        if not curves:
            return None
        return CollectiveModel(platform=platform, kind=kind, curves=curves)

    # -- prediction ----------------------------------------------------------

    @property
    def groups(self) -> list[int]:
        return sorted(self.curves)

    def predict(self, nbytes: float, group: int) -> float:
        """Measured-model time for ``nbytes`` per-device payload at ``group``."""
        if group <= 1:
            return 0.0
        curve = self.curves.get(int(group))
        if curve is not None:
            return self._predict_on_curve(curve, nbytes)
        return self._predict_cross_group(nbytes, int(group))

    def _predict_on_curve(self, curve: GroupCurve, nbytes: float) -> float:
        nbytes = max(float(nbytes), 1.0)
        lb = math.log(nbytes)
        if curve.log_bytes[0] <= lb <= curve.log_bytes[-1]:
            return float(
                math.exp(np.interp(lb, curve.log_bytes, curve.log_time))
            )
        # extend bandwidth-linearly from the nearer boundary point
        edge = 0 if lb < curve.log_bytes[0] else -1
        b_edge = math.exp(curve.log_bytes[edge])
        t_edge = math.exp(curve.log_time[edge])
        dw = wire_bytes(self.kind, nbytes, curve.group) - wire_bytes(
            self.kind, b_edge, curve.group
        )
        t = t_edge + dw * curve.sec_per_wire_byte
        return float(max(t, curve.alpha, 1e-12))

    def _predict_cross_group(self, nbytes: float, group: int) -> float:
        """α–β recombination for an unmeasured group size.

        Per-hop latency (α / steps) and inverse wire bandwidth are each
        interpolated over log(group) across the measured groups (clamped to
        the nearest endpoint outside the measured range), then recombined
        with the ring wire-byte factor of the *requested* group.
        """
        groups = self.groups
        logg = np.log([float(g) for g in groups])
        aps = np.asarray(
            [
                self.curves[g].alpha / max(latency_steps(self.kind, g), 1.0)
                for g in groups
            ]
        )
        spb = np.asarray([self.curves[g].sec_per_wire_byte for g in groups])
        lq = math.log(float(group))
        alpha = float(np.interp(lq, logg, aps)) * latency_steps(
            self.kind, group
        )
        c = float(np.interp(lq, logg, spb))
        t = alpha + wire_bytes(self.kind, float(nbytes), group) * c
        return float(max(t, 1e-12))


def fit_collective_models(
    db: ProfileDB, platform: str
) -> dict[str, CollectiveModel]:
    """One fitted model per collective kind with measurements in the DB."""
    out: dict[str, CollectiveModel] = {}
    for kind in COLLECTIVES:
        m = CollectiveModel.fit(platform, kind, db.entries(platform, kind))
        if m is not None:
            out[kind] = m
    return out


# ---------------------------------------------------------------------------
# Link contention: what concurrent collectives cost on a shared fabric
# ---------------------------------------------------------------------------

# ProfileDB family of the concurrent-collective sweep: entries keyed
# {"kind", "per_device_bytes", "devices", "streams"} where streams=1 is the
# solo baseline and streams=k the wall time with k collectives in flight
CONTENTION_FAMILY = "link-contention"


@dataclass(frozen=True)
class LinkContentionModel:
    """Fitted slowdown of collectives sharing one fabric.

    The DES serializes same-link collectives and runs distinct link
    streams fully in parallel; real hosts share the fabric, so ``k``
    concurrent collectives each slow down.  The model is the linear
    shared-channel law ``gamma(k) = 1 + c * (k - 1)``: each stream's
    progress rate drops to ``1/gamma(k)`` while ``k`` streams are active.
    ``c = 0`` is a perfectly parallel fabric (today's DES across links);
    ``c = 1`` is full serialization (``k`` streams take ``k``x as long —
    what a single shared channel gives you, and what a forced-CPU host
    measures).  ``c`` is fitted as the median of
    ``(t_k / t_1 - 1) / (k - 1)`` over the concurrent-sweep pairs.
    """

    platform: str
    c: float
    samples: int

    def gamma(self, streams: int) -> float:
        if streams <= 1:
            return 1.0
        return 1.0 + self.c * (streams - 1)

    def describe(self) -> str:
        return (
            f"link-contention[{self.platform}]: gamma(k)=1+{self.c:.3f}(k-1)"
            f" ({self.samples} pairs)"
        )


def fit_link_contention(
    db: ProfileDB, platform: str
) -> Optional[LinkContentionModel]:
    """Fit the contention factor from the concurrent-collective sweep.

    Returns None when the DB holds no ``link-contention`` entries — the
    simulator then keeps its classic fully-parallel link streams (and the
    T011 audit stays quiet: without measurements, serialization-divergence
    is an unknown, not a silent omission).
    """
    solo: dict[tuple, float] = {}
    conc: list[tuple[tuple, int, float]] = []
    for e in db.entries(platform, CONTENTION_FAMILY):
        key = (
            e.args.get("kind"),
            int(e.args.get("per_device_bytes", 0)),
            int(e.args.get("devices", 0)),
        )
        streams = int(e.args.get("streams", 1))
        if e.mean_s <= 0.0:
            continue
        if streams <= 1:
            solo[key] = float(e.mean_s)
        else:
            conc.append((key, streams, float(e.mean_s)))
    ratios = []
    for key, streams, t in conc:
        base = solo.get(key)
        if base is None or base <= 0.0:
            continue
        ratios.append(max((t / base - 1.0) / (streams - 1), 0.0))
    if not ratios:
        return None
    # clamp at full serialization: gamma(k) <= k keeps the contended DES
    # no more pessimistic than serializing the same intervals
    c = float(min(np.median(np.asarray(ratios)), 1.0))
    return LinkContentionModel(platform=platform, c=c, samples=len(ratios))

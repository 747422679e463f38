"""Interconnect sweep harness: microbenchmark collectives into the ProfileDB.

The torch counterpart of the JAX package's ``netprof/sweep.py``.  Runs each
collective kind over a configuration-agnostic (log-spaced payload x group
size x dtype x mesh axis) grid and records one
:class:`~repro_torch.core.database.ProfileEntry` per point under the
collective's op family, keyed ``{"per_device_bytes", "devices", "dtype",
"axis"}``: the reference's grid and keys exactly.

Group sizes come from the *mesh plans*: the full 1-D mesh, plus — when the
rank count factors — the sub-axis groups of the most balanced 2-D mesh
(named ``dp`` x ``pp``, the shapes the pipeline/data-parallel executors and
the ep_a2a expert dispatch actually run collectives over).  A sub-axis
sweep runs the collective in every group along one axis with the other
axis populated, exactly like a dp gradient all-reduce inside each pipeline
stage.

Payload semantics match ``repro_torch.core.hardware.collective_time``: the
recorded ``per_device_bytes`` is the per-device INPUT payload for
all-reduce / reduce-scatter / all-to-all / collective-permute and the
per-device OUTPUT payload for all-gather.

Where the port differs: the reference sweeps the visible XLA devices
(``jax.device_count()``); here the sweep runs over a mesh of ``ranks``
logical ranks (``repro_torch.dist.mesh``; default 4, the pp x dp and EP
meshes' size), each a ``shard_map`` body's collective made of the mesh's
copies.  On one card every rank shares it, so an entry prices a collective
among ranks that share a card (device-local copies), not an NVLink
collective; the DB's meta stamps ``backend``, the physical
``device_count`` and the logical ``ranks`` so nobody reads it as one.  A
timing synchronises the card around each sample
(``core.profiler.time_callable_samples``) and records the median.  Every
kind exists on the logical-rank mesh, so a failing collective raises: the
reference's skip of a failing point (``except Exception: return None``) has
no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.database import ProfileDB, ProfileEntry
from repro_torch.netprof.model import COLLECTIVES, CONTENTION_FAMILY, latency_steps

DEFAULT_PAYLOADS = tuple(2**p for p in range(12, 23, 2))  # 4 KiB .. 4 MiB
SMOKE_PAYLOADS = (2**12, 2**14, 2**16)

_DTYPES = {"float32": 4, "bfloat16": 2, "int8": 1}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


@dataclass(frozen=True)
class MeshPlan:
    """One mesh to build and the axes to sweep collectives over."""

    shape: tuple[int, ...]
    names: tuple[str, ...]
    sweep_axes: tuple[str, ...]

    def tag(self, axis: str) -> str:
        return f"{axis}@{'x'.join(str(s) for s in self.shape)}"


def mesh_plans(ndev: int, subgroup_meshes: bool = True) -> list[MeshPlan]:
    """Full 1-D mesh + the balanced 2-D (dp, pp) sub-axis factorization."""
    if ndev < 2:
        return []
    plans = [MeshPlan((ndev,), ("x",), ("x",))]
    if subgroup_meshes:
        best = None
        for a in range(2, int(ndev**0.5) + 1):
            if ndev % a == 0 and ndev // a >= 2:
                best = a  # largest divisor <= sqrt: most balanced split
        if best is not None:
            plans.append(
                MeshPlan((best, ndev // best), ("dp", "pp"), ("dp", "pp"))
            )
    return plans


@dataclass(frozen=True)
class SweepConfig:
    collectives: tuple[str, ...] = COLLECTIVES
    payload_bytes: tuple[int, ...] = DEFAULT_PAYLOADS
    dtypes: tuple[str, ...] = ("float32", "bfloat16")
    repeats: int = 5
    subgroup_meshes: bool = True
    extra_meshes: tuple[MeshPlan, ...] = field(default_factory=tuple)

    @staticmethod
    def smoke() -> "SweepConfig":
        return SweepConfig(
            payload_bytes=SMOKE_PAYLOADS, dtypes=("float32",), repeats=3
        )


def _shard_elems(payload_bytes: int, group: int, itemsize: int) -> int:
    """Shard-local element count for a requested payload: rounded up to a
    whole multiple of the group so tiled reduce-scatter / all-to-all can
    split it."""
    per_elems = max(payload_bytes // itemsize, group)
    return -(-per_elems // group) * group


def recorded_payload(
    kind: str, payload_bytes: int, group: int, itemsize: int = 4
) -> int:
    """The per-device payload a sweep point records for a requested size.

    all-gather records its OUTPUT payload — the semantics
    ``repro_torch.core.hardware.collective_time`` prices with."""
    shard = _shard_elems(payload_bytes, group, itemsize) * itemsize
    return shard * group if kind == "all-gather" else shard


def _collective_fn(mesh, kind: str, axis: str, group: int):
    """The collective over ``axis`` as a function of per-rank values
    (``{coord: tensor}`` of 1-D tensors, the last dimension the payload),
    each kind as the reference's ``shard_map`` body has it: tiled
    all-gather, reduce-scatter and all-to-all along the last dimension, a
    ring permute."""
    if kind == "all-reduce":
        return lambda vs: mesh.psum(vs, axis)
    if kind == "all-gather":       # stacked on a new axis; tiled: in a row
        return lambda vs: {c: v.reshape(-1) for c, v in
                           mesh.all_gather(vs, axis).items()}
    if kind == "reduce-scatter":
        return lambda vs: mesh.psum_scatter(vs, axis)
    if kind == "all-to-all":       # tiled: block j of the payload to rank j
        def a2a(vs):
            blocks = {c: v.reshape(group, -1) for c, v in vs.items()}
            return {c: v.reshape(-1) for c, v in
                    mesh.all_to_all(blocks, axis, 0, 0).items()}
        return a2a
    if kind == "collective-permute":
        perm = [(i, (i + 1) % group) for i in range(group)]
        return lambda vs: mesh.ppermute(vs, axis, perm)
    raise ValueError(f"unknown collective kind {kind!r}")


def _values(mesh, per_elems: int, dtype_name: str, fill: float = 1.0):
    return {c: torch.full((per_elems,), fill, dtype=_TORCH_DTYPES[dtype_name],
                          device=mesh.device(c))
            for c in mesh.coords()}


def _sync_device(mesh):
    dev = mesh.devices[0]
    return dev if dev.type == "cuda" else None


def _measure(
    mesh, plan: MeshPlan, axis: str, kind: str,
    payload_bytes: int, dtype_name: str, repeats: int,
) -> ProfileEntry:
    from repro_torch.core.profiler import time_callable_samples

    group = plan.shape[plan.names.index(axis)]
    itemsize = _DTYPES[dtype_name]
    per_elems = _shard_elems(payload_bytes, group, itemsize)
    xs = _values(mesh, per_elems, dtype_name)
    f = _collective_fn(mesh, kind, axis, group)
    samples = time_callable_samples(lambda: f(xs), repeats=repeats,
                                    device=_sync_device(mesh))
    # record the MEDIAN: shared-host collective timings have heavy-tailed
    # scheduler outliers (occasional 10x samples) that would wreck a mean-
    # based fit; std_s still reports the raw spread for DB consumers
    mean = float(np.median(samples))
    std = float(samples.std())
    recorded = recorded_payload(kind, payload_bytes, group, itemsize)
    return ProfileEntry(
        args={
            "per_device_bytes": int(recorded),
            "devices": int(group),
            "dtype": dtype_name,
            "axis": plan.tag(axis),
        },
        mean_s=mean,
        std_s=std,
        n=repeats,
        flops=0.0,
        bytes=float(recorded),
    )


def _check_ranks(ranks: int) -> None:
    if ranks < 2:
        raise ValueError(f"a collective sweep needs 2 or more ranks (got "
                         f"{ranks})")


def sweep_collectives(
    db: ProfileDB,
    platform: Optional[str] = None,
    config: Optional[SweepConfig] = None,
    ranks: int = 4,
    device="cuda",
) -> int:
    """Run the sweep over ``ranks`` logical ranks on ``device``; returns
    entries recorded.  ``platform``: the DB key (default: the device's,
    ``h100_sxm`` on the card, ``cpu_host`` on the CPU)."""
    from repro_torch.core.profiler import platform_name
    from repro_torch.device import resolve_device
    from repro_torch.dist.mesh import make_mesh

    _check_ranks(ranks)
    cfg = config or SweepConfig()
    dev = resolve_device(device)
    platform = platform or platform_name(dev)
    count = 0
    groups: set[int] = set()
    plans = mesh_plans(ranks, cfg.subgroup_meshes) + list(cfg.extra_meshes)
    for plan in plans:
        mesh = make_mesh(plan.shape, plan.names, dev)
        for axis in plan.sweep_axes:
            g = plan.shape[plan.names.index(axis)]
            if g < 2:
                continue
            for dtype_name in cfg.dtypes:
                for payload in cfg.payload_bytes:
                    for kind in cfg.collectives:
                        db.add(platform, kind, _measure(
                            mesh, plan, axis, kind,
                            payload, dtype_name, cfg.repeats,
                        ))
                        groups.add(g)
                        count += 1
    meta = db.meta(platform).setdefault("netprof", {})
    meta.update(
        {
            "version": 1,
            "groups": sorted(set(meta.get("groups", [])) | groups),
            "collectives": sorted(
                set(meta.get("collectives", [])) | set(cfg.collectives)
            ),
            "payload_bytes": sorted(
                set(meta.get("payload_bytes", []))
                | {int(p) for p in cfg.payload_bytes}
            ),
            # recount from the DB rather than accumulating the raw
            # measurement count: re-calibration REPLACES same-key entries,
            # so the stamp must match what the DB actually holds
            "entries": _collective_entry_count(db, platform),
            # what was measured: logical ranks on physical devices
            "backend": dev.type,
            "device_count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 1),
            "ranks": int(ranks),
        }
    )
    db.meta(platform).setdefault("library", f"torch-{torch.__version__}")
    return count


def _collective_entry_count(db: ProfileDB, platform: str) -> int:
    return sum(len(db.entries(platform, kind)) for kind in COLLECTIVES)


# ---------------------------------------------------------------------------
# Concurrent-collective sweep: two streams active on one link at once
# ---------------------------------------------------------------------------


def _contention_entry(
    kind: str, payload: int, group: int, streams: int,
    mean: float, std: float, repeats: int,
) -> ProfileEntry:
    return ProfileEntry(
        args={
            "kind": kind,
            "per_device_bytes": int(payload),
            "devices": int(group),
            "streams": int(streams),
        },
        mean_s=mean,
        std_s=std,
        n=repeats,
        flops=0.0,
        bytes=float(payload * streams),
    )


def _measure_concurrent(
    mesh, plan: MeshPlan, axis: str, kind: str,
    payload_bytes: int, streams: int, repeats: int,
) -> tuple[float, float]:
    """Wall time (median, std) of ``streams`` independent collectives of
    ``kind`` issued in one call over the same mesh axis — the same links,
    queued together."""
    from repro_torch.core.profiler import time_callable_samples

    group = plan.shape[plan.names.index(axis)]
    per_elems = _shard_elems(payload_bytes, group, _DTYPES["float32"])
    xs = [_values(mesh, per_elems, "float32", float(i + 1))
          for i in range(streams)]
    coll = _collective_fn(mesh, kind, axis, group)
    samples = time_callable_samples(lambda: [coll(v) for v in xs],
                                    repeats=repeats,
                                    device=_sync_device(mesh))
    return float(np.median(samples)), float(samples.std())


def sweep_concurrent(
    db: ProfileDB,
    platform: Optional[str] = None,
    config: Optional[SweepConfig] = None,
    streams: int = 2,
    ranks: int = 4,
    device="cuda",
) -> int:
    """Measure solo-vs-concurrent collective wall times into the DB.

    For each (kind, payload) point on the full 1-D mesh of ``ranks``
    logical ranks, records a ``streams=1`` solo baseline and a
    ``streams=k`` concurrent wall time under the
    :data:`~repro_torch.netprof.model.CONTENTION_FAMILY` family — exactly
    the pairs :func:`repro_torch.netprof.model.fit_link_contention`
    consumes.  Returns entries recorded.
    """
    from repro_torch.core.profiler import platform_name
    from repro_torch.device import resolve_device
    from repro_torch.dist.mesh import make_mesh

    _check_ranks(ranks)
    cfg = config or SweepConfig()
    dev = resolve_device(device)
    platform = platform or platform_name(dev)
    plan = mesh_plans(ranks, subgroup_meshes=False)[0]
    mesh = make_mesh(plan.shape, plan.names, dev)
    axis = plan.sweep_axes[0]
    group = plan.shape[0]
    count = 0
    for kind in cfg.collectives:
        for payload in cfg.payload_bytes:
            solo = _measure_concurrent(
                mesh, plan, axis, kind, payload, 1, cfg.repeats
            )
            pair = _measure_concurrent(
                mesh, plan, axis, kind, payload, streams, cfg.repeats
            )
            recorded = recorded_payload(kind, payload, group)
            db.add(
                platform, CONTENTION_FAMILY,
                _contention_entry(
                    kind, recorded, group, 1, solo[0], solo[1], cfg.repeats
                ),
            )
            db.add(
                platform, CONTENTION_FAMILY,
                _contention_entry(
                    kind, recorded, group, streams,
                    pair[0], pair[1], cfg.repeats,
                ),
            )
            count += 2
    meta = db.meta(platform).setdefault("netprof", {})
    meta["contention_entries"] = len(
        db.entries(platform, CONTENTION_FAMILY)
    )
    meta["contention_streams"] = int(streams)
    return count


def synthetic_contention_calibration(
    db: ProfileDB,
    platform: str,
    *,
    c: float = 0.6,
    streams: int = 2,
    groups: tuple[int, ...] = (2, 4, 8),
    payload_bytes: tuple[int, ...] = SMOKE_PAYLOADS,
    alpha_per_step: float = 5e-6,
    link_bw: float = 4e9,
    collectives: tuple[str, ...] = ("all-reduce", "collective-permute"),
) -> int:
    """Deterministic contention ground truth (tests + the bench gate).

    Writes solo postal-model times and concurrent times stretched by the
    exact shared-channel law ``t_k = t_1 * (1 + c*(k-1))``, so
    ``fit_link_contention`` recovers ``c`` bit-exactly — no hardware.
    """
    from repro_torch.core.hardware import wire_bytes

    count = 0
    for kind in collectives:
        for g in groups:
            for b in payload_bytes:
                t1 = (
                    latency_steps(kind, g) * alpha_per_step
                    + wire_bytes(kind, float(b), g) / link_bw
                )
                tk = t1 * (1.0 + c * (streams - 1))
                for s, t in ((1, t1), (streams, tk)):
                    db.add(
                        platform, CONTENTION_FAMILY,
                        _contention_entry(kind, b, g, s, float(t), 0.0, 1),
                    )
                    count += 1
    meta = db.meta(platform).setdefault("netprof", {})
    meta["contention_entries"] = len(
        db.entries(platform, CONTENTION_FAMILY)
    )
    meta["contention_streams"] = int(streams)
    return count


def synthetic_calibration(
    db: ProfileDB,
    platform: str,
    *,
    groups: tuple[int, ...] = (2, 4, 8),
    payload_bytes: tuple[int, ...] = DEFAULT_PAYLOADS,
    alpha_per_step: float = 5e-6,
    link_bw: float = 4e9,
    collectives: tuple[str, ...] = COLLECTIVES,
) -> int:
    """Deterministic α–β ground-truth entries (tests + the bench gate).

    Writes the exact postal-model times the fitted model should recover —
    no hardware is touched, so the resulting fits (and anything priced from
    them) are bit-stable across hosts and processes.
    """
    from repro_torch.core.hardware import wire_bytes
    from repro_torch.netprof.model import latency_steps

    count = 0
    for kind in collectives:
        for g in groups:
            for b in payload_bytes:
                t = (
                    latency_steps(kind, g) * alpha_per_step
                    + wire_bytes(kind, float(b), g) / link_bw
                )
                db.add(
                    platform, kind,
                    ProfileEntry(
                        args={
                            "per_device_bytes": int(b),
                            "devices": int(g),
                            "dtype": "float32",
                            "axis": f"synthetic@{g}",
                        },
                        mean_s=float(t), std_s=0.0, n=1,
                        flops=0.0, bytes=float(b),
                    ),
                )
                count += 1
    meta = db.meta(platform).setdefault("netprof", {})
    meta.update(
        {
            "version": 1,
            "backend": "synthetic",
            "device_count": int(max(groups)),
            "groups": sorted(groups),
            "collectives": sorted(collectives),
            "payload_bytes": sorted(int(b) for b in payload_bytes),
            "entries": _collective_entry_count(db, platform),
        }
    )
    return count

"""Offline op-level profiler (paper §2 "Op-level profiling").

The torch counterpart of the JAX package's ``core/profiler.py``: profiles the
basic execution units of LM workloads — matmul, elementwise,
transcendental, reduction, gather, dynamic-update-slice, and (over a mesh of
two or more logical ranks) the collectives — over a grid of argument values,
and records mean/std timings into the :class:`ProfileDB`, with the same op
families and argument keys as the JAX package.  The full collective sweep
(every kind, sub-axis groups, dtypes) is ``repro_torch.netprof.sweep``.

On a CUDA device the ops run on the card on tensors there, and the timer
synchronises the card before every clock read, so a sample covers the device
work that the callable queued.  The platform key is the card's spec name
(``h100_sxm``), ``cpu_host`` on the CPU.

Also provides :func:`calibrate_host`: fits achievable peak FLOP/s and memory
bandwidth for the platform from the measurements (the analytic terms the
estimator uses for ops it has no direct profile for).
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.database import ProfileDB, ProfileEntry
from repro_torch.core.hardware import (
    CPU_HOST,
    ChipSpec,
    LinkSpec,
    PlatformSpec,
    platform_for_device,
)
from repro_torch.device import resolve_device, synchronize


def time_callable_samples(
    fn: Callable[[], object], repeats: int = 10, warmup: int = 3,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Raw per-call wall-clock samples of fn().

    At least one warmup call always runs, even when ``warmup=0`` is
    requested, so first-call costs (kernel builds, library heuristics) never
    land in a sample.  ``device``: the card to synchronise around each
    sample (None or CPU: fn must block until its result is ready).
    """
    for _ in range(max(warmup, 1)):
        fn()
    ts = []
    for _ in range(repeats):
        if device is not None:
            synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device is not None:
            synchronize(device)
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def time_callable(
    fn: Callable[[], object], repeats: int = 10, warmup: int = 3,
    device: Optional[torch.device] = None,
) -> tuple[float, float]:
    """(mean_s, std_s) of fn(); see :func:`time_callable_samples`."""
    a = time_callable_samples(fn, repeats=repeats, warmup=warmup,
                              device=device)
    return float(a.mean()), float(a.std())


def _grid(values: Iterable[int], n: int) -> list[int]:
    vals = sorted(set(values))
    if len(vals) <= n:
        return vals
    idx = np.linspace(0, len(vals) - 1, n).round().astype(int)
    return [vals[i] for i in idx]


DEFAULT_MATMUL_GRID = [64, 128, 256, 512, 1024, 2048]
DEFAULT_VECTOR_SIZES = [2**p for p in range(10, 25, 2)]


def platform_of(device: torch.device) -> PlatformSpec:
    """The platform a device runs as: the card's spec, or the CPU host's."""
    if device.type == "cuda":
        return platform_for_device(torch.cuda.get_device_name(device))
    return CPU_HOST


def platform_name(device: torch.device) -> str:
    """The ProfileDB platform key of a device."""
    return platform_of(device).name


class OfflineProfiler:
    """Populates a ProfileDB for one device (``cuda`` unless asked for the
    CPU)."""

    def __init__(
        self,
        db: ProfileDB,
        platform: Optional[str] = None,
        repeats: int = 10,
        dtype=torch.float32,
        device="cuda",
    ):
        self.db = db
        self.device = resolve_device(device)
        self.platform = platform or platform_name(self.device)
        self.repeats = repeats
        self.dtype = dtype
        self._sync = self.device if self.device.type == "cuda" else None
        meta = self.db.meta(self.platform)
        meta.setdefault("library", f"torch-{torch.__version__}")
        meta["backend"] = self.device.type
        # per-call dispatch overhead: a standalone op timing includes one
        # eager dispatch and (on the card) one launch and synchronisation —
        # measured once, subtracted at model-fit time
        tiny = self._ones((8,))
        mean, _ = self._time(lambda: tiny + 1.0, repeats=30, warmup=5)
        meta["dispatch_s"] = mean

        # per-op overhead inside a step: slope of a chain of N trivial ops
        # (eager: one dispatch and launch each)
        def chain(n):
            def g():
                x = tiny
                for _ in range(n):
                    x = x * 1.000001 + 1e-9
                return x
            return g

        t10, _ = self._time(chain(10), 20, 3)
        t400, _ = self._time(chain(400), 20, 3)
        meta["op_overhead_s"] = max((t400 - t10) / 390.0, 0.0)

    def _ones(self, shape, dtype=None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)

    def _time(self, fn, repeats=None, warmup=3) -> tuple[float, float]:
        return time_callable(fn, repeats or self.repeats, warmup,
                             device=self._sync)

    @property
    def _nb(self) -> int:
        return self.dtype.itemsize

    # -- compute ops -----------------------------------------------------------

    def profile_matmul(
        self, sizes: Optional[list[int]] = None, values_per_arg: int = 6
    ) -> int:
        sizes = _grid(sizes or DEFAULT_MATMUL_GRID, values_per_arg)
        count = 0
        for m in sizes:
            for k in sizes:
                for n in sizes:
                    a = self._ones((m, k))
                    b = self._ones((k, n))
                    mean, std = self._time(lambda: a @ b)
                    self.db.add(
                        self.platform,
                        "dot",
                        ProfileEntry(
                            args={"m": m, "k": k, "n": n},
                            mean_s=mean,
                            std_s=std,
                            n=self.repeats,
                            flops=2.0 * m * k * n,
                            bytes=float(self._nb * (m * k + k * n + m * n)),
                        ),
                    )
                    count += 1
        return count

    def profile_elementwise(
        self, sizes: Optional[list[int]] = None, values_per_arg: int = 8
    ) -> int:
        sizes = _grid(sizes or DEFAULT_VECTOR_SIZES, values_per_arg)
        unary = {
            "exp": torch.exp,
            "tanh": torch.tanh,
            "relu": torch.relu,
            "rsqrt": torch.rsqrt,
        }
        binary = {"add": torch.add, "mul": torch.mul}
        nb = self._nb
        count = 0
        for name, op in unary.items():
            for s in sizes:
                x = self._ones((s,))
                mean, std = self._time(lambda: op(x))
                self.db.add(
                    self.platform, name,
                    ProfileEntry({"size": s}, mean, std, self.repeats,
                                 flops=float(s), bytes=float(2 * s * nb)),
                )
                count += 1
        # pure data movement (flops=0): anchors the learned model for the
        # copy/broadcast/transpose nodes
        for s in sizes:
            x = self._ones((s,))
            mean, std = self._time(lambda: torch.flip(x, (0,)))
            self.db.add(
                self.platform, "copy",
                ProfileEntry({"size": s}, mean, std, self.repeats,
                             flops=0.0, bytes=float(2 * s * nb)),
            )
            count += 1
        for name, op in binary.items():
            for s in sizes:
                x = self._ones((s,))
                mean, std = self._time(lambda: op(x, x))
                self.db.add(
                    self.platform, name,
                    ProfileEntry({"size": s}, mean, std, self.repeats,
                                 flops=float(s), bytes=float(3 * s * nb)),
                )
                count += 1
        return count

    def profile_reduction(
        self, sizes: Optional[list[int]] = None, values_per_arg: int = 8
    ) -> int:
        sizes = _grid(sizes or DEFAULT_VECTOR_SIZES, values_per_arg)
        nb = self._nb
        count = 0
        for s in sizes:
            x = self._ones((s,))
            mean, std = self._time(lambda: torch.sum(x))
            self.db.add(
                self.platform, "reduce",
                ProfileEntry({"size": s}, mean, std, self.repeats,
                             flops=float(s), bytes=float(s * nb)),
            )
            x2 = self._ones((max(s // 1024, 1), 1024))
            mean, std = self._time(lambda: torch.softmax(x2, dim=-1))
            self.db.add(
                self.platform, "softmax",
                ProfileEntry({"size": s}, mean, std, self.repeats,
                             flops=float(10 * s), bytes=float(2 * s * nb)),
            )
            count += 2
        return count

    def profile_memory_ops(
        self, sizes: Optional[list[int]] = None, values_per_arg: int = 6
    ) -> int:
        sizes = _grid(sizes or DEFAULT_VECTOR_SIZES, values_per_arg)
        nb = self._nb
        count = 0
        idx = torch.zeros((256,), dtype=torch.int64, device=self.device)
        for s in sizes:
            tbl = self._ones((max(s // 64, 1), 64))
            mean, std = self._time(lambda: torch.index_select(tbl, 0, idx))
            self.db.add(
                self.platform, "gather",
                ProfileEntry({"size": s}, mean, std, self.repeats,
                             flops=0.0, bytes=float(2 * 256 * 64 * nb)),
            )
            t = self._ones((s,))
            u = self._ones((max(s // 16, 1),))
            mean, std = self._time(lambda: t[: u.numel()].copy_(u))
            self.db.add(
                self.platform, "dynamic-update-slice",
                ProfileEntry({"size": s}, mean, std, self.repeats,
                             flops=0.0, bytes=float(2 * u.numel() * nb)),
            )
            count += 2
        return count

    # -- collectives over a mesh of logical ranks (repro_torch.dist.mesh) ----

    def profile_collectives(
        self, sizes: Optional[list[int]] = None, values_per_arg: int = 5,
        ranks: Optional[int] = None,
    ) -> int:
        """All-reduce, all-gather and a ring permute over a flat mesh of
        ``ranks`` logical ranks on this profiler's device.  ``ranks``
        defaults to the visible CUDA devices (1 on the CPU), the
        reference's ``jax.device_count()``; below 2 nothing is recorded, as
        there.  On one card the ranks share it: the entries price
        collectives among ranks on one card (device-local copies)."""
        from repro_torch.dist.mesh import make_mesh

        if ranks is None:
            ranks = (torch.cuda.device_count() if self.device.type == "cuda"
                     else 1)
        if ranks < 2:
            return 0
        sizes = _grid(sizes or [2**p for p in range(12, 24, 2)],
                      values_per_arg)
        mesh = make_mesh((ranks,), ("x",), self.device)
        perm = [(i, (i + 1) % ranks) for i in range(ranks)]
        kinds = {
            "all-reduce": lambda xs: mesh.psum(xs, "x"),
            "all-gather": lambda xs: mesh.all_gather(xs, "x"),
            "collective-permute": lambda xs: mesh.ppermute(xs, "x", perm),
        }
        nb = self._nb
        count = 0
        for s in sizes:
            per_dev = max(s // nb // ranks, 1)
            xs = {c: self._ones((per_dev,)) for c in mesh.coords()}
            for name, fn in kinds.items():
                mean, std = self._time(lambda: fn(xs))
                # payload semantics must match collective_time /
                # CollectiveModel: all-gather records its OUTPUT bytes
                payload = per_dev * nb * (ranks if name == "all-gather"
                                          else 1)
                self.db.add(
                    self.platform, name,
                    ProfileEntry(
                        {"per_device_bytes": payload, "devices": ranks},
                        mean, std, self.repeats,
                        bytes=float(payload),
                    ),
                )
                count += 1
        return count

    def profile_all(self) -> int:
        n = 0
        n += self.profile_matmul()
        n += self.profile_elementwise()
        n += self.profile_reduction()
        n += self.profile_memory_ops()
        n += self.profile_collectives()
        return n


# ---------------------------------------------------------------------------
# Host calibration
# ---------------------------------------------------------------------------


def ring_inverted_link_bw(db: ProfileDB, platform: str) -> float:
    """Best wire bandwidth implied by the platform's all-reduce
    measurements under the ring model; 0.0 when the DB has no usable
    all-reduce entries."""
    from repro_torch.core.hardware import wire_bytes

    best = 0.0
    for e in db.entries(platform, "all-reduce"):
        g = int(e.args.get("devices", 2))
        if e.mean_s > 0 and g > 1:
            best = max(best, wire_bytes("all-reduce", e.bytes, g) / e.mean_s)
    return best


def calibrate_host(db: ProfileDB, platform: str = "cpu_host") -> PlatformSpec:
    """Fit (peak_flops, mem_bw, dispatch overhead) from profiled points and
    store them in the DB meta; returns a PlatformSpec for the estimator."""
    from repro_torch.core.hardware import COLLECTIVE_KINDS

    meta = db.meta(platform)
    dots = db.entries(platform, "dot")
    peak = 0.0
    for e in dots:
        if e.mean_s > 0:
            peak = max(peak, e.flops / e.mean_s)
    bw = 0.0
    for fam in ("add", "mul", "relu"):
        for e in db.entries(platform, fam):
            if e.mean_s > 0:
                bw = max(bw, e.bytes / e.mean_s)
    overhead = 0.0
    # compute-op timings only: collective sweep entries are link-bound and
    # group-structured
    times = [
        e.mean_s
        for fam in db.op_families(platform)
        if fam not in COLLECTIVE_KINDS
        for e in db.entries(platform, fam)
        if "devices" not in e.args
    ]
    if times:
        overhead = float(np.percentile(np.asarray(times), 5))
    meta["peak_flops"] = peak or CPU_HOST.chip.peak_flops
    meta["mem_bw"] = bw or CPU_HOST.chip.hbm_bw
    meta["dispatch_s"] = overhead
    # link bandwidth from collective profiles (ring-model inversion)
    meta["link_bw"] = ring_inverted_link_bw(db, platform) or CPU_HOST.ici.bw
    return PlatformSpec(
        name=platform,
        chip=ChipSpec(
            name=platform,
            peak_flops=meta["peak_flops"],
            hbm_bw=meta["mem_bw"],
            gemm_efficiency=1.0,
            vector_efficiency=1.0,
        ),
        ici=LinkSpec("shm", meta["link_bw"], latency=meta["dispatch_s"]),
        dcn=LinkSpec("shm", meta["link_bw"], latency=meta["dispatch_s"]),
    )

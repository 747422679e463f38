"""A mesh of logical ranks with named axes, and the collectives over an axis.

The counterpart of ``jax.make_mesh`` and of the ``shard_map`` collectives
(``psum``, ``pmean``, ``ppermute``, ``all_gather``, ``all_to_all``,
``psum_scatter``) the JAX package's executors and collective sweep call.  The JAX executors are single-controller SPMD
programs: one process, one body per device of a named mesh.  The port keeps
that design: one process drives every logical rank of a :class:`Mesh` in
turn, and a collective is a plain function over the per-rank tensors of one
axis group (the ranks that differ only along that axis, the other axes held
fixed).

Each rank is bound to a ``torch.device``.  On the card the ranks go round
robin over the visible CUDA devices, so on one card every rank shares it and
the ranks run one after another: a wall time measured there is the sum of
the ranks' work, not a multi-card time.  On the CPU every rank is ``cpu``.
A hop between ranks is ``tensor.to(device, copy=True, non_blocking=True)``:
a device-to-device copy, a copy within the card where both ranks share it.

:data:`TRAFFIC` counts the bytes each kind of collective moved, so a run can
hold what it executed against the byte twins (``pp.boundary_bytes``,
``compress.compressed_psum_bytes``, ``ep_a2a.a2a_payload_bytes``).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.record import prange

# bytes moved by the collectives since the last reset, by kind:
# "ppermute" (one per hop), "psum" (each rank's contribution), "psum_int8"
# (compressed payloads, counted by dist.compress), "all_gather",
# "all_to_all" (each rank's whole payload, its own piece included),
# "psum_scatter" (each rank's whole input)
TRAFFIC: dict[str, int] = {}


def reset_traffic() -> None:
    TRAFFIC.clear()


def _count(kind: str, nbytes: int) -> None:
    TRAFFIC[kind] = TRAFFIC.get(kind, 0) + int(nbytes)


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


@dataclass(frozen=True)
class Mesh:
    """Logical ranks laid out row-major over ``axis_names`` x ``shape``;
    ``devices[r]`` is the device of flat rank ``r``."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape)

    def coords(self) -> list[tuple[int, ...]]:
        """Every rank's coordinate, in flat-rank order."""
        return list(itertools.product(*(range(n) for n in self.shape)))

    def flat(self, coord: Sequence[int]) -> int:
        r = 0
        for c, n in zip(coord, self.shape):
            r = r * n + int(c)
        return r

    def device(self, coord: Sequence[int]) -> torch.device:
        return self.devices[self.flat(coord)]

    def group(self, axis: str, coord: Sequence[int]) -> list[tuple]:
        """The ranks along ``axis`` through ``coord`` (the other axes held
        at ``coord``'s values), in axis order."""
        i = self.axis_names.index(axis)
        return [tuple(coord[:i]) + (j,) + tuple(coord[i + 1:])
                for j in range(self.shape[i])]

    def groups(self, axis: str) -> list[list[tuple]]:
        """Every group along ``axis``."""
        i = self.axis_names.index(axis)
        return [self.group(axis, c) for c in self.coords() if c[i] == 0]

    def group_devices(self, axis: str, coord: Sequence[int]) -> list:
        return [self.device(c) for c in self.group(axis, coord)]

    # -- collectives over per-rank values keyed by coordinate ---------------

    def _over(self, fn, values: dict, axis: str, *args) -> dict:
        out = {}
        for grp in self.groups(axis):
            res = fn([values.get(c) for c in grp],
                     [self.device(c) for c in grp], *args)
            out.update(zip(grp, res))
        return out

    def psum(self, values: dict, axis: str) -> dict:
        return self._over(psum, values, axis)

    def pmean(self, values: dict, axis: str) -> dict:
        return self._over(pmean, values, axis)

    def ppermute(self, values: dict, axis: str, perm) -> dict:
        return self._over(ppermute, values, axis, perm)

    def all_gather(self, values: dict, axis: str) -> dict:
        return self._over(all_gather, values, axis)

    def all_to_all(self, values: dict, axis: str, split_axis: int,
                   concat_axis: int) -> dict:
        return self._over(all_to_all, values, axis, split_axis, concat_axis)

    def psum_scatter(self, values: dict, axis: str,
                     scatter_dimension: int = -1) -> dict:
        return self._over(psum_scatter, values, axis, scatter_dimension)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh of ``prod(shape)`` logical ranks.  On ``cuda`` rank ``r`` is
    bound to ``cuda:(r % device_count)``; asking for ``cuda`` without a card
    raises (``repro_torch.device``)."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
    dev = resolve_device(device)
    n = math.prod(shape)
    if dev.type == "cuda":
        k = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", r % k) for r in range(n))
    else:
        devices = (dev,) * n
    return Mesh(axis_names, shape, devices)


def mesh_info(mesh: Mesh) -> dict:
    """The mesh's axis names and sizes, and its DCN axes (``pod``): the
    counterpart of the JAX package's ``launch/mesh.py::mesh_info``."""
    return {"axis_names": mesh.axis_names, "axis_sizes": mesh.shape,
            "dcn_axes": ("pod",) if "pod" in mesh.axis_names else ()}


# ---------------------------------------------------------------------------
# Collectives over one axis group: lists of per-rank tensors in axis order
# ---------------------------------------------------------------------------


def hop(x: torch.Tensor, device: torch.device, kind: str = "ppermute"):
    """One rank-to-rank transfer: a copy onto ``device`` (differentiable;
    callers that start a new graph detach first)."""
    _count(kind, nbytes(x))
    return x.to(device, copy=True, non_blocking=True)


def psum(xs: list, devices: list) -> list:
    """The sum over the group on every rank.  ``None`` entries are zeros
    (a rank that holds no contribution); the sum runs in rank order on the
    first contributing rank's device and is copied to the other ranks'
    devices (shared, not copied, where a rank is on the same device)."""
    present = [x for x in xs if x is not None]
    if not present:
        return [None] * len(xs)
    home = present[0].device
    total = None
    for x in present:
        _count("psum", nbytes(x))
        x = x.to(home)
        total = x.clone() if total is None else total + x
    return [total.to(d) for d in devices]


def pmean(xs: list, devices: list) -> list:
    n = len(xs)
    return [None if t is None else t / n for t in psum(xs, devices)]


def ppermute(xs: list, devices: list, perm) -> list:
    """``perm``: (source, destination) pairs of group indices.  A
    destination gets the source's tensor on its device.  A rank that no
    pair sends to gets None (JAX's ``ppermute`` gives zeros there; no
    caller reads them)."""
    out: list[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = hop(xs[src], devices[dst])
    return out


def all_gather(xs: list, devices: list) -> list:
    """Every rank's tensor stacked on a new leading axis, on every rank."""
    home = xs[0].device
    for x in xs:
        _count("all_gather", nbytes(x))
    full = torch.stack([x.to(home) for x in xs])
    return [full.to(d) for d in devices]


def all_to_all(xs: list, devices: list, split_axis: int,
               concat_axis: int) -> list:
    """``jax.lax.all_to_all`` (untiled) over the group: each rank's
    ``split_axis``, of the group's size, is scattered, its piece ``j`` going
    to rank ``j``, and rank ``r`` stacks the pieces it receives, in source
    order, on a new ``concat_axis``.  Each piece is one :func:`hop`, so the
    exchange is differentiable (its gradient is the transposed exchange, as
    copies) and counts each rank's whole payload under ``"all_to_all"``,
    the piece it keeps included: what the byte twin
    (``dist.ep_a2a.a2a_payload_bytes``) prices per rank.  The exchange is
    the profiler range ``dist.all_to_all``."""
    n = len(xs)
    for x in xs:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all over {n} ranks: split axis "
                             f"{split_axis} of {tuple(x.shape)} is not {n}")
    with prange("dist.all_to_all"):
        pieces = [x.unbind(split_axis) for x in xs]
        return [torch.stack([hop(pieces[j][r], devices[r], "all_to_all")
                             for j in range(n)], dim=concat_axis)
                for r in range(n)]


def psum_scatter(xs: list, devices: list, scatter_dimension: int = -1) -> list:
    """``jax.lax.psum_scatter(..., tiled=True)`` over the group: the sum
    over the group, cut into the group's size of equal blocks along
    ``scatter_dimension``; rank ``r`` gets block ``r`` on its device.
    Counts each rank's whole input under ``"psum_scatter"``
    (the per-device input payload a reduce-scatter is priced by)."""
    n = len(xs)
    if xs[0].shape[scatter_dimension] % n:
        raise ValueError(f"psum_scatter over {n} ranks: dim "
                         f"{scatter_dimension} of {tuple(xs[0].shape)} does "
                         f"not split {n} ways")
    home = xs[0].device
    total = None
    for x in xs:
        _count("psum_scatter", nbytes(x))
        x = x.to(home)
        total = x.clone() if total is None else total + x
    return [blk.to(d).contiguous()
            for blk, d in zip(total.chunk(n, scatter_dimension), devices)]

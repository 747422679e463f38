"""Logical-axis sharding with divisibility-aware resolution.

The torch counterpart of the JAX package's ``models/sharding.py``.  Every
parameter / activation dimension carries a *logical* axis name
(``"batch"``, ``"heads"``, ``"vocab"``, ...).  A rules table maps each
logical axis to an ordered list of candidate mesh-axis tuples; the resolver
picks the first candidate that

  * exists in the mesh,
  * evenly divides the dimension, and
  * does not reuse a mesh axis already consumed by another dimension of the
    same tensor,

falling back to replication otherwise.  Every fallback is recorded as a
:class:`Drop`, so a report can say which tensors lost which sharding.

The mesh is the port's logical-rank mesh (``repro_torch.dist.mesh.Mesh``;
only its ``sizes`` are read).  A resolved :class:`PartitionSpec` says, per
dimension, which mesh axes split it; :func:`shards` gives every rank's
piece of a tensor under a spec (views where the rank shares the tensor's
device).  The context (:func:`use_sharding`) is what selects the
expert-parallel MoE path (``repro_torch.models.moe``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

Axes = tuple[Optional[str], ...]  # logical axes of one tensor (None = replicated dim)


class PartitionSpec(tuple):
    """Per dimension of a tensor: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (the dimension split over their product, the
    first axis major).  Dimensions past its length are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# logical axis -> ordered candidates, each a tuple of mesh axis names.
# () means "replicate".  The FIRST feasible candidate wins.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # activations
    "batch": (("pod", "data"), ("data",), ()),
    "seq": ((),),
    "seq_q": ((),),             # overridden to ("model",) when heads unshardable
    "kv_seq": ((),),            # overridden to ("data",) for long-context decode
    "layers": ((),),            # stacked layer dim (ZeRO may claim it)
    "embed": ((),),
    "act_heads": (("model",), ()),
    "act_ffn": (("model",), ()),
    "act_experts": (("model",), ()),
    "group": (("pod", "data"), ("data",), ()),  # MoE token groups
    "expert_group": (("pod", "data"), ("data",), ()),  # post-dispatch groups
    "capacity": ((),),
    # parameters
    "vocab": (("model",), ()),
    "heads": (("model",), ()),
    "kv_heads": (("model",), ()),
    "head_dim": ((),),
    "ffn": (("model",), ()),
    "experts": (("model",), ()),
    "expert_ffn": ((),),
    "expert_embed": ((),),
    "act_expert_embed": ((),),
    "act_expert_ffn": ((),),
    # explicit-EP (all-to-all) weight layout
    "experts_ep": (("data",), ()),
    "expert_ffn_ep": (("model",), ()),
    "conv": ((),),
    "ssm_state": ((),),
    "dt": (("model",), ()),     # per-head dt/A params follow head sharding
    "frontend": ((),),
    "patches": ((),),
}

# ZeRO-1: additionally shard optimizer state over the data axis on the first
# dimension that accepts it (applied on top of the parameter spec).
ZERO_AXES = ("data",)


@dataclass
class Drop:
    """One sharding fallback event (for a report)."""

    tensor: str
    dim: int
    logical: str
    wanted: tuple[str, ...]
    size: int
    reason: str

    def __str__(self) -> str:
        return (
            f"{self.tensor}[dim{self.dim}:{self.logical}={self.size}] "
            f"dropped {self.wanted}: {self.reason}"
        )


def _axes_of(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@dataclass(frozen=True)
class RankView:
    """What one rank of a tensor-parallel program computes, for the dry
    run's per-rank trace (``repro_torch.launch.dryrun``): ``model`` ranks
    share the ``model`` axis, and ``seq_q`` of them split the queries'
    sequence (1: every rank holds the whole sequence).  The model code asks
    :func:`rank_view` for the rank's share, one call a site; outside the
    dry run :data:`WHOLE` answers with the identity, so a tree of the wrong
    shape still fails there."""

    model: int = 1
    seq_q: int = 1

    def kv(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """The kv heads the rank's query heads read: a rank holding every
        kv head (they did not split over ``model``) but its share of the
        query heads reads the first ceil(K / model) of them."""
        if k.shape[2] <= q.shape[2]:
            return k, v
        n = -(-k.shape[2] // self.model)
        return k[:, :, :n], v[:, :, :n]

    def queries(self, q: torch.Tensor):
        """``(queries, q_offset)``: with the sequence split ``seq_q`` ways,
        the rank's contiguous share, the last one (the causal mask's
        longest rows), at its offset; else ``(q, None)``."""
        if self.seq_q <= 1:
            return q, None
        b, s = q.shape[:2]
        n = s // self.seq_q
        off = torch.full((b,), s - n, dtype=torch.int32, device=q.device)
        return q[:, s - n:], off

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """A block's output at the whole sequence again (the all-gather
        over ``model``: a copy in the rank's trace)."""
        return y if self.seq_q <= 1 else y.repeat(1, self.seq_q, 1)

    def experts(self, dispatch: torch.Tensor, combine: torch.Tensor,
                held: int):
        """The dispatch and combine weights of the ``held`` experts the
        rank holds (routing ran over all of them)."""
        return dispatch[:, :, :held], combine[:, :, :held]

    def heads(self, held: int, whole: int) -> int:
        """The SSM heads the rank computes: those its weights hold."""
        return held


class _Whole(RankView):
    """The view outside the dry run: every share is the whole."""

    def kv(self, q, k, v):
        return k, v

    def experts(self, dispatch, combine, held):
        return dispatch, combine

    def heads(self, held, whole):
        return whole


WHOLE = _Whole()


@dataclass
class ShardingCtx:
    """Active (mesh, rules) pair that model code reads (``current_ctx``)."""

    mesh: object     # repro_torch.dist.mesh.Mesh (its ``sizes``)
    rules: dict[str, tuple[tuple[str, ...], ...]] = field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )
    drops: list[Drop] = field(default_factory=list)
    zero1: bool = False
    # set only while the dry run traces one rank's program; the model then
    # computes that rank's share and runs no collective
    rank: Optional[RankView] = None

    # -- resolution ---------------------------------------------------------

    def spec_for(
        self, axes: Axes, shape: Sequence[int], name: str = "?"
    ) -> PartitionSpec:
        mesh_sizes = self.mesh.sizes
        used: set[str] = set()
        parts: list = []
        for dim, (logical, size) in enumerate(zip(axes, shape)):
            if logical is None:
                parts.append(None)
                continue
            candidates = self.rules.get(logical)
            if candidates is None:
                raise KeyError(
                    f"no sharding rule for logical axis {logical!r} "
                    f"(tensor {name})"
                )
            chosen: tuple[str, ...] = ()
            first_wanted: tuple[str, ...] = ()
            reason = ""
            for cand in candidates:
                if not cand:
                    chosen = ()
                    break
                if not first_wanted:
                    first_wanted = cand
                missing = [a for a in cand if a not in mesh_sizes]
                if missing:
                    reason = f"mesh axis {missing} absent"
                    continue
                prod = math.prod(mesh_sizes[a] for a in cand)
                if size % prod != 0:
                    reason = f"{size} % {prod} != 0"
                    continue
                if any(a in used for a in cand):
                    reason = "mesh axis already used in this tensor"
                    continue
                chosen = cand
                break
            if not chosen and first_wanted:
                self.drops.append(
                    Drop(name, dim, logical, first_wanted, size, reason)
                )
            used.update(chosen)
            if len(chosen) == 0:
                parts.append(None)
            elif len(chosen) == 1:
                parts.append(chosen[0])
            else:
                parts.append(tuple(chosen))
        return P(*parts)

    def zero_spec_for(self, axes: Axes, shape: Sequence[int],
                      name: str = "?") -> PartitionSpec:
        """Parameter spec with ZeRO-1 data-axis sharding stacked on top."""
        base = self.spec_for(axes, shape, name)
        mesh_sizes = self.mesh.sizes
        parts = list(base) + [None] * (len(shape) - len(base))
        used = {a for p in parts for a in _axes_of(p)}
        for za in ZERO_AXES:
            if za in used or za not in mesh_sizes:
                continue
            # attach to the largest still-divisible dim
            best, best_size = -1, 0
            for i, (p, size) in enumerate(zip(parts, shape)):
                cur = math.prod(mesh_sizes[a] for a in _axes_of(p))
                if size % (cur * mesh_sizes[za]) == 0 and size // cur > best_size:
                    best, best_size = i, size // cur
            if best >= 0:
                p = parts[best]
                if p is None:
                    parts[best] = za
                elif isinstance(p, str):
                    parts[best] = (p, za)
                else:
                    parts[best] = tuple(p) + (za,)
                used.add(za)
        return P(*parts)


def data_axis_size(mesh) -> int:
    """Number of data-parallel replicas a mesh realizes (pod x data)."""
    sizes = mesh.sizes
    return sizes.get("pod", 1) * sizes.get("data", 1)


# ---------------------------------------------------------------------------
# Context plumbing
# ---------------------------------------------------------------------------

_state = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    """The context of this thread.  Autograd may run a backward (and the
    recompute of a checkpointed layer) on another thread: code that runs
    there re-enters the context it captured (``transformer._remat``)."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    prev = current_ctx()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def make_ctx(
    mesh,
    overrides: Optional[dict[str, tuple[tuple[str, ...], ...]]] = None,
    zero1: bool = False,
) -> ShardingCtx:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingCtx(mesh=mesh, rules=rules, zero1=zero1)


def rank_view() -> RankView:
    """The active context's rank view while the dry run traces one rank's
    program, else :data:`WHOLE`."""
    ctx = current_ctx()
    return WHOLE if ctx is None or ctx.rank is None else ctx.rank


def shard_hint(x: torch.Tensor, axes: Axes, name: str = "act"):
    """The JAX package's sharding constraint: here an identity that
    resolves the spec against the active rules, so its drops are recorded
    as the reference's are; a no-op outside a sharding context."""
    ctx = current_ctx()
    if ctx is not None:
        ctx.spec_for(axes, x.shape, name)
    return x


# ---------------------------------------------------------------------------
# A rank's piece of a tensor
# ---------------------------------------------------------------------------


def shards(x: torch.Tensor, spec: PartitionSpec, mesh) -> dict:
    """Every rank's shard of ``x`` under ``spec``: ``{coord: tensor}`` over
    ``mesh.coords()``, each on its rank's device.

    A dimension split over mesh axes ``(a, b)`` is cut into
    ``size[a] * size[b]`` equal pieces, and the rank takes the piece at its
    row-major index over those axes (``a`` major), as ``NamedSharding``
    places them.  Each sharded dimension is cut by one ``split``, so the
    pieces are views, their gradients come back as one ``cat`` a dimension,
    and a rank on the tensor's device holds a view, no copy."""
    sizes, names = mesh.sizes, mesh.axis_names
    cuts = [(d, _axes_of(p)) for d, p in enumerate(spec) if _axes_of(p)]
    pieces = {(): x}
    for d, axes in cuts:
        n = math.prod(sizes[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"{n} ways over {axes}")
        pieces = {key + (i,): t
                  for key, whole in pieces.items()
                  for i, t in enumerate(whole.split(x.shape[d] // n, d))}
    out = {}
    for coord in mesh.coords():
        at = dict(zip(names, coord))
        key = []
        for _, axes in cuts:
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + at[a]
            key.append(idx)
        out[coord] = pieces[tuple(key)].to(mesh.device(coord))
    return out


# ---------------------------------------------------------------------------
# Tree helpers: resolve a whole parameter tree
# ---------------------------------------------------------------------------


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def tree_specs(ctx: ShardingCtx, shapes, axes_tree, zero1=False):
    """Map a (shapes, logical-axes) tree pair to PartitionSpecs.

    ``shapes`` is a nested dict whose leaves have ``.shape`` (tensors or
    ``models.build.ShapeDtype``); ``axes_tree`` mirrors it with ``Axes``
    tuples.  ``zero1`` may be a bool or a per-leaf predicate
    ``axes -> bool`` (selective FSDP, e.g. excluding expert weights).
    """

    def one(name, leaf, axes):
        z = zero1(axes) if callable(zero1) else zero1
        if z:
            return ctx.zero_spec_for(axes, leaf.shape, name)
        return ctx.spec_for(axes, leaf.shape, name)

    def build(shape_t, axes_t, prefix):
        if isinstance(shape_t, dict):
            if _is_axes(axes_t) or set(shape_t) != set(axes_t):
                raise ValueError(f"params/axes tree mismatch at "
                                 f"{'/'.join(prefix) or '<root>'}")
            # sorted keys: the JAX tree order, so drops come in its order
            return {k: build(shape_t[k], axes_t[k], prefix + (str(k),))
                    for k in sorted(shape_t)}
        if not _is_axes(axes_t):
            raise ValueError(f"params/axes tree mismatch at "
                             f"{'/'.join(prefix)}")
        return one("/".join(prefix), shape_t, axes_t)

    return build(shapes, axes_tree, ())

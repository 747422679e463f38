"""Gradient compression: int8 quantization, top-k sparsification, error
feedback, and the compressed data-parallel all-reduce.

The torch counterpart of the JAX package's ``dist/compress.py``.  The
quantize -> reduce -> dequantize pattern follows the 1-bit-Adam / PowerSGD
family: the *unbiasedness* of the scheme over time comes from error feedback
(the residual re-enters the next step's gradient), so a per-step
quantization error of up to ``scale / 2`` per element never accumulates.

Where the JAX ``compressed_psum`` runs inside ``shard_map`` on one device's
gradient, the port's runs over the ranks of one mesh axis group
(``repro_torch.dist.mesh``): it takes each rank's gradient tree and
residuals, and returns each rank's mean and new residuals.  The sum runs on
the dequantized payloads, as in the reference; the int8 payload plus one
fp32 scale a tensor that a compression-aware ring would ship is counted in
``mesh.TRAFFIC["psum_int8"]``, and ``compressed_allreduce_bytes`` and the
twins below are what the simulator prices (``repro_torch.core.estimator``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import mesh as M
from repro_torch.tree import leaves, tree_map, unflatten_like

INT8_MAX = 127.0
# per-tensor metadata shipped alongside the int8 payload: one f32 scale
SCALE_BYTES = 4


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``x ~= q * scale``.

    Returns ``(q: int8, scale: f32 scalar)``.  Max abs rounding error is
    ``scale / 2``; an all-zero tensor quantizes to scale 0 (exact).
    """
    amax = x.abs().max()
    scale = amax / INT8_MAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -INT8_MAX, INT8_MAX).to(
        torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, k_fraction: float = 0.01):
    """Keep the ``k = max(1, round(n * k_fraction))`` largest-|.| entries.

    Returns ``(kept, residual)`` with ``kept + residual == x`` exactly.
    """
    flat = x.reshape(-1)
    n = flat.shape[0]
    k = max(1, int(round(n * k_fraction)))
    idx = torch.topk(flat.abs(), k).indices
    mask = torch.zeros((n,), dtype=torch.bool, device=x.device)
    mask[idx] = True
    kept = torch.where(mask, flat, torch.zeros_like(flat)).reshape(x.shape)
    return kept, x - kept


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor):
    """One error-feedback compression step: ``(q: int8, scale,
    new_residual)``; the residual re-enters the gradient before
    quantization."""
    acc = grad + residual
    q, scale = quantize_int8(acc)
    return q, scale, acc - dequantize_int8(q, scale)


def init_compression_state(tree):
    """Zero residuals matching a gradient tree (f32, shapes preserved)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)


def init_feedback_state(tree, dp: int = 1):
    """Zero residuals with a per-replica leading axis: leaves are
    ``(dp, *leaf.shape)`` f32, one residual per data-parallel rank (the
    JAX package's checkpointable layout)."""
    return tree_map(lambda g: torch.zeros((dp,) + tuple(g.shape),
                                          dtype=torch.float32,
                                          device=g.device), tree)


def reverse_bucket_indices(leaf_elems, n_buckets: int) -> list[list[int]]:
    """Partition leaf indices into reverse-order buckets of ~equal elements
    (the bucketing twin shared by :func:`compressed_psum` with ``buckets``
    and ``core.strategy.pipeline_graph``); a copy of the reference's."""
    elems = [int(n) for n in leaf_elems]
    nb = max(1, min(int(n_buckets), len(elems)))
    order = list(range(len(elems)))[::-1]
    target = sum(elems) / nb
    out: list[list[int]] = [[] for _ in range(nb)]
    acc, b = 0, 0
    for pos, i in enumerate(order):
        remaining_leaves = len(order) - pos
        if (
            out[b]
            and b < nb - 1
            and (acc >= (b + 1) * target or remaining_leaves <= nb - 1 - b)
        ):
            b += 1
        out[b].append(i)
        acc += elems[i]
    return out


def _buckets(sizes: list[int], buckets: int) -> list[list[int]]:
    if buckets >= 2 and len(sizes) >= 2:
        return reverse_bucket_indices(sizes, buckets)
    return [[i] for i in range(len(sizes))]


def _reduce_bucket(bucket: list[int], payload_of, devices: list) -> dict:
    """Sum one bucket of leaves over the ranks: ``payload_of(r, i)`` is
    rank r's leaf i; one psum of the ranks' concatenated flat leaves.
    Returns {leaf index: [each rank's sum]}."""
    per_rank = [[payload_of(r, i) for i in bucket]
                for r in range(len(devices))]
    flats = [torch.cat([x.reshape(-1) for x in pl]) if len(pl) > 1
             else pl[0] for pl in per_rank]
    red = M.psum(flats, devices)
    out, off = {}, 0
    for j, i in enumerate(bucket):
        shape, n = per_rank[0][j].shape, per_rank[0][j].numel()
        out[i] = [r.reshape(-1)[off:off + n].reshape(shape) for r in red]
        off += n
    return out


def compressed_psum(grads, devices: Optional[list] = None, state=None,
                    buckets: int = 0, inplace: bool = False):
    """Mean-reduce gradient trees over one axis group with int8 payloads.

    ``devices=None`` is the reference's ``axis_name=None``: ``grads`` and
    ``state`` are one rank's trees and the reduction is the identity mean
    (dp = 1), error feedback included.  Otherwise ``grads`` and ``state``
    are lists of per-rank trees (``state=None``: zero residuals), in the
    group's rank order, and ``devices`` the ranks' devices.

    Each rank quantizes its gradient plus carried residual, the dequantized
    payloads are summed over the group and divided by its size, a bucket
    of leaves at a time: ``buckets >= 2`` sums reverse-order buckets of
    concatenated payloads (bit-identical to per leaf).  ``inplace`` writes
    the new residuals into ``state``'s tensors (the train steps', which
    consume their state).  Returns ``(means, new_state)`` in the layout of
    the arguments.
    """
    single = devices is None
    if single:
        grads, state = [grads], [state]
        devices = [leaves(grads[0])[0].device]
    if state is None:
        state = [None] * len(grads)
    state = [init_compression_state(g) if s is None else s
             for g, s in zip(grads, state)]
    size = len(grads)
    g_leaves = [leaves(g) for g in grads]
    r_leaves = [leaves(r) for r in state]
    n = len(g_leaves[0])
    means = [[None] * n for _ in range(size)]
    new_res = [[None] * n for _ in range(size)]

    def payload(r, i):
        q, scale, res = compress_with_feedback(g_leaves[r][i],
                                               r_leaves[r][i])
        M._count("psum_int8", q.numel() + SCALE_BYTES)
        new_res[r][i] = r_leaves[r][i].copy_(res) if inplace else res
        return dequantize_int8(q, scale)

    for bucket in _buckets([x.numel() for x in g_leaves[0]], buckets):
        if size == 1:
            sums = {i: [payload(0, i)] for i in bucket}
        else:
            sums = _reduce_bucket(bucket, payload, devices)
        for i, per_rank in sums.items():
            for r in range(size):
                means[r][i] = per_rank[r] / size
    means = [unflatten_like(g, m) for g, m in zip(grads, means)]
    new_state = [unflatten_like(g, nr) for g, nr in zip(grads, new_res)]
    if single:
        return means[0], new_state[0]
    return means, new_state


def bucketed_pmean(trees: list, devices: list, buckets: int = 0) -> list:
    """Dense counterpart of the bucketed path of :func:`compressed_psum`:
    each rank's mean tree over the group, one psum per reverse-order bucket
    (``buckets < 2``: per leaf)."""
    size = len(trees)
    per_rank = [leaves(t) for t in trees]
    means = [[None] * len(per_rank[0]) for _ in range(size)]
    for bucket in _buckets([x.numel() for x in per_rank[0]], buckets):
        for i, red in _reduce_bucket(bucket, lambda r, i: per_rank[r][i],
                                     devices).items():
            for r in range(size):
                means[r][i] = red[r] / size
    return [unflatten_like(t, m) for t, m in zip(trees, means)]


# ---------------------------------------------------------------------------
# Simulator-facing byte accounting (copies of the reference's twins)
# ---------------------------------------------------------------------------


def compressed_allreduce_bytes(n_elems: int, n_tensors: int = 1,
                               scheme: str = "int8") -> float:
    """Per-device payload bytes of a compressed gradient all-reduce: 1
    byte/element for int8 plus one f32 scale per tensor; ``topk:<frac>``
    ships (int32 index, f32 value) pairs for the kept fraction
    (accounting-only); raw f32 is ``4 * n_elems``."""
    if scheme == "int8":
        return float(n_elems) + SCALE_BYTES * n_tensors
    if scheme.startswith("topk:"):
        frac = float(scheme.split(":", 1)[1])
        kept = max(1, round(n_elems * frac))
        return float(kept * (4 + 4))
    if scheme in ("none", ""):
        return 4.0 * n_elems
    raise ValueError(f"unknown compression scheme {scheme!r}")


def tree_allreduce_bytes(leaf_elems, scheme: str = "int8") -> float:
    """Per-device payload over a gradient tree: the exact sum over leaves
    of :func:`compressed_allreduce_bytes` with ``n_tensors=1``."""
    return float(
        sum(
            compressed_allreduce_bytes(int(n), n_tensors=1, scheme=scheme)
            for n in leaf_elems
        )
    )


def bucket_allreduce_bytes(leaf_elems, scheme: str = "int8",
                           buckets: int = 2) -> list[float]:
    """Per-bucket payloads of a bucketed compressed all-reduce; they sum
    exactly to :func:`tree_allreduce_bytes` over the same leaves."""
    elems = [int(n) for n in leaf_elems]
    return [
        tree_allreduce_bytes([elems[i] for i in bucket], scheme=scheme)
        for bucket in reverse_bucket_indices(elems, buckets)
    ]


def leaf_elems(tree) -> list[int]:
    """Element count of every leaf (tensors or anything with a ``shape``),
    in the JAX package's leaf order."""
    out = []
    for leaf in leaves(tree):
        n = 1
        for s in leaf.shape:
            n *= int(s)
        out.append(n)
    return out


def compressed_psum_bytes(grads, scheme: str = "int8") -> float:
    """Executor-side byte twin of :func:`compressed_psum`: the per-device
    payload a compression-aware ring would move for this gradient tree."""
    return tree_allreduce_bytes(leaf_elems(grads), scheme=scheme)

"""Plain PyTorch dropless MoE experts: the functions the CUDA kernels compute.

The routed (token, choice) rows sorted by expert, each expert's SwiGLU over
its rows alone (a loop over every expert, those with no rows included, so
the operations a call runs do not depend on its routing), and the
gate-weighted combine, in the einsum path's dtypes (``models/moe.py``): the
expert products in the compute dtype, silu(g) * u rounded as the einsum path
rounds it, each gate rounded to the compute dtype and the k terms summed in
fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ROW_TILE = 64           # rows a grouped-GEMM tile (csrc kBM)


def max_tiles(n_rows: int, experts: int) -> int:
    """Row tiles a call may need: every expert with rows has one partial
    tile at most, so ceil(rows / 64) plus the experts that can have rows."""
    return -(-n_rows // ROW_TILE) + min(experts, n_rows)


def route_ref(expert_idx: torch.Tensor, experts: int,
              partial: bool = False) -> dict:
    """Sort the choices (T, k) by expert, stably (token-major, choice-minor):
    ``row_of`` (T k) the sorted row of each flat choice, ``src_tok`` (T k)
    the token of each row, ``offsets`` (E + 1) each expert's first row, and
    ``tiles`` (max_tiles, 2) the 64-row tiles (expert, first row), expert
    -1 past the last.  All int32.  ``partial``: the rank holds part of the
    experts, and a choice outside [0, E) has no row (:func:`_route_held`)."""
    if partial:
        return _route_held(expert_idx, experts)
    T, k = expert_idx.shape
    n = T * k
    dev = expert_idx.device
    flat = expert_idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=experts)
    offsets = torch.zeros(experts + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    row_of = torch.empty(n, dtype=torch.int64, device=dev)
    row_of[order] = torch.arange(n, device=dev)
    per = (counts + ROW_TILE - 1) // ROW_TILE
    tile_e = torch.repeat_interleave(torch.arange(experts, device=dev), per)
    first = torch.cumsum(per, 0) - per
    j = torch.arange(tile_e.numel(), device=dev) - first[tile_e]
    tiles = torch.zeros((max_tiles(n, experts), 2), dtype=torch.int64,
                        device=dev)
    tiles[:, 0] = -1
    tiles[:tile_e.numel(), 0] = tile_e
    tiles[:tile_e.numel(), 1] = offsets[tile_e] + ROW_TILE * j
    i32 = torch.int32
    return {"row_of": row_of.to(i32), "src_tok": (order // k).to(i32),
            "offsets": offsets.to(i32), "tiles": tiles.to(i32)}


def _route_held(expert_idx: torch.Tensor, experts: int) -> dict:
    """:func:`route_ref` where choices outside [0, E) (experts another rank
    holds) have no row: their ``row_of`` is -1, they count in no offset
    and no tile, and ``src_tok`` past the held rows is 0."""
    T, k = expert_idx.shape
    flat = expert_idx.reshape(-1)
    held = (flat >= 0) & (flat < experts)
    key = torch.where(held, flat, torch.full_like(flat, experts))
    rows = route_ref(key.view(T, k), experts + 1)
    n_held = int(held.sum())
    offsets = rows["offsets"][:experts + 1]
    tiles = rows["tiles"][:max_tiles(T * k, experts)].clone()
    dropped = tiles[:, 0] == experts
    tiles[dropped, 0] = -1
    tiles[dropped, 1] = 0
    src = rows["src_tok"].clone()
    src[n_held:] = 0
    row_of = torch.where(held, rows["row_of"], -1).to(torch.int32)
    return {"row_of": row_of, "src_tok": src, "offsets": offsets,
            "tiles": tiles, "partial": True}


def gate_up_ref(x, rows: dict, wg, wu) -> torch.Tensor:
    """h (T k, F): each sorted row's silu(x wg[e]) * (x wu[e])."""
    src, off = rows["src_tok"].long(), rows["offsets"].tolist()
    h = x.new_empty((src.numel(), wg.shape[-1]))
    for e in range(wg.shape[0]):
        a, b = off[e], off[e + 1]
        xe = x[src[a:b]]
        h[a:b] = F.silu(xe @ wg[e]) * (xe @ wu[e])
    return h


def down_ref(h, rows: dict, wd) -> torch.Tensor:
    """out (T k, D): each sorted row's h wd[e]."""
    off = rows["offsets"].tolist()
    out = h.new_empty((h.shape[0], wd.shape[-1]))
    for e in range(wd.shape[0]):
        a, b = off[e], off[e + 1]
        out[a:b] = h[a:b] @ wd[e]
    return out


def combine_ref(out, rows: dict, gate) -> torch.Tensor:
    """y (T, D) = sum_j gate[t, j] out[row(t, j)]: each gate rounded to
    out's dtype, the k terms summed in fp32, the sum in out's dtype (a
    partial routing's choice with no row adds nothing)."""
    T, k = gate.shape
    if rows.get("partial"):
        # a choice with no row (an expert another rank holds) adds nothing
        row = rows["row_of"].long()
        picked = torch.where((row >= 0).view(T, k, 1),
                             out[row.clamp(min=0)].reshape(T, k, -1).float(),
                             0.0)
    else:
        picked = out[rows["row_of"].long()].reshape(T, k, -1).float()
    g = gate.to(out.dtype).float()
    acc = g[:, 0, None] * picked[:, 0]
    for j in range(1, k):
        acc = acc + g[:, j, None] * picked[:, j]
    return acc.to(out.dtype)


def moe_experts_ref(x, gate, expert_idx, wg, wu, wd,
                    partial: bool = False) -> torch.Tensor:
    """y (T, D) of tokens x (T, D) routed to experts ``expert_idx`` (T, k)
    with gates ``gate`` (T, k) fp32: route, gate/up, down, combine
    (``partial``: :func:`route_ref`'s)."""
    rows = route_ref(expert_idx, wg.shape[0], partial)
    h = gate_up_ref(x, rows, wg, wu)
    return combine_ref(down_ref(h, rows, wd), rows, gate)

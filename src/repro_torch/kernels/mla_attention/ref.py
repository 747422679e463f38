"""Plain PyTorch paged latent attention: the function the CUDA kernel
computes.

Token t (its lane ``lane[t]``, its position ``pos[t]``) attends, with each of
its H query rows ``q[t, h]`` (D values), over its lane's cache rows 0 ..
pos[t], read through the block table: row j is ``pages[tables[lane, j //
block_size], j % block_size]``.  Scores are ``scale * q . row`` over all D
values, the output the softmax's weighted sum of the rows' first ``rank``
values (the latent: key and value at once).  Products, softmax and sums in
fp32; the output in q's dtype.
"""
from __future__ import annotations

import torch

KEY_TILE = 32           # keys a tile of the kernel (csrc kKeys)
PAGE = 64               # the page of a contiguous sequence (mla.attention)


def mla_attention_ref(q, pages, tables, lane, pos, rank: int,
                      scale: float) -> torch.Tensor:
    """q (T, H, D), pages (blocks, block_size, D), tables (lanes,
    max_blocks), lane and pos (T,) -> (T, H, rank) in q's dtype."""
    T, H, D = q.shape
    out = q.new_empty((T, H, rank))
    view = tables.shape[1] * pages.shape[1]
    lanes, pos = lane.long(), pos.long().clamp(min=0, max=view - 1)
    for ln in torch.unique(lanes).tolist():
        toks = (lanes == ln).nonzero(as_tuple=True)[0]
        n = int(pos[toks].max()) + 1
        rows = pages[tables[ln].long()].reshape(view, D)[:n].float()
        s = torch.einsum("thd,jd->thj", q[toks].float(), rows) * scale
        hide = torch.arange(n, device=q.device)[None, :] > pos[toks][:, None]
        s = s.masked_fill(hide[:, None, :], float("-inf"))
        out[toks] = torch.einsum("thj,jr->thr", torch.softmax(s, dim=-1),
                                 rows[:, :rank]).to(q.dtype)
    return out

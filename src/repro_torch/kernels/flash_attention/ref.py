"""Plain PyTorch attention: the function the flash kernel computes.

Materialises the fp32 scores like ``_sdpa_dense``.  Query ``i`` of batch row
``b`` sits at position ``q_offset[b] + i`` and sees key ``j`` iff
``j < kv_len[b]`` and, when causal, ``j <= q_offset[b] + i``.  Masked scores
are -1e30 and a row that sees no key is zeroed, as in the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(b: int, sq: int, skv: int, *, causal: bool,
                   q_offset: Optional[torch.Tensor],
                   kv_len: Optional[torch.Tensor],
                   device) -> torch.Tensor:
    """(B, Sq, Skv) bool: True where query i of row b sees key j."""
    kj = torch.arange(skv, device=device)
    lim = (torch.full((b,), skv, device=device) if kv_len is None
           else kv_len.to(device=device, dtype=torch.int64))
    mask = (kj[None, None, :] < lim[:, None, None]).expand(b, sq, skv)
    if causal:
        off = (torch.zeros(b, dtype=torch.int64, device=device)
               if q_offset is None
               else q_offset.to(device=device, dtype=torch.int64))
        qpos = off[:, None] + torch.arange(sq, device=device)[None, :]
        mask = mask & (kj[None, None, :] <= qpos[:, :, None])
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  q_offset: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) with H % K == 0.
    Returns (B, Sq, H, D) in q's dtype; arithmetic in fp32."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(h // kh, dim=2)
    vf = v.float().repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = attention_mask(b, sq, skv, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, device=q.device)
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1)[:, None, :, None]
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)

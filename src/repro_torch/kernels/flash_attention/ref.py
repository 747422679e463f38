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


def attention_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          keys: torch.Tensor, *, causal: bool = True,
                          q_offset: Optional[torch.Tensor] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          sm_scale: Optional[float] = None):
    """The partial softmax of one KV split: attention over the keys where
    ``keys`` ((Skv,) bool) is True, left unnormalised.  Returns fp32
    (m, l, acc) of shapes (B, Sq, H), (B, Sq, H) and (B, Sq, H, D): the row
    max of the visible scaled scores, the sum of exp(s - m), and the sum of
    exp(s - m) v.  A row that sees no key of the split gets the neutral
    partial m = NEG_INF, l = 0, acc = 0."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(h // kh, dim=2)
    vf = v.float().repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = attention_mask(b, sq, skv, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, device=q.device)
    mask = (mask & keys.to(q.device)[None, None, :])[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return (m.masked_fill(l == 0, NEG_INF).transpose(1, 2),
            l.transpose(1, 2), acc)


def combine_ref(m: torch.Tensor, l: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
    """The plain version of the combine kernel: merge S splits' partials
    (m, l: (S, B, Sq, H); acc: (S, B, Sq, H, D)) by log-sum-exp.  Neutral
    partials (l = 0) weigh nothing; a row with no visible key in any split
    is zero.  Returns fp32 (B, Sq, H, D)."""
    has = l > 0
    top = torch.where(has, m, torch.full_like(m, -math.inf)).amax(dim=0)
    w = torch.where(has, torch.exp(m - top), torch.zeros_like(m))
    lsum = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0)
    return out / lsum.clamp_min(1e-30)[..., None]



def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      q_offset: Optional[torch.Tensor] = None,
                      kv_len: Optional[torch.Tensor] = None,
                      sm_scale: Optional[float] = None):
    """The plain version of the backward kernels: the gradient of
    :func:`attention_ref` in q, k and v, computed as the kernels compute it.

    do is the output's gradient, (B, Sq, H, D).  Per query row: LSE, the
    log-sum-exp of the visible scaled scores s; P = exp(s - LSE); dP = do
    v^T; D = rowsum(P * dP); dS = P (dP - D).  Then dq = scale dS k, and dk
    = scale dS^T q and dv = P^T do, each summed over the heads of a GQA
    group.  D is rowsum(P * dP), as the plain VJP's softmax backward takes
    it, and not rowsum(do * o) from the forward's bf16 output, whose
    rounding moves bf16 gradients past the kernels' check.  A row that sees
    no key has P = 0: it adds nothing and its dq is zero.  Returns fp32
    (dq, dk, dv) in the shapes of q, k and v; arithmetic in fp32."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kr, vr = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    mask = attention_mask(b, sq, skv, causal=causal, q_offset=q_offset,
                          kv_len=kv_len, device=q.device)[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse) * mask.any(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return (dq, dk.reshape(b, skv, kh, g, d).sum(dim=3),
            dv.reshape(b, skv, kh, g, d).sum(dim=3))

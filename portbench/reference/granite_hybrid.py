"""Plain reference of the hybrid Mamba-2 / attention / MoE language model
(granite-4.0-h, the public ``granitemoehybrid`` equations), over a whole
sequence from position 0.

Layer ``i`` is a mixer then an FFN, each a pre-norm residual branch scaled
by ``residual_multiplier``:

* the mixer is GQA attention without position encoding, softmax scale
  ``attention_multiplier``, where ``i % attn_every == attn_offset``, and a
  Mamba-2 mixer elsewhere: z, x, B, C and dt projected from the normed
  input; a causal depthwise conv of width ``d_conv`` with a bias, then SiLU,
  on x, B and C; dt = softplus(dt + dt_bias), A = -exp(A_log); per token t
  and head h the state S (d_state, head_dim) runs

      S_t = exp(dt_t A_h) S_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T S_t + D_h x_t

  with B and C shared by the heads of a group; then y * SiLU(z), an RMSNorm
  over each group's channels, and the output projection;
* the FFN is ``experts`` routed SwiGLU experts, each token computed by the
  ``top_k`` experts of largest router logit with gates the softmax over
  those logits (no capacity: no token is dropped), plus a shared SwiGLU.

The embedding is scaled by ``embedding_multiplier``; after a final RMSNorm
the head is the tied embedding, the logits divided by ``logits_scaling``.
The recurrence runs token by token (it is not the port's chunked scan).

Departures, each held alike by the program: weights come in the port's tree
(``blocks`` stacked on a superblock axis and then per kind of sublayer); the
conv kernel's tap ``k`` multiplies the input ``d_conv - 1 - k`` positions
back (the published conv1d's taps in that order).  Every product runs in
float32 (``common.Precision``), TF32 off.  ``reset_every``: the fault
control, each Mamba layer's state and conv history zeroed at every multiple
of it, as a program that dropped its state between prefill chunks would.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, rmsnorm


def _attention(pr: Precision, p: dict, x: torch.Tensor, d: dict):
    """x (S, d_model) normed -> (S, d_model)."""
    s = x.shape[0]
    q = pr.mm(x, p["wq"].flatten(1)).view(s, d["heads"], -1)
    k = pr.mm(x, p["wk"].flatten(1)).view(s, d["kv_heads"], -1)
    v = pr.mm(x, p["wv"].flatten(1)).view(s, d["kv_heads"], -1)
    rep = d["heads"] // d["kv_heads"]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    scores = pr.mm(q.transpose(0, 1), k.permute(1, 2, 0)) * d["attn_scale"]
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = pr.mm(probs, v.transpose(0, 1)).transpose(0, 1)
    return pr.mm(o.flatten(1), p["wo"].flatten(0, 1))


def _conv(u: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          reset_every: int) -> torch.Tensor:
    """Causal depthwise conv then SiLU: u (S, ch) -> (S, ch); tap k reads
    u[t - (w-1) + k], zero before the start (or before the last reset)."""
    w, s = kernel.shape[0], u.shape[0]
    kernel, pos = kernel.float().flatten(1), torch.arange(s, device=u.device)
    start = (pos // reset_every) * reset_every if reset_every else 0 * pos
    y = bias.float().flatten().expand(s, -1).clone()
    for k in range(w):
        src = pos - (w - 1) + k
        ok = (src >= start)[:, None]
        y = y + torch.where(ok, u[src.clamp(min=0)], 0.0) * kernel[k]
    return F.silu(y)


def _mamba(pr: Precision, p: dict, x: torch.Tensor, d: dict,
           reset_every: int) -> torch.Tensor:
    """x (S, d_model) normed -> (S, d_model)."""
    s = x.shape[0]
    nh, hp, n, g = d["ssm_heads"], d["ssm_head_dim"], d["d_state"], \
        d["ngroups"]
    z = pr.mm(x, p["wz"].flatten(1))                          # (S, nh*hp)
    xs = _conv(pr.mm(x, p["wx"].flatten(1)), p["conv_x"], p["conv_x_bias"],
               reset_every)
    B = _conv(pr.mm(x, p["wB"].flatten(1)), p["conv_B"], p["conv_B_bias"],
              reset_every).view(s, g, n)
    C = _conv(pr.mm(x, p["wC"].flatten(1)), p["conv_C"], p["conv_C_bias"],
              reset_every).view(s, g, n)
    dt = F.softplus(pr.mm(x, p["wdt"]) + p["dt_bias"].float())   # (S, nh)
    A = -torch.exp(p["A_log"].float())
    xs = xs.view(s, nh, hp)
    group = torch.arange(nh, device=x.device) // (nh // g)
    Bh, Ch = B[:, group], C[:, group]                          # (S, nh, n)
    decay = torch.exp(dt * A)
    state = torch.zeros(nh, n, hp, device=x.device)
    y = torch.empty(s, nh, hp, device=x.device)
    for t in range(s):
        if reset_every and t % reset_every == 0:
            state = torch.zeros_like(state)
        state = state * decay[t, :, None, None] + \
            (dt[t, :, None] * Bh[t])[:, :, None] * xs[t, :, None, :]
        y[t] = (Ch[t, :, :, None] * state).sum(1)
    y = y + xs * p["D_skip"].float()[:, None]
    y = y.flatten(1) * F.silu(z)
    yg = y.view(s, g, -1)
    yg = yg * torch.rsqrt(yg.square().mean(-1, keepdim=True) + d["norm_eps"])
    y = yg.flatten(1) * p["norm"].float().flatten()
    return pr.mm(y, p["wo"].flatten(0, 1))


def _swiglu(pr: Precision, x, wg, wu, wd):
    return pr.mm(F.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)


def _moe(pr: Precision, p: dict, x: torch.Tensor, top_k: int):
    """Routed experts, x (S, d) normed -> (S, d)."""
    top, experts = torch.topk(x @ p["router"].float(), top_k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for e in torch.unique(experts).tolist():
        tok, slot = (experts == e).nonzero(as_tuple=True)
        out = _swiglu(pr, x[tok], p["wg"][e], p["wu"][e], p["wd"][e])
        y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@torch.no_grad()
def logits(w: dict, tokens: torch.Tensor, d: dict, pr: Precision,
           reset_every: int = 0) -> torch.Tensor:
    """tokens (S,) -> float32 logits (S, vocab) of one sequence from
    position 0."""
    eps, rm = d["norm_eps"], d["residual_multiplier"]
    x = w["embed"][tokens].float() * d["embedding_multiplier"]
    every, offset = d["attn_every"], d["attn_offset"]
    for i in range(d["layers"]):
        sb, j = divmod(i, every)
        blocks = _at(w["blocks"], sb)
        n = rmsnorm(x, blocks["norm1"][j], eps)
        if j == offset:
            y = _attention(pr, _at(blocks["attn"], 0), n, d)
        else:
            y = _mamba(pr, _at(blocks["mamba"], j - (j > offset)), n, d,
                       reset_every)
        x = x + y * rm
        n = rmsnorm(x, blocks["norm2"][j], eps)
        y = _moe(pr, _at(blocks["moe"], j), n, d["top_k"])
        sh = _at(blocks["shared_mlp"], j)
        y = y + _swiglu(pr, n, sh["wg"], sh["wu"], sh["wd"])
        x = x + y * rm
    x = rmsnorm(x, w["final_norm"], eps)
    return pr.mm(x, w["embed"].t()) / d["logits_scaling"]


def dims(cfg) -> dict:
    """The numbers this reference reads, from the port's ``ArchConfig``
    (one attention layer a period, an MoE with a shared expert in every
    layer)."""
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return {
        "d_model": cfg.d_model, "layers": cfg.num_layers,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
        "norm_eps": cfg.norm_eps, "attn_every": cfg.attn_every,
        "attn_offset": cfg.attn_offset,
        "attn_scale": cfg.attention_multiplier
        or 1.0 / math.sqrt(cfg.resolved_head_dim),
        "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
        "d_ff_expert": cfg.moe.d_ff_expert,
        "d_ff_shared": cfg.moe.d_ff_shared,
        "ssm_heads": d_in // m.head_dim, "ssm_head_dim": m.head_dim,
        "d_state": m.d_state, "d_conv": m.d_conv, "ngroups": m.ngroups,
        "chunk": m.chunk_size,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "logits_scaling": cfg.logits_scaling,
    }

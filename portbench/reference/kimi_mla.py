"""Plain reference of Kimi-K2 (the DeepSeek-V3 equations Kimi-K2 ships in
``modeling_deepseek.py``), over a whole sequence from position 0.

Layer ``i`` is a pre-norm attention branch and a pre-norm FFN branch:

* attention is multi-head latent attention in its published, *expanded*
  form: ``q = q_b(RMSNorm(q_a(x)))`` split into ``q_nope`` and ``q_pe``;
  ``kv_a(x)`` split into the latent ``c`` (normed) and one ``k_pe`` for all
  heads; ``kv_b(c)`` split into each head's ``k_nope`` and ``v``; RoPE on
  ``q_pe`` and ``k_pe``; causal softmax over ``[q_nope, q_pe] . [k_nope,
  k_pe]`` times ``(nope + rope)^-0.5 * mscale^2``; ``o_proj`` over the heads'
  values.  RoPE is YaRN's: ``inv_freq = inter (1 - mask) + extra mask`` with
  ``extra = theta^(-2i/rope)``, ``inter = extra / factor``, ``mask = 1 -
  clamp((i - low) / (high - low), 0, 1)`` and (low, high) the correction
  range ``floor/ceil(rope ln(orig / (2 pi beta)) / (2 ln theta))`` at
  beta_fast and beta_slow; cos and sin times mscale(factor, mscale) /
  mscale(factor, mscale_all_dim); the vector's interleaved pairs gathered
  into halves before the rotation by halves (the published
  ``apply_rotary_pos_emb``).  Queries run in blocks of ``block``, so a
  33k-token sequence fits on the card;
* the FFN is a SwiGLU of width ``d_ff`` in the first ``first_dense`` layers;
  after them, routed experts plus a shared SwiGLU: scores ``sigmoid(x W)``
  over all ``experts`` in float32, the ``top_k`` of ``scores + bias``
  chosen, gates the chosen scores over their sum (+1e-20) times
  ``routed_scaling``; every chosen expert computes its token (no capacity).

A final RMSNorm, then the untied head at the positions asked for, over the
whole vocabulary.

Departures, each held alike by the program: weights come in the port's tree
(``dense_blocks`` and ``blocks`` stacked on a leading layer axis, the
experts on a second; ``wq_b`` and ``wkv_b`` as (rank, heads x dims));
``e_score_correction_bias`` is random (``router_bias``).  The deployment's
share of the experts: the router scores all ``experts`` and the chosen
experts outside ``[held_offset, held_offset + held)`` add nothing (the
weights hold the ``held`` alone), as on one card of the expert-parallel
deployment without its exchange.  Every product runs in float32
(``common.Precision``), TF32 off.  This module imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import Precision, rmsnorm, swiglu

# the routed choices of every MoE layer since the caller last cleared it
# ("routed") and those that landed on the held experts ("held")
CHOICES = {"routed": 0, "held": 0}


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(d: dict, device) -> tuple[torch.Tensor, float]:
    """(inv_freq (rope / 2,), the cos/sin scale)."""
    dim, base = d["rope_dim"], d["rope_theta"]
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim)
    f = d["yarn_factor"]
    if f <= 1:
        return extra, 1.0

    def corr(beta):
        return dim * math.log(d["yarn_original_max"] / (beta * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(corr(d["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(d["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    mask = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)
    inv = (extra / f) * (1 - mask) + extra * mask
    return inv, _mscale(f, d["yarn_mscale"]) / _mscale(
        f, d["yarn_mscale_all_dim"])


def softmax_scale(d: dict) -> float:
    s = (d["nope_dim"] + d["rope_dim"]) ** -0.5
    if d["yarn_factor"] > 1 and d["yarn_mscale_all_dim"]:
        s *= _mscale(d["yarn_factor"], d["yarn_mscale_all_dim"]) ** 2
    return s


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
         scale: float) -> torch.Tensor:
    """x (S, H, r): pairs (2i, 2i+1) gathered into halves, rotated."""
    s, h, r = x.shape
    x = x.view(s, h, r // 2, 2).transpose(-1, -2).reshape(s, h, r)
    ang = pos.float()[:, None] * inv
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(pr: Precision, p: dict, x: torch.Tensor, d: dict,
               block: int) -> torch.Tensor:
    """x (S, d_model) normed -> (S, d_model)."""
    s, h, eps = x.shape[0], d["heads"], d["norm_eps"]
    nope, rd, kr = d["nope_dim"], d["rope_dim"], d["kv_rank"]
    pos = torch.arange(s, device=x.device)
    inv, cs = yarn(d, x.device)
    q = pr.mm(rmsnorm(pr.mm(x, p["wq_a"]), p["q_norm"], eps), p["wq_b"])
    q = q.view(s, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, inv, cs)], -1)
    kv = pr.mm(x, p["wkv_a"])
    c = rmsnorm(kv[:, :kr], p["kv_norm"], eps)
    k_pe = rope(kv[:, None, kr:], pos, inv, cs)
    kvb = pr.mm(c, p["wkv_b"]).view(s, h, -1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(s, h, rd)], -1)
    v = kvb[..., nope:]
    kt, vt = k.permute(1, 2, 0), v.transpose(0, 1)      # (H, qk, S), (H, S, v)
    scale = softmax_scale(d)
    o = torch.empty(s, h, v.shape[-1], device=x.device)
    for a in range(0, s, block):
        b = min(s, a + block)
        sc = pr.mm(q[a:b].transpose(0, 1), kt[:, :, :b]) * scale
        hide = torch.arange(b, device=x.device)[None, :] > \
            torch.arange(a, b, device=x.device)[:, None]
        sc = sc.masked_fill(hide[None], float("-inf"))
        o[a:b] = pr.mm(torch.softmax(sc, dim=-1), vt[:, :b]).transpose(0, 1)
    return pr.mm(o.flatten(1), p["wo"].flatten(0, 1))


def _moe(pr: Precision, p: dict, x: torch.Tensor, d: dict) -> torch.Tensor:
    """The held experts' part of the routed experts, x (S, d) normed."""
    scores = torch.sigmoid(x @ p["router"].float())
    pick = scores + p["router_bias"].float() if "router_bias" in p else scores
    experts = torch.topk(pick, d["top_k"], dim=-1).indices
    gates = scores.gather(-1, experts)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * d["routed_scaling"]
    y = torch.zeros_like(x)
    lo, held = d["held_offset"], d["held"]
    CHOICES["routed"] += experts.numel()
    CHOICES["held"] += int(((experts >= lo) & (experts < lo + held)).sum())
    for e in torch.unique(experts).tolist():
        if not lo <= e < lo + held:
            continue
        tok, slot = (experts == e).nonzero(as_tuple=True)
        out = swiglu(pr, x[tok], p["wg"][e - lo], p["wu"][e - lo],
                     p["wd"][e - lo])
        y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@torch.no_grad()
def logits(w: dict, tokens: torch.Tensor, d: dict, pr: Precision,
           at: torch.Tensor, block: int = 256) -> torch.Tensor:
    """tokens (S,) of one sequence from position 0 -> float32 logits (len
    at, vocab) at the positions ``at``."""
    eps = d["norm_eps"]
    x = w["embed"][tokens].float()
    for i in range(d["layers"]):
        dense = i < d["first_dense"]
        p = _at(w["dense_blocks"] if dense else w["blocks"],
                i if dense else i - d["first_dense"])
        x = x + _attention(pr, p["attn"], rmsnorm(x, p["norm1"], eps), d,
                           block)
        n = rmsnorm(x, p["norm2"], eps)
        if dense:
            y = swiglu(pr, n, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
        else:
            sh = p["shared_mlp"]
            y = _moe(pr, p["moe"], n, d) + swiglu(pr, n, sh["wg"], sh["wu"],
                                                 sh["wd"])
        x = x + y
    x = rmsnorm(x[at], w["final_norm"], eps)
    return pr.mm(x, w["head"])


def dims(cfg) -> dict:
    """The numbers this reference reads, from the port's ``ArchConfig``."""
    m = cfg.moe
    return {
        "d_model": cfg.d_model, "layers": cfg.num_layers,
        "heads": cfg.num_heads, "vocab": cfg.vocab_size,
        "norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "q_rank": cfg.mla_q_rank, "kv_rank": cfg.mla_kv_rank,
        "nope_dim": cfg.mla_nope_dim, "rope_dim": cfg.mla_rope_dim,
        "v_dim": cfg.mla_v_dim, "yarn_factor": cfg.yarn_factor,
        "yarn_original_max": cfg.yarn_original_max,
        "yarn_beta_fast": cfg.yarn_beta_fast,
        "yarn_beta_slow": cfg.yarn_beta_slow, "yarn_mscale": cfg.yarn_mscale,
        "yarn_mscale_all_dim": cfg.yarn_mscale_all_dim,
        "first_dense": m.first_dense, "d_ff": cfg.d_ff,
        "experts": m.num_experts, "top_k": m.top_k,
        "d_ff_expert": m.d_ff_expert, "d_ff_shared": m.d_ff_shared,
        "routed_scaling": m.routed_scaling,
        "held": m.held_experts or m.num_experts, "held_offset": m.held_offset,
        "mla_layers": cfg.num_layers,
    }

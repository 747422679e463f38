"""Plain reference of the decoder-only mixture-of-experts model (the
qwen3-moe stack as the port states it): embedding, ``layers`` pre-norm
blocks of causal GQA self-attention with RoPE and a routed SwiGLU FFN, a
final RMSNorm and an untied head.

Routing is the published rule: softmax over the experts in float32, the
top ``top_k`` taken, their probabilities renormalised to sum to one, and
every token computed by every expert it chose: no capacity, no dropped
token.  Weights come in the benchmark's tree (``blocks`` stacked on a
leading layer axis, the experts on a second), in the dtype they are served
in; every product runs in float32 here (``common.Precision``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, attention, rmsnorm, rope


def _moe(pr: Precision, p: dict, x: torch.Tensor, layer: int,
         top_k: int) -> torch.Tensor:
    """x (S, d) -> (S, d)."""
    probs = torch.softmax(x @ p["router"][layer].float(), dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(x)
    for e in torch.unique(experts).tolist():
        tok, slot = (experts == e).nonzero(as_tuple=True)
        xe = x[tok]
        h = F.silu(pr.mm(xe, p["wg"][layer, e])) * pr.mm(xe, p["wu"][layer, e])
        y.index_add_(0, tok, pr.mm(h, p["wd"][layer, e])
                     * gates[tok, slot, None])
    return y


@torch.no_grad()
def logits(w: dict, tokens: torch.Tensor, dims: dict,
           pr: Precision) -> torch.Tensor:
    """tokens (S,) -> float32 logits (S, vocab) of one sequence from
    position 0."""
    eps, theta = dims["norm_eps"], dims["rope_theta"]
    blocks = w["blocks"]
    x = w["embed"][tokens].float()
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    for i in range(dims["layers"]):
        a = blocks["attn"]
        n = rmsnorm(x, blocks["norm1"][i], eps)
        q = pr.mm(n, a["wq"][i].flatten(1)).view(1, s, *a["wq"].shape[2:])
        k = pr.mm(n, a["wk"][i].flatten(1)).view(1, s, *a["wk"].shape[2:])
        v = pr.mm(n, a["wv"][i].flatten(1)).view(1, s, *a["wv"].shape[2:])
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        o = attention(pr, q, k, v, causal=True)[0]
        x = x + pr.mm(o.flatten(1), a["wo"][i].flatten(0, 1))
        n = rmsnorm(x, blocks["norm2"][i], eps)
        x = x + _moe(pr, blocks["moe"], n, i, dims["top_k"])
    x = rmsnorm(x, w["final_norm"], eps)
    return pr.mm(x, w["head"])

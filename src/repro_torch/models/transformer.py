"""Decoder-only transformer stack, dense family: init, prefill, decode.

Reached through :func:`repro_torch.models.build.build_model`, which refuses
the families not ported yet.

Block parameters are stacked on a leading ``layers`` axis, as in the JAX
package, so parameter trees cross between the packages unchanged; the JAX
``lax.scan`` over that axis is a Python loop over it here.  Training
(``loss_fn``, ``run_stack``, remat) waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def init_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One decoder block: attention + SwiGLU MLP."""
    dev = gen.device
    return {
        "attn": L.init_attention(gen, cfg),
        "norm1": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "norm2": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on ``gen.device``, keyed and shaped as the JAX
    package's (blocks stacked on a leading layer axis)."""
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.param_dtype),
        "blocks": _stack([init_block(gen, cfg) for _ in range(cfg.num_layers)]),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._init_dense(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, cfg.param_dtype
        )
    return params


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block parameters (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"], True
    return params["head"], False


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype, device):
    one = L.init_kv_cache(batch, max_len, cfg, dtype, device)
    return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in one.items()}


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """Forward pass writing the KV cache; returns (last-token logits, cache).

    tokens: (B, S) integer.
    """
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], tokens, cdt)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    cache = init_cache(b, max_len, cfg, cdt, tokens.device)
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        lc = {k: v[i] for k, v in cache.items()}
        n = L.rmsnorm(h, bp["norm1"], cfg.norm_eps, cdt)
        a, _ = L.attention_prefill(bp["attn"], n, cfg, positions=positions,
                                   cache=lc)
        h = h + a
        n = L.rmsnorm(h, bp["norm2"], cfg.norm_eps, cdt)
        h = h + L.mlp(bp["mlp"], n, cdt)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    w, transpose = head_weight(params, cfg)
    return L.logits_head(w, h[:, -1:], transpose=transpose), cache


def decode_step(params, cache, token, cache_len: int, cfg: ArchConfig):
    """token: (B,1) integer; cache_len: int.  Returns (logits, cache); the
    cache is updated in place."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], token, cdt)
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        lc = {k: v[i] for k, v in cache.items()}
        n = L.rmsnorm(h, bp["norm1"], cfg.norm_eps, cdt)
        a, _ = L.attention_decode(bp["attn"], n, cfg, cache=lc,
                                  cache_len=cache_len)
        h = h + a
        n = L.rmsnorm(h, bp["norm2"], cfg.norm_eps, cdt)
        h = h + L.mlp(bp["mlp"], n, cdt)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    w, transpose = head_weight(params, cfg)
    return L.logits_head(w, h, transpose=transpose), cache

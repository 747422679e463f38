"""Pure-SSM stack (Mamba-2): init, loss, prefill, decode.

The torch counterpart of the ``ssm`` branches of the JAX package's
``models/hybrid.py``.  Block parameters are stacked on a leading ``layers``
axis, as there, and the JAX ``lax.scan`` over that axis is a Python loop.
The hybrid (Jamba) superblock is not ported yet: every entry point raises
for the ``hybrid`` family.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models.transformer import (
    _remat,
    _stack,
    head_weight,
    unbind_layers,
)


def _ssm_only(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} superblock is not ported yet "
            "(ROADMAP.md, 'the jamba superblock')"
        )


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on ``gen.device``, keyed and shaped as the JAX
    package's (blocks stacked on a leading layer axis)."""
    _ssm_only(cfg)
    dev = gen.device
    emb = L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    blocks = _stack([
        {"mixer": MB.init_mamba(gen, cfg),
         "norm": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
        for _ in range(cfg.num_layers)
    ])
    params = {"embed": emb, "blocks": blocks,
              "final_norm": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
    if not cfg.tie_embeddings:
        params["head"] = L._init_dense(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, cfg.param_dtype
        )
    return params


def run_stack(params, x, cfg: ArchConfig, *, positions=None):
    """The block stack, each layer under the config's remat.  Returns
    (hidden, aux_loss_sum); the SSM stack has no auxiliary loss."""
    _ssm_only(cfg)

    def body(h, bp):
        n = L.rmsnorm(h, bp["norm"], cfg.norm_eps, cfg.compute_dtype)
        y, _ = MB.mamba_forward(bp["mixer"], n, cfg)
        return h + y

    body = _remat(body, cfg)
    for bp in unbind_layers(params["blocks"]):
        x = body(x, bp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch, cfg: ArchConfig):
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], batch["tokens"], cdt)
    h, aux = run_stack(params, h, cfg)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    w, transpose = head_weight(params, cfg)
    ce = L.chunked_xent(
        h, w, batch["labels"], transpose=transpose, chunk=cfg.loss_chunk
    )
    return ce + aux, {"ce": ce, "aux": aux}


# -- serving ----------------------------------------------------------------


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype, device):
    """Per-layer conv tails and SSM state, stacked on a leading layer axis
    (``max_len`` is unused: the state does not grow)."""
    _ssm_only(cfg)
    one = MB.init_mamba_cache(batch, cfg, dtype, device)
    return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in one.items()}


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """Forward pass over the prompt; returns (last-token logits, cache).

    tokens: (B, S) integer.
    """
    _ssm_only(cfg)
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], tokens, cdt)
    caches = []
    for bp in unbind_layers(params["blocks"]):
        n = L.rmsnorm(h, bp["norm"], cfg.norm_eps, cdt)
        y, st = MB.mamba_forward(bp["mixer"], n, cfg)
        h = h + y
        caches.append(st)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    w, transpose = head_weight(params, cfg)
    return L.logits_head(w, h[:, -1:], transpose=transpose), _stack(caches)


def decode_step(params, cache, token, cache_len: int, cfg: ArchConfig):
    """token: (B,1) integer.  Returns (logits, new cache)."""
    _ssm_only(cfg)
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], token, cdt)
    caches = []
    for i, bp in enumerate(unbind_layers(params["blocks"])):
        n = L.rmsnorm(h, bp["norm"], cfg.norm_eps, cdt)
        y, st = MB.mamba_step(bp["mixer"], n, cfg,
                              {k: v[i] for k, v in cache.items()})
        h = h + y
        caches.append(st)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    w, transpose = head_weight(params, cfg)
    return L.logits_head(w, h, transpose=transpose), _stack(caches)

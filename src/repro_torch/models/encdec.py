"""Encoder-decoder transformer (the SeamlessM4T-v2 backbone, ``audio``
family): init, loss, prefill, decode.

The torch counterpart of the JAX package's ``models/encdec.py``.  The audio
frontend is a stub, as there: the batch carries precomputed frame embeddings
(B, S_src, frontend_dim), which a learned linear maps to d_model.  Encoder
layers are bidirectional self-attention + FFN; decoder layers are causal
self-attention + cross-attention over the encoder memory + FFN.  Every
attention is the flash-attention op: the encoder's and the cross-attention
with ``causal=False`` (no RoPE on the cross q, k and v), the decoder's
self-attention causal.

Parameters have the JAX package's keys and shapes: ``encoder`` and
``decoder`` stacked on a leading layer axis, ``embed``, ``frontend``,
``enc_norm``, ``final_norm`` and the untied ``head``.  Both stacks run each
layer under the config's remat.  Serving projects the cross K/V once at
prefill and reuses them at every decode step.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (
    _prefix_layers,
    _remat,
    _stack,
    head_weight,
    logits,
    prenorm_layer,
    unbind_layers,
)


def _init_enc_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt, dev = cfg.param_dtype, gen.device
    return {"attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt),
            "norm1": L.init_rmsnorm(cfg.d_model, dt, dev),
            "norm2": L.init_rmsnorm(cfg.d_model, dt, dev)}


def _init_dec_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dt, dev = cfg.param_dtype, gen.device
    p = {"self": L.init_attention(gen, cfg),
         "cross": L.init_attention(gen, cfg),
         "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt)}
    for i in (1, 2, 3):
        p[f"norm{i}"] = L.init_rmsnorm(cfg.d_model, dt, dev)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on ``gen.device``, keyed and shaped as the JAX
    package's."""
    dt, dev = cfg.param_dtype, gen.device
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "frontend": L._init_dense(gen, (cfg.frontend_dim, cfg.d_model),
                                  cfg.frontend_dim, dt),
        "encoder": _stack([_init_enc_layer(gen, cfg)
                           for _ in range(cfg.encoder_layers)]),
        "decoder": _stack([_init_dec_layer(gen, cfg)
                           for _ in range(cfg.num_layers)]),
        "enc_norm": L.init_rmsnorm(cfg.d_model, dt, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._init_dense(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, dt)
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of :func:`init_params`'s leaves: the axes tree the
    JAX package's ``init_params`` returns beside the parameters."""
    enc = {"attn": L.attention_axes(cfg), "mlp": dict(L.MLP_AXES),
           "norm1": L.RMSNORM_AXES, "norm2": L.RMSNORM_AXES}
    dec = {"self": L.attention_axes(cfg), "cross": L.attention_axes(cfg),
           "mlp": dict(L.MLP_AXES)}
    for i in (1, 2, 3):
        dec[f"norm{i}"] = L.RMSNORM_AXES
    axes = {"embed": L.EMBED_AXES, "frontend": ("frontend", "embed"),
            "encoder": _prefix_layers(enc), "decoder": _prefix_layers(dec),
            "enc_norm": L.RMSNORM_AXES, "final_norm": L.RMSNORM_AXES}
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params, frames, cfg: ArchConfig):
    """frames: (B, S_src, frontend_dim) -> (B, S_src, D) memory."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.proj(frames.to(cdt), params["frontend"].to(cdt))
    positions = _positions(h.shape[0], h.shape[1], h.device)

    def body(hh, lp):
        return prenorm_layer(lp, hh, cfg, ("norm1", lambda n: L.attention(
            lp["attn"], n, cfg, positions=positions, bidirectional=True)))[0]

    body = _remat(body, cfg)
    for lp in unbind_layers(params["encoder"]):
        h = body(h, lp)
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps, cdt)


def _decoder_stack(params, h, memory, cfg: ArchConfig, *, positions):
    def body(hh, lp, mem):
        def cross(n):
            ckv = L.cross_kv_from_memory(lp["cross"], mem, cfg)
            return L.attention(lp["cross"], n, cfg, positions=positions,
                               cross_kv=ckv)

        return prenorm_layer(lp, hh, cfg, ("norm1", lambda n: L.attention(
            lp["self"], n, cfg, positions=positions)), ("norm2", cross))[0]

    body = _remat(body, cfg)
    for lp in unbind_layers(params["decoder"]):
        h = body(h, lp, memory)
    return h


def loss_fn(params, batch, cfg: ArchConfig):
    """batch: frames (B, S_src, F), tokens (B, S_tgt), labels (B, S_tgt).
    Returns (ce, {"ce", "aux"}); the aux loss is zero."""
    memory = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    h = L.embed(params["embed"], tokens, cfg)
    h = _decoder_stack(params, h, memory, cfg,
                       positions=_positions(*tokens.shape, tokens.device))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.compute_dtype)
    w, kw = head_weight(params, cfg)
    ce = L.chunked_xent(h, w, batch["labels"], chunk=cfg.loss_chunk, **kw)
    return ce, {"ce": ce,
                "aux": torch.zeros((), dtype=torch.float32, device=h.device)}


# -- serving ----------------------------------------------------------------


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype, device):
    """Per decoder layer, stacked: the self-attention KV cache and the
    cross K/V of a ``source_len``-long memory."""
    shape = (cfg.num_layers, batch, cfg.source_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    kv = L.init_kv_cache(batch, max_len, cfg, dtype, device)
    return {
        "self": {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                                dtype=v.dtype, device=device)
                 for k, v in kv.items()},
        "cross": {k: torch.zeros(shape, dtype=L.dtype_of(dtype),
                                 device=device) for k in ("k", "v")},
    }


def cache_axes(cfg: ArchConfig) -> dict:
    axes = ("batch", "seq", "kv_heads", "head_dim")
    return _prefix_layers({"self": L.kv_cache_axes(cfg),
                           "cross": {"k": axes, "v": axes}})


def prefill(params, tokens, cfg: ArchConfig, max_len: int, frames=None):
    """Encode the source frames (B, source_len, F), then run the target
    prefix tokens (B, S) through the decoder, writing its self-attention
    cache and the cross K/V.  Returns (last-token logits, cache)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs its "
                         "frames")
    if frames.shape[1] != cfg.source_len:
        raise ValueError(
            f"{cfg.name}: prefill frames are {frames.shape[1]} long, the "
            f"cross-attention cache holds source_len = {cfg.source_len}")
    cdt = L.dtype_of(cfg.compute_dtype)
    memory = encode(params, frames, cfg)
    h = L.embed(params["embed"], tokens, cfg)
    positions = _positions(*tokens.shape, tokens.device)
    cache = init_cache(tokens.shape[0], max_len, cfg, cdt, tokens.device)

    def attn(p, self_cache, n):
        return L.attention_prefill(p, n, cfg, positions=positions,
                                   cache=self_cache)[0]

    def cross(p, i, n):
        ck, cv = L.cross_kv_from_memory(p, memory, cfg)
        cache["cross"]["k"][i] = ck
        cache["cross"]["v"][i] = cv
        return L.attention(p, n, cfg, positions=positions, cross_kv=(ck, cv))

    for i, lp in enumerate(unbind_layers(params["decoder"])):
        self_cache = {k: v[i] for k, v in cache["self"].items()}
        h, _ = prenorm_layer(lp, h, cfg,
                             ("norm1", partial(attn, lp["self"], self_cache)),
                             ("norm2", partial(cross, lp["cross"], i)))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    return logits(params, h[:, -1:], cfg), cache


def decode_step(params, cache, token, cache_len: int, cfg: ArchConfig):
    """token: (B,1) integer.  Returns (logits, cache); the self-attention
    cache is updated in place, the cross K/V are read."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], token, cfg)

    def attn(p, i, n):
        return L.attention_decode(
            p, n, cfg, cache={k: v[i] for k, v in cache["self"].items()},
            cache_len=cache_len)[0]

    def cross(p, i, n):
        ckv = (cache["cross"]["k"][i].to(cdt), cache["cross"]["v"][i].to(cdt))
        return L.attention(p, n, cfg, positions=None, cross_kv=ckv)

    for i, lp in enumerate(unbind_layers(params["decoder"])):
        h, _ = prenorm_layer(lp, h, cfg,
                             ("norm1", partial(attn, lp["self"], i)),
                             ("norm2", partial(cross, lp["cross"], i)))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    return logits(params, h, cfg), cache

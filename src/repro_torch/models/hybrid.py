"""Hybrid attention/Mamba stack (Jamba) and pure-SSM stack (Mamba-2): init,
loss, prefill, decode.

The torch counterpart of the JAX package's ``models/hybrid.py``.  Jamba
interleaves 1 attention : 7 mamba layers per period of 8 and swaps the dense
FFN for MoE on every other layer.  The stack runs over *superblocks* (one
interleave period each), whose parameters are stacked per kind of sublayer
(``attn``, ``mamba``, ``mlp``, ``moe``, and the period's ``norm1``/``norm2``),
as there; the JAX ``lax.scan`` over superblocks is a Python loop, each
superblock under the config's remat.  The pure-SSM family (mamba2) runs
homogeneous mixer-only layers stacked on a leading ``layers`` axis.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as M
from repro_torch.models.transformer import (
    _prefix_layers,
    _remat,
    _stack,
    head_weight,
    layer,
    logits,
    prenorm_layer,
    shared_width,
    unbind_layers,
)

# ---------------------------------------------------------------------------
# Jamba superblocks
# ---------------------------------------------------------------------------


def _sublayer_kinds(cfg: ArchConfig):
    """Static description of one interleave period: list of (mixer, ffn)."""
    kinds = []
    for j in range(cfg.attn_every):
        mixer = "attn" if j == cfg.attn_offset else "mamba"
        if cfg.moe is not None and j % cfg.moe.every_k == cfg.moe.offset:
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "mlp"
        else:
            ffn = "none"
        kinds.append((mixer, ffn))
    return kinds


def _n_mamba(cfg: ArchConfig) -> int:
    return sum(1 for m, _ in _sublayer_kinds(cfg) if m == "mamba")


def _kind_counts(cfg: ArchConfig) -> dict:
    """Sublayers of each kind in one period; a shared expert beside each
    MoE where the config has one."""
    kinds = _sublayer_kinds(cfg)
    counts = {k: sum(1 for m, f in kinds if k in (m, f))
              for k in ("attn", "mamba", "mlp", "moe")}
    if cfg.moe is not None and cfg.moe.num_shared_experts:
        counts["shared_mlp"] = counts["moe"]
    return counts


def init_superblock(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One period's parameters, stacked per kind of sublayer."""
    kinds = _sublayer_kinds(cfg)
    dt, dev = cfg.param_dtype, gen.device
    counts = _kind_counts(cfg)
    inits = {
        "attn": lambda: L.init_attention(gen, cfg),
        "mamba": lambda: MB.init_mamba(gen, cfg),
        "mlp": lambda: L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt),
        "moe": lambda: M.init_moe(gen, cfg.d_model, cfg.moe, dt),
        "shared_mlp": lambda: L.init_mlp(gen, cfg.d_model, shared_width(cfg),
                                         dt),
    }
    params = {k: _stack([inits[k]() for _ in range(n)])
              for k, n in counts.items() if n}
    for name in ("norm1", "norm2"):
        params[name] = torch.ones((len(kinds), cfg.d_model),
                                  dtype=L.dtype_of(dt), device=dev)
    return params


def superblock_axes(cfg: ArchConfig) -> dict:
    """The logical axes of :func:`init_superblock`'s leaves: each kind's
    stack with a leading ``layers`` axis, the period's norms
    ``("layers", "embed")``."""
    per_kind = {
        "attn": lambda: L.attention_axes(cfg),
        "mamba": lambda: MB.mamba_axes(cfg),
        "mlp": lambda: dict(L.MLP_AXES),
        "moe": lambda: M.moe_axes(cfg.moe),
        "shared_mlp": lambda: dict(L.MLP_AXES),
    }
    axes = {k: _prefix_layers(per_kind[k]()) for k, n in
            _kind_counts(cfg).items() if n}
    axes["norm1"] = axes["norm2"] = ("layers", "embed")
    return axes


def period_layers(p: dict, cfg: ArchConfig):
    """Each sublayer of one period, in order: (mixer, the mixer's index
    among the period's sublayers of its kind, its parameters keyed as a
    transformer block's: ``attn`` or ``mamba``; ``moe`` (with
    ``shared_mlp`` where the config has one) or ``mlp`` where it has an
    FFN; ``norm1``, ``norm2``), views of the period's stacked leaves."""
    per_kind = {k: unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in p.items()}
    seen = dict.fromkeys(per_kind, 0)
    for j, (mixer, ffn) in enumerate(_sublayer_kinds(cfg)):
        used = [mixer] + ([] if ffn == "none" else [ffn])
        if ffn == "moe" and "shared_mlp" in per_kind:
            used.append("shared_mlp")
        sp = {k: per_kind[k][seen[k]] for k in used}
        sp.update(norm1=per_kind["norm1"][j], norm2=per_kind["norm2"][j])
        yield mixer, seen[mixer], sp
        for k in used:
            seen[k] += 1


def stack_layers(params: dict, cfg: ArchConfig):
    """Each layer of the whole stack, in order: (mixer, the mixer's index
    among the stack's layers of its kind, its parameters as
    :func:`period_layers` gives them)."""
    seen = {"attn": 0, "mamba": 0}
    for sb in range(_n_superblocks(cfg)):
        for mixer, _, sp in period_layers(layer(params["blocks"], sb), cfg):
            yield mixer, seen[mixer], sp
            seen[mixer] += 1


def _kept(states: list, out):
    """A Mamba mixer's ``(y, state)`` as a layer's branch: appends the
    state to ``states`` and returns y."""
    y, st = out
    states.append(st)
    return y


def apply_superblock(p, x, cfg: ArchConfig, *, positions, caches=None,
                     decode_len=None):
    """Apply one interleave period.

    caches: optional {"kv": one layer's KV cache, "ssm": the period's mamba
    caches stacked (n_mamba, ...)}; when given, attention takes the prefill
    path (``decode_len`` None) or the decode path, writing the KV cache in
    place.  Returns (x, aux, new_caches), new_caches {"kv", "ssm"} with the
    mamba layers' new states stacked, or None without caches.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_ssm = []
    if caches is None:
        attn = lambda ap, i, h: L.attention(ap, h, cfg, positions=positions)
        mamba = lambda mp, i, h: MB.mamba_forward(mp, h, cfg)[0]
    elif decode_len is None:
        attn = lambda ap, i, h: L.attention_prefill(
            ap, h, cfg, positions=positions, cache=caches["kv"])[0]
        mamba = lambda mp, i, h: _kept(new_ssm, MB.mamba_forward(mp, h, cfg))
    else:
        attn = lambda ap, i, h: L.attention_decode(
            ap, h, cfg, cache=caches["kv"], cache_len=decode_len)[0]
        mamba = lambda mp, i, h: _kept(new_ssm, MB.mamba_step(
            mp, h, cfg, {k: v[i] for k, v in caches["ssm"].items()}))
    for mixer, i, sp in period_layers(p, cfg):
        fn = partial(attn if mixer == "attn" else mamba, sp[mixer], i)
        x, a = prenorm_layer(sp, x, cfg, ("norm1", fn))
        if "moe" in sp:
            aux = aux + a
    new_caches = None
    if caches is not None:
        new_caches = {"kv": caches["kv"], "ssm": _stack(new_ssm)}
    return x, aux, new_caches


# ---------------------------------------------------------------------------
# Full models (shared by the hybrid and ssm families)
# ---------------------------------------------------------------------------


def _n_superblocks(cfg: ArchConfig) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole "
                         f"periods of {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on ``gen.device``, keyed and shaped as the JAX
    package's (blocks stacked on a leading layer or superblock axis)."""
    dev = gen.device
    emb = L.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype)
    if cfg.family == "ssm":
        blocks = _stack([
            {"mixer": MB.init_mamba(gen, cfg),
             "norm": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
            for _ in range(cfg.num_layers)
        ])
    else:
        blocks = _stack([init_superblock(gen, cfg)
                         for _ in range(_n_superblocks(cfg))])
    params = {"embed": emb, "blocks": blocks,
              "final_norm": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
    if not cfg.tie_embeddings:
        params["head"] = L._init_dense(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, cfg.param_dtype
        )
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of :func:`init_params`'s leaves: the axes tree the
    JAX package's ``init_params`` returns beside the parameters (a hybrid
    superblock's stacked leaves carry ``layers`` twice, as there)."""
    if cfg.family == "ssm":
        blocks = {"mixer": MB.mamba_axes(cfg), "norm": L.RMSNORM_AXES}
    else:
        blocks = superblock_axes(cfg)
    axes = {"embed": L.EMBED_AXES, "blocks": _prefix_layers(blocks),
            "final_norm": L.RMSNORM_AXES}
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


def run_stack(params, x, cfg: ArchConfig, *, positions):
    """The block stack, each layer (ssm) or superblock (hybrid) under the
    config's remat.  Returns (hidden, aux_loss_sum): the MoE aux losses of
    the hybrid stack, zero for the SSM stack."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        def body(h, bp):
            return prenorm_layer(bp, h, cfg, ("norm", lambda n: (
                MB.mamba_forward(bp["mixer"], n, cfg)[0])))[0]

        body = _remat(body, cfg)
        for bp in unbind_layers(params["blocks"]):
            x = body(x, bp)
        return x, aux

    def sb_body(h, bp):
        h, a, _ = apply_superblock(bp, h, cfg, positions=positions)
        return h, a

    sb_body = _remat(sb_body, cfg)
    for bp in unbind_layers(params["blocks"]):
        x, a = sb_body(x, bp)
        aux = aux + a
    return x, aux


def _positions(tokens):
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def loss_fn(params, batch, cfg: ArchConfig):
    h = L.embed(params["embed"], batch["tokens"], cfg)
    positions = None if cfg.family == "ssm" else _positions(batch["tokens"])
    h, aux = run_stack(params, h, cfg, positions=positions)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.compute_dtype)
    w, kw = head_weight(params, cfg)
    ce = L.chunked_xent(h, w, batch["labels"], chunk=cfg.loss_chunk, **kw)
    return ce + aux, {"ce": ce, "aux": aux}


# -- serving ----------------------------------------------------------------


def _zeros_stacked(tree: dict, n: int) -> dict:
    return {k: _zeros_stacked(v, n) if isinstance(v, dict) else
            torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype, device):
    """ssm: per-layer conv tails and SSM state, stacked on a leading layer
    axis (``max_len`` is unused: the state does not grow).  hybrid: per
    superblock, its attention layer's KV cache and its mamba layers' caches
    stacked: {"kv": (n_sb, B, max_len, K, hd), "ssm": (n_sb, n_mamba, ...)}."""
    ssm = MB.init_mamba_cache(batch, cfg, dtype, device)
    if cfg.family == "ssm":
        return _zeros_stacked(ssm, cfg.num_layers)
    one = {"kv": L.init_kv_cache(batch, max_len, cfg, dtype, device),
           "ssm": _zeros_stacked(ssm, _n_mamba(cfg))}
    return _zeros_stacked(one, _n_superblocks(cfg))


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical axes of :func:`init_cache`'s tree, as the JAX package's."""
    if cfg.family == "ssm":
        return _prefix_layers(dict(MB.MAMBA_CACHE_AXES))
    return _prefix_layers({"kv": L.kv_cache_axes(cfg),
                           "ssm": _prefix_layers(dict(MB.MAMBA_CACHE_AXES))})


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """Forward pass over the prompt; returns (last-token logits, cache).

    tokens: (B, S) integer.  The hybrid cache is :func:`init_cache`'s, its
    KV caches written in place and its SSM states those of the prompt.
    """
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], tokens, cfg)
    caches = []
    if cfg.family == "ssm":
        mamba = lambda mp, n: _kept(caches, MB.mamba_forward(mp, n, cfg))
        for bp in unbind_layers(params["blocks"]):
            h, _ = prenorm_layer(bp, h, cfg,
                                 ("norm", partial(mamba, bp["mixer"])))
        cache = _stack(caches)
    else:
        positions = _positions(tokens)
        cache = init_cache(h.shape[0], max_len, cfg, cdt, tokens.device)
        for i, bp in enumerate(unbind_layers(params["blocks"])):
            cache_in = {"kv": {k: v[i] for k, v in cache["kv"].items()},
                        "ssm": {k: v[i] for k, v in cache["ssm"].items()}}
            h, _, new = apply_superblock(bp, h, cfg, positions=positions,
                                         caches=cache_in)
            caches.append(new["ssm"])
        cache = {"kv": cache["kv"], "ssm": _stack(caches)}
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    return logits(params, h[:, -1:], cfg), cache


def decode_step(params, cache, token, cache_len: int, cfg: ArchConfig):
    """token: (B,1) integer.  Returns (logits, new cache); the hybrid KV
    caches are updated in place."""
    h = L.embed(params["embed"], token, cfg)
    caches = []
    if cfg.family == "ssm":
        mamba = lambda mp, i, n: _kept(caches, MB.mamba_step(
            mp, n, cfg, {k: v[i] for k, v in cache.items()}))
        for i, bp in enumerate(unbind_layers(params["blocks"])):
            h, _ = prenorm_layer(bp, h, cfg,
                                 ("norm", partial(mamba, bp["mixer"], i)))
        new_cache = _stack(caches)
    else:
        for i, bp in enumerate(unbind_layers(params["blocks"])):
            cache_in = {"kv": {k: v[i] for k, v in cache["kv"].items()},
                        "ssm": {k: v[i] for k, v in cache["ssm"].items()}}
            h, _, new = apply_superblock(bp, h, cfg, positions=None,
                                         caches=cache_in, decode_len=cache_len)
            caches.append(new["ssm"])
        new_cache = {"kv": cache["kv"], "ssm": _stack(caches)}
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.compute_dtype)
    return logits(params, h, cfg), new_cache

"""Decoder-only transformer stack (dense / moe / vlm families): init, loss,
prefill, decode.

Reached through :func:`repro_torch.models.build.build_model`.

Block parameters are stacked on a leading ``layers`` axis, as in the JAX
package, so parameter trees cross between the packages unchanged; the JAX
``lax.scan`` over that axis is a Python loop over it here, each layer under
the config's remat (:func:`_remat`).  A block's FFN is the SwiGLU MLP or,
in the ``moe`` family, the routed experts (plus a shared expert where the
config has one); the ``vlm`` family prepends projected patch embeddings to
the text.  A config with ``moe.first_dense`` keeps its leading dense layers
in a stack of their own (``params["dense_blocks"]``), run ahead of
``blocks``; one with latent attention (``cfg.is_mla``) has
``models/mla.py``'s mixer in every layer, and is served through the paged
engine alone (the whole-cache prefill and decode refuse it).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as M
from repro_torch.models import sharding as S


def init_block(gen: torch.Generator, cfg: ArchConfig,
               dense: bool = False) -> dict:
    """One decoder block: attention (MLA where the config has it) + FFN
    (dense, or MoE [+ shared expert]; ``dense``: one of the leading dense
    layers of a config with ``moe.first_dense``)."""
    dev = gen.device
    params = {
        "attn": MLA.init_mla(gen, cfg) if cfg.is_mla
        else L.init_attention(gen, cfg),
        "norm1": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "norm2": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
    }
    if cfg.moe is not None and cfg.moe.every_k == 1 and not dense:
        params["moe"] = M.init_moe(gen, cfg.d_model, cfg.moe, cfg.param_dtype)
        if cfg.moe.num_shared_experts:
            params["shared_mlp"] = L.init_mlp(
                gen, cfg.d_model, shared_width(cfg), cfg.param_dtype)
    else:
        params["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    return params


def block_axes(cfg: ArchConfig, dense: bool = False) -> dict:
    """The logical axes of :func:`init_block`'s leaves."""
    axes = {"attn": dict(MLA.MLA_AXES) if cfg.is_mla
            else L.attention_axes(cfg),
            "norm1": L.RMSNORM_AXES, "norm2": L.RMSNORM_AXES}
    if cfg.moe is not None and cfg.moe.every_k == 1 and not dense:
        axes["moe"] = M.moe_axes(cfg.moe)
        if cfg.moe.num_shared_experts:
            axes["shared_mlp"] = dict(L.MLP_AXES)
    else:
        axes["mlp"] = dict(L.MLP_AXES)
    return axes


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _prefix_layers(axes: dict) -> dict:
    """Prepend the stacked ``layers`` axis to every logical-axes tuple."""
    return {k: _prefix_layers(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in axes.items()}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on ``gen.device``, keyed and shaped as the JAX
    package's (blocks stacked on a leading layer axis)."""
    n_dense = first_dense(cfg)
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.param_dtype),
        "blocks": _stack([init_block(gen, cfg)
                          for _ in range(cfg.num_layers - n_dense)]),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, gen.device),
    }
    if n_dense:
        params["dense_blocks"] = _stack([init_block(gen, cfg, dense=True)
                                         for _ in range(n_dense)])
    if not cfg.tie_embeddings:
        params["head"] = L._init_dense(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, cfg.param_dtype
        )
    if cfg.num_patches:  # vlm multimodal projector
        params["projector"] = {
            "w1": L._init_dense(gen, (cfg.vision_dim, cfg.d_model),
                                cfg.vision_dim, cfg.param_dtype),
            "w2": L._init_dense(gen, (cfg.d_model, cfg.d_model), cfg.d_model,
                                cfg.param_dtype),
        }
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of :func:`init_params`'s leaves: the axes tree the
    JAX package's ``init_params`` returns beside the parameters."""
    axes = {"embed": L.EMBED_AXES,
            "blocks": _prefix_layers(block_axes(cfg)),
            "final_norm": L.RMSNORM_AXES}
    if first_dense(cfg):
        axes["dense_blocks"] = _prefix_layers(block_axes(cfg, dense=True))
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    if cfg.num_patches:
        axes["projector"] = {"w1": ("frontend", "embed"),
                             "w2": ("embed", "embed")}
    return axes


def first_dense(cfg: ArchConfig) -> int:
    """The leading dense layers (``params["dense_blocks"]``) ahead of the
    stacked MoE layers (``params["blocks"]``)."""
    return cfg.moe.first_dense if cfg.moe is not None else 0


def stack_layers(params: dict):
    """Every layer's parameters in order (views, each made as it is
    reached): the leading dense layers, then the stack's."""
    for k in ("dense_blocks", "blocks"):
        if k in params:
            for i in range(_depth(params[k])):
                yield layer(params[k], i)


def _depth(blocks: dict) -> int:
    leaf = next(iter(blocks.values()))
    return _depth(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block parameters (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def unbind_layers(blocks: dict) -> list[dict]:
    """The stacked block parameters as one dict of views per layer.

    ``unbind`` (not one index per layer) keeps the backward pass cheap: its
    gradient is one ``stack`` of the per-layer gradients, where indexing
    would add a zero-filled tensor of the whole stack per layer."""
    per_leaf = {k: unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in blocks.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _remat(fn, cfg: ArchConfig):
    """Per-layer rematerialization, the JAX package's ``_remat``.

    ``"none"`` saves every activation.  ``"full"`` runs the layer under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward pass and the whole layer is recomputed in the backward.
    ``"dots"`` follows JAX's ``dots_with_no_batch_dims_saveable``: the
    checkpoint keeps the outputs of the layer's projections (every
    ``layers.proj``, one ``aten.mm`` each) and its recompute reuses them,
    recomputing everything else: batched matmuls, attention, the norms,
    elementwise ops and the SSD scan.  The projections save themselves
    (``layers.dots_saved``) rather than through a dispatch mode over every
    op (``create_selective_checkpoint_contexts``): such a mode costs host
    time on each op of the forward and the recompute, and caches every op
    while ``make_fx`` traces, so the traced step would lose its recompute.
    """
    if cfg.remat_policy == "none":
        return fn
    dots = cfg.remat_policy == "dots"

    def run(*args):
        # the recompute runs inside the backward, on the autograd engine's
        # thread for CUDA tensors, where the thread-local sharding context
        # is unset: it re-enters the context of the forward
        ctx = S.current_ctx()
        body = L.dots_saved(fn) if dots else fn

        def under_ctx(*a):
            with S.use_sharding(ctx):
                return body(*a)

        return checkpoint(under_ctx, *args, use_reentrant=False)

    return run


def shared_width(cfg: ArchConfig) -> int:
    """The shared expert's width: ``moe.d_ff_shared``, or the number of
    shared experts times the dense ``d_ff``."""
    return cfg.moe.d_ff_shared or cfg.moe.num_shared_experts * cfg.d_ff


def _ffn(p, h, cfg: ArchConfig):
    """The block's FFN on the normed hidden h: (y, aux loss)."""
    cdt = cfg.compute_dtype
    if "moe" not in p:
        return L.mlp(p["mlp"], h, cdt), 0.0
    y, aux = M.moe_ffn(p["moe"], h, cfg.moe, cdt)
    if "shared_mlp" in p:
        y = y + L.mlp(p["shared_mlp"], h, cdt)
    return y, aux


def prenorm_layer(p, x, cfg: ArchConfig, *mixers):
    """One layer's pre-norm residual branches, in order: each mixer
    ``(norm, fn)``, then the layer's FFN (:func:`_ffn`) under the next
    ``norm{k}`` where ``p`` holds one.  A branch adds ``fn(rmsnorm(x,
    p[norm]))`` to ``x``, scaled by ``cfg.residual_multiplier``.  Returns
    (x, the FFN's aux loss: 0.0 for a dense FFN or none)."""
    cdt, rm = cfg.compute_dtype, cfg.residual_multiplier
    for norm, fn in mixers:
        x = x + L.scaled(fn(L.rmsnorm(x, p[norm], cfg.norm_eps, cdt)), rm)
    if "mlp" not in p and "moe" not in p:
        return x, 0.0
    h = L.rmsnorm(x, p[f"norm{len(mixers) + 1}"], cfg.norm_eps, cdt)
    y, aux = _ffn(p, h, cfg)
    return x + L.scaled(y, rm), aux


def apply_block(p, x, cfg: ArchConfig, *, positions, mask=None):
    """One block over the whole sequence: (x, aux loss)."""
    if cfg.is_mla:
        return prenorm_layer(p, x, cfg, ("norm1", lambda h: MLA.attention(
            p["attn"], h, cfg, positions=positions)))
    return prenorm_layer(p, x, cfg, ("norm1", lambda h: L.attention(
        p["attn"], h, cfg, positions=positions, mask=mask)))


def run_stack(params, x, cfg: ArchConfig, *, positions, mask=None):
    """The block stack, each layer under the config's remat.  Returns
    (hidden, aux_loss_sum)."""

    def body(h, bp):
        return apply_block(bp, h, cfg, positions=positions, mask=mask)

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = unbind_layers(params["blocks"])
    if "dense_blocks" in params:
        stack = unbind_layers(params["dense_blocks"]) + stack
    for bp in stack:
        x, a = body(x, bp)
        aux = aux + a
    return x, aux


def _embed_inputs(params, batch, cfg: ArchConfig):
    """Returns (h, positions, text_start).  For vlm, prepends the projected
    patch embeddings; text occupies positions [num_patches, num_patches+S)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], batch["tokens"], cfg)
    b = h.shape[0]
    if cfg.num_patches:
        pr = params["projector"]
        pe = L.proj(batch["patches"].to(cdt), pr["w1"].to(cdt))
        pe = F.gelu(pe, approximate="tanh")   # jax.nn.gelu's default
        pe = L.proj(pe, pr["w2"].to(cdt))
        h = torch.cat([pe, h], dim=1)
    s = h.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(
        b, s)
    return h, positions, cfg.num_patches


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean next-token cross-entropy over the text plus the MoE aux loss:
    (loss, {"ce", "aux"})."""
    h, positions, text_start = _embed_inputs(params, batch, cfg)
    h, aux = run_stack(params, h, cfg, positions=positions)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.compute_dtype)
    if text_start:
        h = h[:, text_start:]
    w, kw = head_weight(params, cfg)
    ce = L.chunked_xent(h, w, batch["labels"], chunk=cfg.loss_chunk,
                        mask=batch.get("loss_mask"), **kw)
    return ce + aux, {"ce": ce, "aux": aux}


def head_weight(params, cfg: ArchConfig):
    """The logits head's weight (the embedding where the config ties them)
    and its keywords for ``layers.logits_head`` and ``chunked_xent``."""
    tied = cfg.tie_embeddings
    return (params["embed" if tied else "head"],
            {"transpose": tied, "scaling": cfg.logits_scaling})


def logits(params, h, cfg: ArchConfig):
    """Final hidden states -> fp32 logits through :func:`head_weight`."""
    w, kw = head_weight(params, cfg)
    return L.logits_head(w, h, **kw)


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype, device):
    if cfg.is_mla or first_dense(cfg):
        raise NotImplementedError(
            f"{cfg.name}: latent attention and leading dense layers are "
            f"served through the paged engine (serve.paged), which holds "
            f"the latent pool; the whole-cache path has neither")
    one = L.init_kv_cache(batch, max_len, cfg, dtype, device)
    return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in one.items()}


def cache_axes(cfg: ArchConfig) -> dict:
    return _prefix_layers(L.kv_cache_axes(cfg))


def prefill(params, tokens, cfg: ArchConfig, max_len: int, patches=None):
    """Forward pass writing the KV cache; returns (last-token logits, cache).

    tokens: (B, S) integer; patches: (B, num_patches, vision_dim), the vlm
    family's image input (the cache then holds patches and text).
    """
    cdt = L.dtype_of(cfg.compute_dtype)
    batch = {"tokens": tokens}
    if cfg.num_patches:
        if patches is None:
            raise ValueError(f"{cfg.name}: a vlm prefill needs its patches")
        batch["patches"] = patches
    h, positions, _ = _embed_inputs(params, batch, cfg)
    cache = init_cache(h.shape[0], max_len, cfg, cdt, tokens.device)

    def attn(p, lc, n):
        return L.attention_prefill(p, n, cfg, positions=positions,
                                   cache=lc)[0]

    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        lc = {k: v[i] for k, v in cache.items()}
        h, _ = prenorm_layer(bp, h, cfg,
                             ("norm1", partial(attn, bp["attn"], lc)))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    return logits(params, h[:, -1:], cfg), cache


def decode_step(params, cache, token, cache_len: int, cfg: ArchConfig):
    """token: (B,1) integer; cache_len: int.  Returns (logits, cache); the
    cache is updated in place."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], token, cfg)

    def attn(p, lc, n):
        return L.attention_decode(p, n, cfg, cache=lc, cache_len=cache_len)[0]

    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        lc = {k: v[i] for k, v in cache.items()}
        h, _ = prenorm_layer(bp, h, cfg,
                             ("norm1", partial(attn, bp["attn"], lc)))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    return logits(params, h, cfg), cache

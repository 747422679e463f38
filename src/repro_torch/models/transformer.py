"""Decoder-only transformer stack (dense / moe / vlm families): init, loss,
prefill, decode.

Reached through :func:`repro_torch.models.build.build_model`, which refuses
the families not ported yet.

Block parameters are stacked on a leading ``layers`` axis, as in the JAX
package, so parameter trees cross between the packages unchanged; the JAX
``lax.scan`` over that axis is a Python loop over it here, each layer under
the config's remat (:func:`_remat`).  A block's FFN is the SwiGLU MLP or,
in the ``moe`` family, the routed experts (plus a shared expert where the
config has one); the ``vlm`` family prepends projected patch embeddings to
the text.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def init_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One decoder block: attention + FFN (dense or MoE [+ shared expert])."""
    dev = gen.device
    params = {
        "attn": L.init_attention(gen, cfg),
        "norm1": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
        "norm2": L.init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
    }
    if cfg.moe is not None and cfg.moe.every_k == 1:
        params["moe"] = M.init_moe(gen, cfg.d_model, cfg.moe, cfg.param_dtype)
        if cfg.moe.num_shared_experts:
            params["shared_mlp"] = L.init_mlp(
                gen, cfg.d_model, cfg.moe.num_shared_experts * cfg.d_ff,
                cfg.param_dtype)
    else:
        params["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    return params


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
    if cfg.num_patches:  # vlm multimodal projector
        params["projector"] = {
            "w1": L._init_dense(gen, (cfg.vision_dim, cfg.d_model),
                                cfg.vision_dim, cfg.param_dtype),
            "w2": L._init_dense(gen, (cfg.d_model, cfg.d_model), cfg.d_model,
                                cfg.param_dtype),
        }
    return params


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

    ``"none"`` saves every activation.  ``"full"`` and ``"dots"`` run the
    layer under ``torch.utils.checkpoint``: its activations are dropped after
    the forward pass and recomputed in the backward.  JAX's ``"dots"`` policy
    keeps the matmul outputs of the layer and recomputes the rest; the port
    recomputes the whole layer (same numbers; more time, less memory), and
    selective saving is a ROADMAP item.
    """
    if cfg.remat_policy == "none":
        return fn

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def _ffn(p, h, cfg: ArchConfig):
    """The block's FFN on the normed hidden h: (y, aux loss)."""
    cdt = cfg.compute_dtype
    if "moe" not in p:
        return L.mlp(p["mlp"], h, cdt), 0.0
    y, aux = M.moe_ffn(p["moe"], h, cfg.moe, cdt)
    if "shared_mlp" in p:
        y = y + L.mlp(p["shared_mlp"], h, cdt)
    return y, aux


def apply_block(p, x, cfg: ArchConfig, *, positions, mask=None):
    """One block over the whole sequence: (x, aux loss)."""
    cdt = cfg.compute_dtype
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps, cdt)
    x = x + L.attention(p["attn"], h, cfg, positions=positions, mask=mask)
    h = L.rmsnorm(x, p["norm2"], cfg.norm_eps, cdt)
    y, aux = _ffn(p, h, cfg)
    return x + y, aux


def run_stack(params, x, cfg: ArchConfig, *, positions, mask=None):
    """The block stack, each layer under the config's remat.  Returns
    (hidden, aux_loss_sum)."""

    def body(h, bp):
        return apply_block(bp, h, cfg, positions=positions, mask=mask)

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in unbind_layers(params["blocks"]):
        x, a = body(x, bp)
        aux = aux + a
    return x, aux


def _embed_inputs(params, batch, cfg: ArchConfig):
    """Returns (h, positions, text_start).  For vlm, prepends the projected
    patch embeddings; text occupies positions [num_patches, num_patches+S)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    h = L.embed(params["embed"], batch["tokens"], cdt)
    b = h.shape[0]
    if cfg.num_patches:
        pr = params["projector"]
        pe = torch.einsum("bpf,fd->bpd", batch["patches"].to(cdt),
                          pr["w1"].to(cdt))
        pe = F.gelu(pe, approximate="tanh")   # jax.nn.gelu's default
        pe = torch.einsum("bpd,de->bpe", pe, pr["w2"].to(cdt))
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
    w, transpose = head_weight(params, cfg)
    ce = L.chunked_xent(h, w, batch["labels"], transpose=transpose,
                        chunk=cfg.loss_chunk, mask=batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"], True
    return params["head"], False


def init_cache(batch: int, max_len: int, cfg: ArchConfig, dtype, device):
    one = L.init_kv_cache(batch, max_len, cfg, dtype, device)
    return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in one.items()}


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
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        lc = {k: v[i] for k, v in cache.items()}
        n = L.rmsnorm(h, bp["norm1"], cfg.norm_eps, cdt)
        a, _ = L.attention_prefill(bp["attn"], n, cfg, positions=positions,
                                   cache=lc)
        h = h + a
        n = L.rmsnorm(h, bp["norm2"], cfg.norm_eps, cdt)
        h = h + _ffn(bp, n, cfg)[0]
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
        h = h + _ffn(bp, n, cfg)[0]
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps, cdt)
    w, transpose = head_weight(params, cfg)
    return L.logits_head(w, h, transpose=transpose), cache

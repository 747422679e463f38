"""Shared model substrate: norms, RoPE, GQA attention (full-sequence, and
with a bf16 KV cache), the SwiGLU MLP, embedding, head and cross-entropy.

Parameters are plain dicts of tensors with the JAX package's keys and shapes
(``repro.models.layers``), so a parameter tree crosses between the two
packages as numpy arrays.  Every ``init_*`` draws from an explicit
``torch.Generator`` and allocates on that generator's device.

Dtype convention, as in the JAX package: parameters live in
``cfg.param_dtype``; compute runs in ``cfg.compute_dtype``; normalization
statistics, RoPE tables, softmax and the logits head are fp32.  Weights are
cast with ``.to(cdt)``, which is free where the serving path has cast them
once at load (:func:`repro_torch.models.build.compute_params`).

Every norm goes through the RMSNorm kernel op and every attention through
the flash-attention kernel op (``repro_torch.kernels``); on CPU tensors those
ops run their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


def _init_dense(gen: torch.Generator, shape, scale_dim: int, dtype):
    scale = 1.0 / math.sqrt(scale_dim)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return w.to(dtype_of(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype_of(dtype), device=device)


def rmsnorm(x, scale, eps: float = 1e-5, compute_dtype=torch.bfloat16):
    """fp32 statistics, output in the compute dtype (the layer's contract;
    the bare kernel op defaults to ``x.dtype``)."""
    return fused_rmsnorm(x, scale, eps=eps, out_dtype=dtype_of(compute_dtype))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta**exponents)  # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional bias, bf16 KV cache)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg) -> dict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.param_dtype
    params = {
        "wq": _init_dense(gen, (d, H, hd), d, dt),
        "wk": _init_dense(gen, (d, K, hd), d, dt),
        "wv": _init_dense(gen, (d, K, hd), d, dt),
        "wo": _init_dense(gen, (H, hd, d), H * hd, dt),
    }
    if cfg.qkv_bias:
        pdt, dev = dtype_of(dt), gen.device
        params["bq"] = torch.zeros((H, hd), dtype=pdt, device=dev)
        params["bk"] = torch.zeros((K, hd), dtype=pdt, device=dev)
        params["bv"] = torch.zeros((K, hd), dtype=pdt, device=dev)
    return params


def _project_qkv(p, x, cfg, positions):
    cdt = dtype_of(cfg.compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, cfg, *, q_offset: Optional[torch.Tensor] = None,
          kv_len: Optional[torch.Tensor] = None, causal: bool = True):
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd) with K the stored kv-head count.

    One path for every caller: the flash-attention op with GQA by index.
    The mask is causal over absolute positions (query i of row b sits at
    ``q_offset[b] + i``) and bounded by ``kv_len[b]``: the ``q_offset`` /
    ``kv_valid`` contract of the JAX package's ``_sdpa_blockwise``, per row.
    Returns (B,Sq,H,hd).
    """
    if cfg.attn_impl == "proxy":
        raise NotImplementedError(
            "attn_impl='proxy' is a dry-run measurement stub of the JAX "
            "package; the port has no dry run"
        )
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len)


def attention(p, x, cfg, *, positions, mask=None, cross_kv=None,
              bidirectional: bool = False):
    """Full-sequence causal self-attention (train, no cache read), through
    the flash-attention op and so through the kernel.  Query i sees keys
    j <= i, the JAX dense path's ``causal_mask(sq, skv, 0)``.

    Cross-attention and bidirectional visibility belong to the encoder-
    decoder family, and an explicit mask to no caller of the port: each
    raises."""
    if cross_kv is not None or bidirectional:
        raise NotImplementedError(
            "cross-attention and bidirectional attention wait for the "
            "encoder-decoder family (ROADMAP.md, 'encdec')")
    if mask is not None:
        raise NotImplementedError(
            "attention takes no explicit mask in the port: the flash op "
            "masks causally (and by per-row q_offset / kv_len)")
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _sdpa(q, k, v, cfg)
    cdt = dtype_of(cfg.compute_dtype)
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(cdt))


def causal_mask(sq: int, skv: int, offset: int = 0, device=None):
    """True where attendable. offset = number of cached tokens before q[0]."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(skv, device=device)[None, :]
    return (ki <= qi)[None, None, :, :]


def init_kv_cache(batch: int, max_len: int, cfg, dtype, device) -> dict:
    if getattr(cfg, "kv_cache_dtype", "bfloat16") == "int8":
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP, int8 KV cache)"
        )
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype_of(dtype), device=device),
        "v": torch.zeros(shape, dtype=dtype_of(dtype), device=device),
    }


def _cache_write(cache, k, v, pos: int) -> None:
    """Write k/v (B,S,K,hd) into the cache at sequence offset ``pos``, in
    place (the JAX version returns an updated copy)."""
    s = k.shape[1]
    cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)


def attention_prefill(p, x, cfg, *, positions, cache):
    """Compute full causal attention AND write k/v into the cache at [0, S).
    The cache is updated in place and returned."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _sdpa(q, k, v, cfg)
    cdt = dtype_of(cfg.compute_dtype)
    _cache_write(cache, k, v, 0)
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(cdt)), cache


def attention_decode(p, x, cfg, *, cache, cache_len: int):
    """One-token decode: x (B,1,D), attend over cache[0:cache_len] + self.

    The new token's k/v are written at position ``cache_len`` (in place);
    the mask hides positions > cache_len.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, positions)
    _cache_write(cache, k, v, cache_len)
    out = _sdpa(q, cache["k"].to(cdt), cache["v"].to(cdt), cfg,
                q_offset=positions[:, 0])
    y = torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(cdt))
    return y, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "wg": _init_dense(gen, (d, d_ff), d, dtype),
        "wu": _init_dense(gen, (d, d_ff), d, dtype),
        "wd": _init_dense(gen, (d_ff, d), d_ff, dtype),
    }


def mlp(p, x, compute_dtype):
    cdt = dtype_of(compute_dtype)
    g = torch.einsum("bsd,df->bsf", x, p["wg"].to(cdt))
    u = torch.einsum("bsd,df->bsf", x, p["wu"].to(cdt))
    h = F.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p["wd"].to(cdt))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype):
    return _init_dense(gen, (vocab, d), d, dtype)


def embed(emb, tokens, compute_dtype):
    return emb[tokens].to(dtype_of(compute_dtype))


def logits_head(emb_or_w, x, *, transpose: bool):
    """Final projection to vocab; fp32 logits."""
    w = emb_or_w.float()
    xf = x.float()
    if transpose:  # tied embeddings: w is (vocab, d)
        return torch.einsum("bsd,vd->bsv", xf, w)
    return torch.einsum("bsd,dv->bsv", xf, w)


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy, fp32. labels: integer (B,S)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def chunked_xent(hidden, head_w, labels, *, transpose: bool, chunk: int,
                 mask=None):
    """Cross-entropy without materializing full (B,S,V) fp32 logits.

    Loops over sequence chunks; each chunk computes logits -> logsumexp ->
    label gather under ``torch.utils.checkpoint`` (the JAX package's
    per-chunk ``jax.checkpoint``), so only (B, chunk, V) logits are live and
    the backward pass recomputes them.  The sums run in the JAX scan's order.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss chunk {chunk} != 0")

    def body(h, lab, mk):
        logits = logits_head(head_w, h, transpose=transpose)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return ((lse - tgt) * mk).sum()

    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        mk = (torch.ones((b, chunk), dtype=torch.float32, device=hidden.device)
              if mask is None else mask[:, sl].float())
        nll_sum = nll_sum + checkpoint(body, hidden[:, sl], labels[:, sl], mk,
                                       use_reentrant=False)
        cnt = cnt + mk.sum()
    return nll_sum / torch.clamp(cnt, min=1.0)

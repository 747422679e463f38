"""Shared model substrate: norms, RoPE, GQA attention (causal, bidirectional
and cross, full-sequence, and with a compute-dtype or int8 KV cache), the
SwiGLU MLP, embedding, head and cross-entropy.

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
import threading
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
from repro_torch.models import sharding as S

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


class _DotsState(threading.local):
    """The "dots" remat's state on this thread: while a layer's forward runs
    under it, ``store`` collects the projections' outputs; while its
    recompute runs, ``replay`` hands them back in the same order."""
    store: Optional[deque] = None
    replay: bool = False


_DOTS = _DotsState()


class _SavedMM(torch.autograd.Function):
    """A projection replayed from its saved output: no matmul in the
    forward; the backward is the matmul's own (dx = g wᵀ, dw = xᵀ g)."""

    @staticmethod
    def forward(ctx, x2, w2, out):
        # what aten.mm's own node saves, in its order (the checkpoint holds
        # the recompute's saved tensors to the forward's): w for dx, x for dw
        dx, dw = ctx.needs_input_grad[:2]
        ctx.save_for_backward(*([w2] if dx else []), *([x2] if dw else []))
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        saved = list(ctx.saved_tensors)
        dx = g.mm(saved.pop(0).t()) if ctx.needs_input_grad[0] else None
        dw = saved.pop(0).t().mm(g) if ctx.needs_input_grad[1] else None
        return dx, dw, None


@contextmanager
def _dots(store: deque, replay: bool):
    prev = _DOTS.store, _DOTS.replay
    _DOTS.store, _DOTS.replay = store, replay
    try:
        yield
    finally:
        _DOTS.store, _DOTS.replay = prev


def dots_saved(fn):
    """``fn`` for one "dots" checkpoint (``transformer._remat``): its first
    call, the checkpoint's forward, keeps every :func:`proj` output; its
    next, the recompute, reuses them and recomputes everything else."""
    store: deque = deque()
    calls = [0]

    def body(*args):
        replay = calls[0] > 0
        calls[0] += 1
        with _dots(store, replay):
            return fn(*args)

    return body


def proj(x, w, n: int = 1):
    """``x`` contracted over its last ``n`` dims with the first ``n`` dims
    of ``w``, as one 2-D matmul (``aten.mm``).

    Every projection without a batch dimension goes through here (the JAX
    package's ``bsd,dhk->bshk``, ``bqhk,hkd->bqd``, ``bsd,df->bsf``): these
    are the dots whose outputs JAX's ``dots_with_no_batch_dims_saveable``
    saves, and the "dots" remat saves them here (:func:`dots_saved`)."""
    k = math.prod(w.shape[:n])
    x2, w2 = x.reshape(-1, k), w.reshape(k, -1)
    if _DOTS.replay:
        out = _SavedMM.apply(x2, w2, _DOTS.store.popleft())
    else:
        out = torch.mm(x2, w2)
        if _DOTS.store is not None:
            _DOTS.store.append(out.detach())
    return out.reshape(*x.shape[:x.dim() - n], *w.shape[n:])


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


RMSNORM_AXES = ("embed",)


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


def attention_axes(cfg) -> dict:
    """The logical axes of :func:`init_attention`'s leaves (the second
    value of the JAX package's ``init_attention``)."""
    axes = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        axes["bq"] = ("heads", "head_dim")
        axes["bk"] = ("kv_heads", "head_dim")
        axes["bv"] = ("kv_heads", "head_dim")
    return axes


def _project_qkv(p, x, cfg, positions):
    cdt = dtype_of(cfg.compute_dtype)
    q = proj(x, p["wq"].to(cdt))
    k = proj(x, p["wk"].to(cdt))
    v = proj(x, p["wv"].to(cdt))
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
        # the JAX package's dry-run stub: zero-traffic attention of the same
        # output shape (no kernel runs)
        return q * (1.0 / math.sqrt(q.shape[-1]))
    k, v = S.rank_view().kv(q, k, v)
    # getattr: the parity tests hand in the JAX package's config, which has
    # no attention_multiplier
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len,
                           sm_scale=getattr(cfg, "attention_multiplier", 0)
                           or None)


def attention(p, x, cfg, *, positions, mask=None, cross_kv=None,
              bidirectional: bool = False):
    """Full-sequence attention (train / prefill, no cache read), through
    the flash-attention op and so through the kernel.

    Causal self-attention by default: query i sees keys j <= i, the JAX
    dense path's ``causal_mask(sq, skv, 0)``.  ``bidirectional`` lets every
    query see every key (the encoder).  ``cross_kv``: a (k, v) pair
    projected from the encoder memory (:func:`cross_kv_from_memory`); q is
    projected without RoPE, as k and v were, and sees the whole memory.
    Both run the op with ``causal=False`` and no masks.  An explicit mask
    has no caller in the port and raises."""
    if mask is not None:
        raise NotImplementedError(
            "attention takes no explicit mask in the port: the flash op "
            "masks causally (and by per-row q_offset / kv_len)")
    cdt = dtype_of(cfg.compute_dtype)
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
    else:
        q = proj(x, p["wq"].to(cdt))
        if "bq" in p:
            q = q + p["bq"].to(cdt)
        k, v = cross_kv
        bidirectional = True
    rank = S.rank_view()
    q, q_offset = rank.queries(q)
    out = _sdpa(q, k, v, cfg, causal=not bidirectional, q_offset=q_offset)
    return rank.gather(proj(out, p["wo"].to(cdt), 2))


def cross_kv_from_memory(p, memory, cfg):
    """Project the encoder memory to (k, v) once (reused across decode
    steps); no RoPE, as in the JAX package."""
    cdt = dtype_of(cfg.compute_dtype)
    k = proj(memory, p["wk"].to(cdt))
    v = proj(memory, p["wv"].to(cdt))
    if "bk" in p:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    return k, v


def causal_mask(sq: int, skv: int, offset: int = 0, device=None):
    """True where attendable. offset = number of cached tokens before q[0]."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(skv, device=device)[None, :]
    return (ki <= qi)[None, None, :, :]


def init_kv_cache(batch: int, max_len: int, cfg, dtype, device) -> dict:
    """One layer's KV cache: k/v (B, S, K, hd) in ``dtype``, or for
    ``cfg.kv_cache_dtype == "int8"`` int8 k/v with (B, S, K, 1) bf16
    per-position scales ``k_scale``/``v_scale``."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if getattr(cfg, "kv_cache_dtype", "bfloat16") == "int8":
        scale = (batch, max_len, cfg.num_kv_heads, 1)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale, dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(scale, dtype=torch.bfloat16, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype_of(dtype), device=device),
        "v": torch.zeros(shape, dtype=dtype_of(dtype), device=device),
    }


KV_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
}


def kv_cache_axes(cfg) -> dict:
    """The logical axes of one layer's KV cache, the scales' included for
    an int8 cache."""
    axes = dict(KV_CACHE_AXES)
    if getattr(cfg, "kv_cache_dtype", "bfloat16") == "int8":
        axes["k_scale"] = ("batch", "kv_seq", "kv_heads", None)
        axes["v_scale"] = ("batch", "kv_seq", "kv_heads", None)
    return axes


def _kv_quantize(t: torch.Tensor) -> tuple:
    """(B,S,K,hd) -> (int8 values, (B,S,K,1) bf16 scales), as the JAX
    package's: a per-position scale amax/127 (at least 1e-8), values
    rounded half to even and clipped to +-127, the scale cast to bf16 after
    the division.  Both divisions are true fp32 divisions on every device:
    PyTorch's CUDA kernel turns a division by a host scalar into a product
    with its reciprocal, so 127 is a tensor on ``t``'s device."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _cache_write(cache, k, v, pos: int) -> None:
    """Write k/v (B,S,K,hd) into the cache at sequence offset ``pos``, in
    place (the JAX version returns an updated copy); an int8 cache takes
    the quantised values and their scales."""
    s = k.shape[1]
    if "k_scale" in cache:
        (k, k_scale), (v, v_scale) = _kv_quantize(k), _kv_quantize(v)
        cache["k_scale"][:, pos:pos + s] = k_scale
        cache["v_scale"][:, pos:pos + s] = v_scale
    cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)


def _cache_read(cache, cdt) -> tuple:
    """(k, v) in the compute dtype; an int8 cache dequantised, the product
    formed in ``cdt`` as the JAX package forms it."""
    if "k_scale" in cache:
        return (cache["k"].to(cdt) * cache["k_scale"].to(cdt),
                cache["v"].to(cdt) * cache["v_scale"].to(cdt))
    return cache["k"].to(cdt), cache["v"].to(cdt)


def attention_prefill(p, x, cfg, *, positions, cache):
    """Compute full causal attention AND write k/v into the cache at [0, S).
    The cache is updated in place and returned."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    rank = S.rank_view()
    q, q_offset = rank.queries(q)
    out = _sdpa(q, k, v, cfg, q_offset=q_offset)
    cdt = dtype_of(cfg.compute_dtype)
    _cache_write(cache, k, v, 0)
    return rank.gather(proj(out, p["wo"].to(cdt), 2)), cache


def attention_decode(p, x, cfg, *, cache, cache_len: int):
    """One-token decode: x (B,1,D), attend over cache[0:cache_len] + self.

    The new token's k/v are written at position ``cache_len`` (in place);
    the attention reads the whole cache through :func:`_cache_read` (an int8
    cache dequantised) and the mask hides positions > cache_len.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, positions)
    _cache_write(cache, k, v, cache_len)
    ck, cv = _cache_read(cache, cdt)
    out = _sdpa(q, ck, cv, cfg, q_offset=positions[:, 0])
    y = proj(out, p["wo"].to(cdt), 2)
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


MLP_AXES = {"wg": ("embed", "ffn"), "wu": ("embed", "ffn"),
            "wd": ("ffn", "embed")}


def mlp(p, x, compute_dtype):
    cdt = dtype_of(compute_dtype)
    g = proj(x, p["wg"].to(cdt))
    u = proj(x, p["wu"].to(cdt))
    h = F.silu(g) * u
    return proj(h, p["wd"].to(cdt))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype):
    return _init_dense(gen, (vocab, d), d, dtype)


EMBED_AXES = ("vocab", "embed")


def embed(emb, tokens, cfg):
    """The tokens' rows in the compute dtype, times
    ``cfg.embedding_multiplier``."""
    return scaled(emb[tokens].to(dtype_of(cfg.compute_dtype)),
                  cfg.embedding_multiplier)


def scaled(x, multiplier: float):
    """``x * multiplier``; ``x`` itself, with no operation, for 1."""
    return x if multiplier == 1.0 else x * multiplier


def logits_head(emb_or_w, x, *, transpose: bool, scaling: float = 1.0):
    """Final projection to vocab; fp32 logits, divided by ``scaling``."""
    w = emb_or_w.float()
    xf = x.float()
    if transpose:  # tied embeddings: w is (vocab, d)
        out = torch.einsum("bsd,vd->bsv", xf, w)
    else:
        out = torch.einsum("bsd,dv->bsv", xf, w)
    return out if scaling == 1.0 else out / scaling


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy, fp32. labels: integer (B,S)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def chunked_xent(hidden, head_w, labels, *, transpose: bool, chunk: int,
                 mask=None, scaling: float = 1.0):
    """Cross-entropy without materializing full (B,S,V) fp32 logits.

    ``scaling`` divides the logits (:func:`logits_head`).  Loops over
    sequence chunks; each chunk computes logits -> logsumexp ->
    label gather under ``torch.utils.checkpoint`` (the JAX package's
    per-chunk ``jax.checkpoint``), so only (B, chunk, V) logits are live and
    the backward pass recomputes them.  The sums run in the JAX scan's order.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss chunk {chunk} != 0")

    def body(h, lab, mk):
        logits = logits_head(head_w, h, transpose=transpose,
                             scaling=scaling)
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

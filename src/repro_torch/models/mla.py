"""Multi-head latent attention (MLA: DeepSeek-V2/V3, Kimi-K2).

The published equations (``modeling_deepseek.py``, which Kimi-K2 ships), for
hidden states h (B, S, d) at positions p, with H heads, a query rank ``qr``,
a key/value rank ``kr``, ``nope`` position-free and ``rope`` rotary key dims
a head and values of ``v`` dims:

    q        = q_b(RMSNorm(q_a(h)))               (B, S, H, nope + rope)
    q_nope, q_pe = q split;  q_pe <- RoPE(q_pe, p)
    c, k_pe  = kv_a(h) split                       (B, S, kr), (B, S, rope)
    c <- RMSNorm(c);  k_pe <- RoPE(k_pe, p)        one k_pe for every head
    k_nope, v = kv_b(c) split                      (B, S, H, nope), (.., v)
    o        = softmax(scale (q_nope k_nope + q_pe k_pe)) v,  causal
    y        = o_proj(o)                           over H x v

This module computes the *absorbed* form, which a cache of the latent needs:
with ``W_uk`` and ``W_uv`` the two halves of ``kv_b``'s weight,

    q_lat = q_nope W_uk^T  (H, kr a token),  score = q_lat c + q_pe k_pe,
    o_lat = sum_j p_j c_j,  o = o_lat W_uv

the same function in another order of products.  A token's cache entry is
its normed latent and its rotated ``k_pe``, ``kr + rope`` values
(:func:`project`), and every head attends over those rows alone, through the
paged kernel ``repro_torch.kernels.mla_attention`` (a contiguous sequence is
a table of pages too: :func:`attention`).

RoPE is the published one: YaRN's frequencies where ``cfg.yarn_factor`` > 1
(:func:`rope_freqs`) and the interleaved-pair layout (each vector's even and
odd elements gathered into halves, then rotated by halves, as the published
``apply_rotary_pos_emb`` does), cos and sin times YaRN's ``mscale(factor,
mscale) / mscale(factor, mscale_all_dim)`` (:func:`rope_scale`).  The
softmax scale is ``(nope + rope)^-0.5`` times ``mscale(factor,
mscale_all_dim)^2`` (:func:`softmax_scale`).

Parameters (the serve path's tree; each 2-D ``(in, out)`` or, for ``wo``,
``(H, v, d)``): ``wq_a`` (d, qr), ``q_norm`` (qr,), ``wq_b`` (qr, H (nope +
rope)), ``wkv_a`` (d, kr + rope), ``kv_norm`` (kr,), ``wkv_b`` (kr, H (nope +
v)), ``wo`` (H, v, d).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.mla_attention.ops import mla_attention
from repro_torch.models import layers as L


def init_mla(gen: torch.Generator, cfg) -> dict:
    d, H, dt = cfg.d_model, cfg.num_heads, cfg.param_dtype
    qr, kr, rope = cfg.mla_q_rank, cfg.mla_kv_rank, cfg.mla_rope_dim
    qk, nope, v = cfg.mla_nope_dim + rope, cfg.mla_nope_dim, cfg.mla_v_dim
    dev = gen.device
    return {
        "wq_a": L._init_dense(gen, (d, qr), d, dt),
        "q_norm": L.init_rmsnorm(qr, dt, dev),
        "wq_b": L._init_dense(gen, (qr, H * qk), qr, dt),
        "wkv_a": L._init_dense(gen, (d, kr + rope), d, dt),
        "kv_norm": L.init_rmsnorm(kr, dt, dev),
        "wkv_b": L._init_dense(gen, (kr, H * (nope + v)), kr, dt),
        "wo": L._init_dense(gen, (H, v, d), H * v, dt),
    }


MLA_AXES = {
    "wq_a": ("embed", "mla_rank"), "q_norm": ("mla_rank",),
    "wq_b": ("mla_rank", "heads"), "wkv_a": ("embed", "mla_rank"),
    "kv_norm": ("mla_rank",), "wkv_b": ("mla_rank", "heads"),
    "wo": ("heads", "head_dim", "embed"),
}


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def correction_range(cfg) -> tuple[int, int]:
    """YaRN's ``find_correction_range(beta_fast, beta_slow, dim, base,
    original_max)``: the frequency indices between which the rotation is
    interpolated."""
    dim, base = cfg.mla_rope_dim, cfg.rope_theta

    def at(rotations: float) -> float:
        return (dim * math.log(cfg.yarn_original_max
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = math.floor(at(cfg.yarn_beta_fast))
    high = math.ceil(at(cfg.yarn_beta_slow))
    return max(low, 0), min(high, dim - 1)


def rope_freqs(cfg, device) -> torch.Tensor:
    """(rope / 2,) fp32 inverse frequencies: theta^(-2i/rope), and with
    YaRN those past the correction range divided by the factor, a linear
    ramp between."""
    dim = cfg.mla_rope_dim
    extra = L.rope_freqs(dim, cfg.rope_theta, device)
    if cfg.yarn_factor <= 1:
        return extra
    low, high = correction_range(cfg)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    mask = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)
    return extra / cfg.yarn_factor * (1 - mask) + extra * mask


def softmax_scale(cfg) -> float:
    scale = (cfg.mla_nope_dim + cfg.mla_rope_dim) ** -0.5
    if cfg.yarn_factor > 1 and cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def rope_scale(cfg) -> float:
    """YaRN's factor on cos and sin (1 without YaRN)."""
    f = cfg.yarn_factor
    return yarn_mscale(f, cfg.yarn_mscale) / yarn_mscale(
        f, cfg.yarn_mscale_all_dim)


def rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
         scale: float = 1.0):
    """x (B, S, ..., r), positions (B, S): the interleaved pairs gathered
    into halves, then rotated by halves, cos and sin times ``scale``; fp32
    math, x's dtype out."""
    r = x.shape[-1]
    xf = x.float().unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    ang = positions.float()[..., None] * inv_freq               # (B, S, r/2)
    ang = ang.view(ang.shape[:2] + (1,) * (x.dim() - 3) + ang.shape[-1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def project(p, x, cfg, positions):
    """(q_nope (B, S, H, nope), q_pe (B, S, H, rope) rotated, the latent
    entry (B, S, kr + rope): the normed c and the rotated k_pe), in the
    compute dtype."""
    cdt = L.dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nope, rope_d, kr = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_kv_rank
    freqs, sc = rope_freqs(cfg, x.device), rope_scale(cfg)
    cq = L.rmsnorm(L.proj(x, p["wq_a"].to(cdt)), p["q_norm"], cfg.norm_eps,
                   cdt)
    q = L.proj(cq, p["wq_b"].to(cdt)).view(b, s, cfg.num_heads, -1)
    q_nope, q_pe = q.split([nope, rope_d], dim=-1)
    kv = L.proj(x, p["wkv_a"].to(cdt))
    c = L.rmsnorm(kv[..., :kr], p["kv_norm"], cfg.norm_eps, cdt)
    k_pe = rope(kv[..., kr:], positions, freqs, sc)
    return q_nope, rope(q_pe, positions, freqs, sc), torch.cat([c, k_pe], -1)


def _halves(p, cfg):
    """``W_uk`` (H, nope, kr) and ``W_uv`` (H, kr, v): views of kv_b."""
    cdt = L.dtype_of(cfg.compute_dtype)
    w = p["wkv_b"].to(cdt).view(cfg.mla_kv_rank, cfg.num_heads, -1)
    nope = cfg.mla_nope_dim
    return w[..., :nope].permute(1, 2, 0), w[..., nope:].permute(1, 0, 2)


def absorb(p, q_nope, q_pe, cfg) -> torch.Tensor:
    """The kernel's query rows (B S, H, kr + rope): q_nope W_uk^T beside
    q_pe."""
    w_uk, _ = _halves(p, cfg)
    h = cfg.num_heads
    q_lat = torch.bmm(q_nope.reshape(-1, h, q_nope.shape[-1]).transpose(0, 1),
                      w_uk).transpose(0, 1)
    return torch.cat([q_lat, q_pe.reshape(-1, h, q_pe.shape[-1])], -1)


def output(p, o_lat, cfg, shape) -> torch.Tensor:
    """o_lat (B S, H, kr) -> y (B, S, d): each head's o_lat W_uv, then
    o_proj."""
    cdt = L.dtype_of(cfg.compute_dtype)
    _, w_uv = _halves(p, cfg)
    o = torch.bmm(o_lat.transpose(0, 1), w_uv).transpose(0, 1)
    return L.proj(o.reshape(shape[:2] + o.shape[1:]), p["wo"].to(cdt), 2)


def paged(p, x, cfg, pages, *, positions, write_bi, write_off, tables):
    """The mixer over a paged latent pool layer ``pages`` (blocks,
    block_size, kr + rope): each new token's entry written in place at
    (write_bi, write_off), then every token attends over its lane's entries
    up to its own position through the kernel.  x (B, S, d), positions
    (B, S), tables (B, max_blocks).  Returns (B, S, d)."""
    b, s, _ = x.shape
    q_nope, q_pe, lat = project(p, x, cfg, positions)
    pages.index_put_((write_bi, write_off),
                     lat.reshape(b * s, -1).to(pages.dtype))
    view = tables.shape[1] * pages.shape[1]
    lane = torch.arange(b, dtype=torch.int32, device=x.device)
    o_lat = mla_attention(
        absorb(p, q_nope, q_pe, cfg), pages, tables.to(torch.int32),
        lane.repeat_interleave(s),
        positions.reshape(-1).clamp(max=view - 1).to(torch.int32),
        cfg.mla_kv_rank, softmax_scale(cfg))
    return output(p, o_lat, cfg, (b, s))


def attention(p, x, cfg, *, positions):
    """Causal MLA over whole sequences x (B, S, d) at ``positions`` (B, S)
    from 0: the sequences' own latent entries as pages of the kernel's
    block size, one table row a sequence."""
    from repro_torch.kernels.mla_attention.ref import PAGE

    b, s, _ = x.shape
    nb = -(-s // PAGE)
    q_nope, q_pe, lat = project(p, x, cfg, positions)
    pages = lat.new_zeros((b, nb * PAGE, lat.shape[-1]))
    pages[:, :s] = lat
    tables = torch.arange(b * nb, dtype=torch.int32,
                          device=x.device).view(b, nb)
    lane = torch.arange(b, dtype=torch.int32, device=x.device)
    o_lat = mla_attention(
        absorb(p, q_nope, q_pe, cfg), pages.view(b * nb, PAGE, -1), tables,
        lane.repeat_interleave(s), positions.reshape(-1).to(torch.int32),
        cfg.mla_kv_rank, softmax_scale(cfg))
    return output(p, o_lat, cfg, (b, s))

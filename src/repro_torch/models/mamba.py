"""Mamba-2 mixer via SSD (state-space duality), chunked algorithm.

The torch counterpart of the JAX package's ``models/mamba.py`` (arXiv:2405.21060
§6): within a chunk of Q tokens the token mixing is the quadratic masked form;
across chunks an (n, p) state per head is carried by a linear recurrence.
Decode is the O(1) recurrent state update, one call of the decode-step
kernel op (:mod:`repro_torch.kernels.mamba_step.ops`) a token.

The chunked scan is the SSD-scan kernel op
(:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`): on a CUDA tensor it
launches the Hopper kernel, on a CPU tensor it runs the plain version.  B and C
use ``ngroups`` groups (1 in the shipped configs); their broadcast over the
heads is a stride-0 view that the kernel reads in place.  The gated norm stays
plain PyTorch, as the JAX package leaves it outside any kernel.

Parameters are dicts with the JAX package's keys, shapes and dtypes
(``A_log``, ``dt_bias`` and ``D_skip`` in fp32).  All decays are computed in
fp32; since dt >= 0 (softplus) and A < 0 (= -exp(A_log)), every exponent is
<= 0 so exp() never overflows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_step import ops as step_ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import _init_dense, dtype_of, proj
from repro_torch.models.sharding import rank_view


def mamba_dims(cfg: ArchConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    nheads = d_in // m.head_dim
    return m, d_in, nheads


def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> dict:
    m, d_in, nh = mamba_dims(cfg)
    d, g, ds, hd, w = cfg.d_model, m.ngroups, m.d_state, m.head_dim, m.d_conv
    dt, dev = cfg.param_dtype, gen.device
    f32 = torch.float32
    p = {
        "wz": _init_dense(gen, (d, nh, hd), d, dt),
        "wx": _init_dense(gen, (d, nh, hd), d, dt),
        "wB": _init_dense(gen, (d, g, ds), d, dt),
        "wC": _init_dense(gen, (d, g, ds), d, dt),
        "wdt": _init_dense(gen, (d, nh), d, dt),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
        "A_log": torch.zeros((nh,), dtype=f32, device=dev),
        "D_skip": torch.ones((nh,), dtype=f32, device=dev),
        "conv_x": _init_dense(gen, (w, nh, hd), w, dt),
        "conv_B": _init_dense(gen, (w, g, ds), w, dt),
        "conv_C": _init_dense(gen, (w, g, ds), w, dt),
        "norm": torch.ones((nh, hd), dtype=dtype_of(dt), device=dev),
        "wo": _init_dense(gen, (nh, hd, d), nh * hd, dt),
    }
    if m.conv_bias:
        for key, shape in (("conv_x_bias", (nh, hd)), ("conv_B_bias", (g, ds)),
                           ("conv_C_bias", (g, ds))):
            p[key] = torch.zeros(shape, dtype=dtype_of(dt), device=dev)
    return p


# the logical axes of init_mamba's leaves (the second value of the JAX
# package's ``init_mamba``)
MAMBA_AXES = {
    "wz": ("embed", "heads", "head_dim"),
    "wx": ("embed", "heads", "head_dim"),
    "wB": ("embed", None, "ssm_state"),
    "wC": ("embed", None, "ssm_state"),
    "wdt": ("embed", "dt"),
    "dt_bias": ("dt",),
    "A_log": ("dt",),
    "D_skip": ("dt",),
    "conv_x": ("conv", "heads", "head_dim"),
    "conv_B": ("conv", None, "ssm_state"),
    "conv_C": ("conv", None, "ssm_state"),
    "norm": ("heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
}


def mamba_axes(cfg: ArchConfig) -> dict:
    """The logical axes of :func:`init_mamba`'s leaves for ``cfg``: those
    of :data:`MAMBA_AXES`, and the conv biases' where the config has them."""
    axes = dict(MAMBA_AXES)
    if cfg.mamba.conv_bias:
        axes["conv_x_bias"] = ("heads", "head_dim")
        axes["conv_B_bias"] = axes["conv_C_bias"] = (None, "ssm_state")
    return axes


def _causal_depthwise_conv(x, kernel, tail=None, bias=None, length=None):
    """x: (B, S, *ch); kernel: (w, *ch).  Causal depthwise conv along S.

    tail: optional (B, w-1, *ch) history prepended (prefill/decode chaining);
    zeros when None.  bias: optional (*ch), added before the SiLU.
    length: the real positions of x, the rest right-padding; the new tail is
    the last w-1 inputs before it.  Returns (y, new_tail).
    """
    w = kernel.shape[0]
    b, s = x.shape[:2]
    ch = tuple(x.shape[2:])
    if tail is None:
        tail = torch.zeros((b, w - 1) + ch, dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, S+w-1, *ch)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w):  # w is 4
        y = y + xp[:, i:i + s].float() * kernel[i].float()
    if bias is not None:
        y = y + bias.float()
    end = s if length is None else length
    new_tail = xp[:, end:end + w - 1]  # last w-1 inputs
    return F.silu(y).to(x.dtype), new_tail


def _project_raw(p, x, cfg: ArchConfig):
    """x: (B,S,D) -> z, xh, B_, C_, dt  (pre-conv; dt before its bias and
    softplus)."""
    cdt = dtype_of(cfg.compute_dtype)
    z = proj(x, p["wz"].to(cdt))
    xh = proj(x, p["wx"].to(cdt))
    B_ = proj(x, p["wB"].to(cdt))
    C_ = proj(x, p["wC"].to(cdt))
    dt = proj(x.float(), p["wdt"].float())
    return z, xh, B_, C_, dt


def _project(p, x, cfg: ArchConfig):
    """x: (B,S,D) -> z, xh, B_, C_, dt  (pre-conv, pre-activation)."""
    z, xh, B_, C_, dt = _project_raw(p, x, cfg)
    dt = F.softplus(dt + p["dt_bias"])  # (B,S,nh) fp32, >= 0
    return z, xh, B_, C_, dt


def _expand_groups(t, nheads: int):
    """(B,S,g,ds) -> (B,S,nh,ds) by repeating groups; for g = 1 a stride-0
    view (nothing is copied)."""
    b, s, g, ds = t.shape
    if g == nheads:
        return t
    reps = nheads // g
    return t[:, :, :, None, :].expand(b, s, g, reps, ds).reshape(
        b, s, nheads, ds)


def ssd_chunked(xh, B_, C_, dt, A, chunk: int):
    """Chunked SSD scan (the kernel op).

    xh: (B,S,nh,hd)  B_/C_: (B,S,nh,ds)  dt: (B,S,nh) fp32  A: (nh,) fp32 (<0)
    Returns y: (B,S,nh,hd) fp32, final_state: (B,nh,ds,hd) fp32.
    """
    if xh.shape[1] % chunk:
        raise ValueError(f"seq {xh.shape[1]} % chunk {chunk} != 0")
    return ssd_scan(xh, B_, C_, dt, A, chunk=chunk, out_dtype=torch.float32)


def _pad_seq(t, pad: int):
    """Zero-pad axis 1 of t by ``pad`` positions at the end."""
    return F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])


def mamba_forward(p, x, cfg: ArchConfig, *, conv_tails=None, init_state=None,
                  length=None):
    """Full-sequence mixer. x: (B,S,D) -> (y, cache_out).

    cache_out = {"conv_x","conv_B","conv_C": tails, "state": (B,nh,ds,hd)}.
    init_state/conv_tails chain from a previous segment (prefill continuation).
    length: where x is right-padded, its real positions: the padding's dt is
    0, so it neither decays nor feeds the state, and the tails end at it.
    """
    m, _, nh = mamba_dims(cfg)
    nh = rank_view().heads(p["wx"].shape[1], nh)   # a dry-run rank's share
    cdt = dtype_of(cfg.compute_dtype)
    z, xh, B_, C_, dt = _project(p, x, cfg)
    if length is not None and length < x.shape[1]:
        dt = _pad_seq(dt[:, :length], x.shape[1] - length)
    t = conv_tails or {}
    xh, tx = _causal_depthwise_conv(xh, p["conv_x"].to(cdt), t.get("conv_x"),
                                    p.get("conv_x_bias"), length)
    B_, tb = _causal_depthwise_conv(B_, p["conv_B"].to(cdt), t.get("conv_B"),
                                    p.get("conv_B_bias"), length)
    C_, tc = _causal_depthwise_conv(C_, p["conv_C"].to(cdt), t.get("conv_C"),
                                    p.get("conv_C_bias"), length)
    A = -torch.exp(p["A_log"])  # (nh,) < 0
    # pad to a chunk multiple: dt=0 on padding makes it a no-op for the state
    # (decay exp(0*A)=1, input contribution dt*B (x) x = 0).  B and C are
    # padded before the group broadcast, which stays a view.
    s_real = x.shape[1]
    pad = (-s_real) % m.chunk_size
    if pad:
        xh, B_, C_, dt = (_pad_seq(u, pad) for u in (xh, B_, C_, dt))
    B_h = _expand_groups(B_, nh)
    C_h = _expand_groups(C_, nh)
    y, final = ssd_chunked(xh, B_h, C_h, dt, A, m.chunk_size)
    if init_state is not None:
        # fold a pre-existing state in analytically: y += C_q exp(cum_q)
        # state, and the final state gains state * exp(total)
        cum_all = torch.cumsum(dt * A, dim=1)  # (B,S,nh)
        y = y + torch.einsum(
            "bqhn,bhnp->bqhp",
            C_h.float() * torch.exp(cum_all)[..., None],
            init_state,
        )
        final = final + init_state * torch.exp(cum_all[:, -1])[:, :, None, None]
    if pad:
        y = y[:, :s_real]
        xh = xh[:, :s_real]
    y = y + xh.float() * p["D_skip"][None, None, :, None]
    y = y.to(cdt) * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg)
    out = proj(y, p["wo"].to(cdt), 2)
    cache = {
        "conv_x": tx,
        "conv_B": tb,
        "conv_C": tc,
        "state": final,
    }
    return out, cache


def _gated_norm(y, scale, cfg):
    """RMSNorm over the flattened inner dim, per mamba2's RMSNormGated."""
    yf = y.float()
    var = yf.square().mean(dim=(-2, -1), keepdim=True)
    yn = yf * torch.rsqrt(var + cfg.norm_eps)
    return (yn * scale.float()).to(dtype_of(cfg.compute_dtype))


def init_mamba_cache(batch: int, cfg: ArchConfig, dtype, device) -> dict:
    m, d_in, nh = mamba_dims(cfg)
    w, g, ds, hd = m.d_conv, m.ngroups, m.d_state, m.head_dim
    dt = dtype_of(dtype)
    return {
        "conv_x": torch.zeros((batch, w - 1, nh, hd), dtype=dt, device=device),
        "conv_B": torch.zeros((batch, w - 1, g, ds), dtype=dt, device=device),
        "conv_C": torch.zeros((batch, w - 1, g, ds), dtype=dt, device=device),
        "state": torch.zeros((batch, nh, ds, hd), dtype=torch.float32,
                             device=device),
    }


MAMBA_CACHE_AXES = {
    "conv_x": ("batch", None, "act_heads", None),
    "conv_B": ("batch", None, None, "ssm_state"),
    "conv_C": ("batch", None, None, "ssm_state"),
    "state": ("batch", "act_heads", "ssm_state", None),
}


def mamba_step(p, x, cfg: ArchConfig, cache, *, active=None, state_out=None):
    """Single-token decode. x: (B,1,D) -> (y, new_cache). O(1) in history.

    The recurrent core, from the conv steps to the D skip, is one call of
    the decode-step kernel op (:func:`repro_torch.kernels.mamba_step.ops.
    mamba_step`); the projections before it and the gate, gated norm and
    ``wo`` after it are plain.  active: optional (B,) bool, the lanes that
    step; the others keep their state and conv tails as they came in (their
    output is zero).  state_out: the tensor the new state is
    written to, and then the cache's conv tails step in place (the paged
    engine passes its state pool's lanes, ``cache["state"]`` itself);
    None: a fresh state and fresh tails, the cache left as it came."""
    cdt = dtype_of(cfg.compute_dtype)
    z, xh, B_, C_, dt = _project_raw(p, x, cfg)  # all (B,1,...)
    out = None if state_out is None else dict(cache, state=state_out)
    y, new = step_ops.mamba_step(xh[:, 0], B_[:, 0], C_[:, 0], dt[:, 0],
                                 cache, p, active=active, out=out)
    y = y[:, None].to(cdt) * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg)
    out = proj(y, p["wo"].to(cdt), 2)
    return out, new

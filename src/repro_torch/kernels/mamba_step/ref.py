"""Plain PyTorch Mamba-2 decode step: the function the CUDA kernel computes.

The recurrent core of ``models/mamba.py::mamba_step`` from the conv steps to
the D skip, in the arithmetic the model's step had before the kernel (its
einsums, casts and roundings, unchanged), so the CPU path stays bit for bit.
One addition: an inactive lane's ``y`` is zero, as the kernel writes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _expand_groups(t, nheads: int):
    """(L,1,g,ds) -> (L,1,nh,ds) by repeating groups (a view for g = 1)."""
    b, s, g, ds = t.shape
    if g == nheads:
        return t
    reps = nheads // g
    return t[:, :, :, None, :].expand(b, s, g, reps, ds).reshape(
        b, s, nheads, ds)


def mamba_step_ref(xh, B, C, dt, tails: dict, state, p: dict, active=None):
    """xh (L,H,P), B and C (L,G,N) before the conv, in the compute dtype; dt
    (L,H) fp32 before its bias and softplus; tails ``conv_x`` (L,w-1,H,P),
    ``conv_B``/``conv_C`` (L,w-1,G,N); state (L,H,N,P) fp32; ``p`` the
    mixer's parameters (``conv_*``, ``conv_*_bias`` where the config has
    them, ``A_log``, ``dt_bias``, ``D_skip``); active: optional (L,) bool.

    Returns (y (L,H,P) in xh's dtype, new tails, new state fp32); inactive
    lanes get their tails and state back unchanged and y = 0."""
    nh = xh.shape[1]
    xh, B_, C_, dt = xh[:, None], B[:, None], C[:, None], dt[:, None]
    dt = F.softplus(dt + p["dt_bias"])  # (L,1,nh) fp32, >= 0

    def conv_step(tail, new, kernel, bias):
        window = torch.cat([tail.to(new.dtype), new], dim=1)  # (L,w,...)
        # contiguous: on CUDA the einsum can return the lanes innermost, and
        # x's layout then passes to the outer product below, whose add over
        # the (L, heads, d_state, head_dim) state then runs ~9x slower
        y = torch.einsum("bw...,w...->b...", window.float(),
                         kernel.float()).contiguous()[:, None]
        if bias is not None:
            y = y + bias.float()
        new_tail = window[:, 1:]
        if active is not None:
            keep = active.view((-1,) + (1,) * (tail.dim() - 1))
            new_tail = torch.where(keep, new_tail, tail.to(new.dtype))
        return F.silu(y).to(new.dtype), new_tail

    xh, tx = conv_step(tails["conv_x"], xh, p["conv_x"], p.get("conv_x_bias"))
    B_, tb = conv_step(tails["conv_B"], B_, p["conv_B"], p.get("conv_B_bias"))
    C_, tc = conv_step(tails["conv_C"], C_, p["conv_C"], p.get("conv_C_bias"))
    B_h = _expand_groups(B_, nh)[:, 0]  # (L,nh,ds)
    C_h = _expand_groups(C_, nh)[:, 0]
    xh1 = xh[:, 0]  # (L,nh,hd)
    dt1 = dt[:, 0]  # (L,nh)
    if active is not None:
        dt1 = dt1 * active[:, None]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A)  # (L,nh)
    st = state * decay[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", B_h.float() * dt1[..., None], xh1.float()
    )
    y = torch.einsum("bhn,bhnp->bhp", C_h.float(), st)
    y = y + xh1.float() * p["D_skip"][None, :, None]
    y = y.to(xh1.dtype)
    if active is not None:
        y = y.masked_fill(~active[:, None, None], 0)
    return y, {"conv_x": tx, "conv_B": tb, "conv_C": tc}, st

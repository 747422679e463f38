"""Plain PyTorch SSD chunked scan: the function the CUDA kernel computes.

A copy of the JAX package's oracle (``kernels/ssd_scan/ref.py``): the chunked
einsums, with the inter-chunk recurrence as a Python loop over the chunks.
One change, in how the decay matrix is masked, keeps its gradient finite at
long chunks (see ``L`` below; ROADMAP.md, C5).
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, B, C, dt, A, chunk: int):
    """x: (b,S,h,p); B,C: (b,S,h,n); dt: (b,S,h) >= 0; A: (h,) < 0.

    Returns (y: (b,S,h,p), final_state: (b,h,n,p)), both fp32, or both
    fp64 for a float64 x (a more precise evaluation of the same function,
    which the kernel checks compare against).
    """
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc, Q = s // chunk, chunk

    def r(t):
        return t.to(ct).reshape((b, nc, Q) + tuple(t.shape[2:]))

    xc, Bc, Cc, dtc = r(x), r(B), r(C), r(dt)
    dA = dtc * A.to(ct)
    cum = torch.cumsum(dA, dim=2)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    # exp of the masked difference, where the JAX oracle takes the exp of
    # all of rel and masks after: above the diagonal rel is positive, and at
    # long chunks its exp overflows to inf, which the mask drops from the
    # value but not from the gradient (0 * inf = NaN).  Same values.
    L = torch.exp(torch.where(causal, rel,
                              torch.full((), -torch.inf, dtype=ct,
                                         device=x.device)))
    scores = torch.einsum("bcqhn,bcthn->bcqth", Cc, Bc) * L
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", scores, xdt)
    w_end = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_states = torch.einsum("bcthn,bcthp->bchnp", Bc * w_end[..., None],
                                xdt)
    total = torch.exp(cum[:, :, -1, :])

    st = torch.zeros((b, h, n, p), dtype=ct, device=x.device)
    st_in = []
    # unbind, not one index per chunk: the gradient is then one stack, where
    # indexing would add a zero-filled copy of the whole tensor per chunk
    for cs, tot in zip(chunk_states.unbind(1), total.unbind(1)):
        st_in.append(st)
        st = st * tot[:, :, None, None] + cs
    st_in = torch.stack(st_in, dim=1)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Cc * torch.exp(cum)[..., None], st_in)
    return (y_intra + y_inter).reshape(b, s, h, p), st

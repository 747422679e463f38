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


# -- the plain versions of the three bf16 kernels (csrc/ssd_scan.cu) ----------
#
# The CUDA kernel splits the scan into a chunk-state kernel, a state-passing
# kernel and a chunk-output kernel (arXiv:2405.21060 §6).  Composed, these
# three functions give ``ssd_scan_ref``.  ``bf16=True`` rounds the operands
# that the kernels feed the tensor cores at the points where they round
# them, and nowhere else; every sum stays in the working precision.


def split_bf16(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel feeds it to a bf16 product in two parts: the bf16
    rounding of t plus the bf16 rounding of what is left (~16 bits)."""
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi + (t - hi).to(torch.bfloat16).to(t.dtype)


def _chunked(t, chunk: int, ct):
    b, s = t.shape[:2]
    return t.to(ct).reshape((b, s // chunk, chunk) + tuple(t.shape[2:]))


def chunk_state_ref(x, B, dt, A, chunk: int, *, bf16: bool = False):
    """Kernel 1, one block per (batch, chunk, head).

    Returns ``cum`` (b, nc, Q, h), the inclusive cumsum of dt A within each
    chunk; ``states`` (b, nc, h, n, p), each chunk's state input
    (B exp(cum_end - cum))^T (x dt); ``decay`` (b, nc, h) = exp(cum_end).
    ``bf16``: the kernel's x dt exp(cum_end - cum) as bf16 high and low
    parts (B is bf16 already)."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    if x.shape[1] % chunk:
        raise ValueError(f"seq {x.shape[1]} % chunk {chunk} != 0")
    xc, Bc, dtc = (_chunked(t, chunk, ct) for t in (x, B, dt))
    cum = torch.cumsum(dtc * A.to(ct), dim=2)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc           # (b, nc, Q, h)
    xw = xc * w[..., None]
    if bf16:
        xw = split_bf16(xw)
    states = torch.einsum("bcthn,bcthp->bchnp", Bc, xw)
    return cum, states, torch.exp(cum[:, :, -1, :])


def state_pass_ref(states, decay):
    """Kernel 2, serial over the chunks: the state entering each chunk
    (zero before the first), and the final state.  states: (b, nc, h, n,
    p); decay: (b, nc, h).  Returns (st_in like states, final (b, h, n,
    p))."""
    st = torch.zeros_like(states[:, 0])
    st_in = []
    for cs, tot in zip(states.unbind(1), decay.unbind(1)):
        st_in.append(st)
        st = st * tot[:, :, None, None] + cs
    return torch.stack(st_in, dim=1), st


def chunk_out_ref(x, B, C, dt, cum, st_in, chunk: int, *, bf16: bool = False):
    """Kernel 3, one block per (batch, chunk, head, 128 query rows).

    y = ((C B^T) o L o dt_t) x + exp(cum_q) (C st_in), L = tril(exp(cum_q -
    cum_t)): the decay and dt scale the fp32 scores, so x enters the
    product as it is.  ``bf16``: the scores' product with x takes them as
    bf16 high and low parts, and st_in as bf16 high and low parts (C, B
    and x are bf16 already).  Returns y (b, S, h, p) in cum's dtype."""
    ct = cum.dtype
    b, s, h, p = x.shape
    xc, Bc, Cc, dtc = (_chunked(t, chunk, ct) for t in (x, B, C, dt))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.exp(torch.where(causal, rel, torch.full((), -torch.inf,
                                                      dtype=ct,
                                                      device=x.device)))
    P = torch.einsum("bcqhn,bcthn->bcqth", Cc, Bc) * L * dtc[:, :, None]
    st = st_in
    if bf16:
        P, st = split_bf16(P), split_bf16(st_in)
    y = torch.einsum("bcqth,bcthp->bcqhp", P, xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bcqhn,bchnp->bcqhp",
                                                      Cc, st)
    return y.reshape(b, s, h, p)

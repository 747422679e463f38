"""Plain PyTorch pieces of the references: RMSNorm, RoPE, attention, SwiGLU,
and the matmul every one of them goes through.

Everything computes in float32 with TF32 off (:func:`strict_fp32`).  A
:class:`Precision` of ``"fp8"`` rounds both operands of every matmul to
float8 e4m3 (one scale a tensor, its largest magnitude at 448) before the
float32 product: the control of a bfloat16 configuration, the precision a
later change could be tempted to step down to.  Its backward passes the
gradient straight through the rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in float32; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Precision:
    """How the reference multiplies: ``"fp32"`` or ``"fp8"``."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def r(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_round(x) if self.name == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n)."""
        return self.r(x) @ self.r(w)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, H, hd), positions (S,): rotate-half RoPE."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(pr: Precision, q, k, v, *, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, K, hd), query i at position i (a
    causal query sees keys j <= i); query head h reads key head
    h // (H / K).  Returns (B, Sq, H, hd)."""
    h, kh = q.shape[2], k.shape[2]
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    s = pr.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1))
    s = s / math.sqrt(q.shape[-1])
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return pr.mm(p, v.transpose(1, 2)).transpose(1, 2)


def swiglu(pr: Precision, x, wg, wu, wd) -> torch.Tensor:
    return pr.mm(F.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)

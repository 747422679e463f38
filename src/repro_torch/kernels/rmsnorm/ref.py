"""Plain PyTorch RMSNorm: the function the CUDA kernel computes."""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (..., D); w: (D,).  fp32 statistics; output in ``out_dtype``
    (default ``x.dtype``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)) * w.float()
    return y.to(out_dtype or x.dtype)

"""Flash-attention op: the Hopper kernel on CUDA tensors, the plain version on
the CPU.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_fwd``.  Masks come
as two optional per-row int32 tensors, ``q_offset`` and ``kv_len`` (see
:mod:`~repro_torch.kernels.flash_attention.ref`), which stay on the device so
the serve path never synchronises to build a mask.  Tensors on the CPU go
through :func:`~repro_torch.kernels.flash_attention.ref.attention_ref`; CUDA
tensors launch the kernel or raise.  Serving takes no gradient, so there is
no autograd wrapper yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = _build.LaunchCounter("flash_attention")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
_BLOCK_Q = 16                       # query rows per block (csrc kBlockQ)


def _lib():
    import ctypes

    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        c_void_p, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [c_void_p] * 6 + [c_int] * 7 + [ctypes.c_float, c_int,
                                                      c_void_p]
        fn.restype = c_int
    return fn


def _rows(t: Optional[torch.Tensor], name: str, b: int, device):
    if t is None:
        return None
    if t.shape != (b,) or t.device != device:
        raise ValueError(f"flash attention: {name} must be ({b},) on "
                         f"{device}, got {tuple(t.shape)} on {t.device}")
    return t.to(torch.int32).contiguous()


def _kernel(q, k, v, causal, q_offset, kv_len, scale) -> torch.Tensor:
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel: dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}; one of {list(_DTYPES)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention kernel: q, k, v on different devices")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if -(-sq // _BLOCK_Q) > 65535:
        raise ValueError(f"flash attention kernel: Sq {sq} too long")
    qo = _rows(q_offset, "q_offset", b, q.device)
    kl = _rows(kv_len, "kv_len", b, q.device)
    fn = _lib()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if qo is None else qo.data_ptr(),
             None if kl is None else kl.data_ptr(),
             b, sq, skv, h, kh, d, int(causal), float(scale),
             _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_fwd")
    LAUNCHES.count += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention with native GQA.  q: (B, Sq, H, D); k, v: (B, Skv, K, D);
    q_offset, kv_len: optional (B,) integer tensors.  Returns (B, Sq, H, D)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, sm_scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    return _kernel(q, k, v, causal, q_offset, kv_len, scale)

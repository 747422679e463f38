"""RMSNorm op: the Hopper kernel on a CUDA tensor, the plain version on the CPU.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm/kernel.py:fused_rmsnorm_2d``.  A tensor on the CPU
goes through :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`; a CUDA
tensor launches the kernel or raises.  Serving takes no gradient, so there
is no autograd wrapper yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

LAUNCHES = _build.LaunchCounter("rmsnorm")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 48 * 1024            # the row is staged in shared memory


def _lib():
    import ctypes

    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        c_void_p, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [c_void_p, c_void_p, c_void_p, ctypes.c_int64, c_int,
                       ctypes.c_float, c_int, c_int, c_int, c_void_p]
        fn.restype = c_int
    return fn


def _kernel(x: torch.Tensor, w: torch.Tensor, eps: float,
            out_dtype: torch.dtype) -> torch.Tensor:
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"rmsnorm kernel: {name} dtype {t.dtype} "
                            f"not in {list(_DTYPES)}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel: output dtype {out_dtype}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm kernel: w on {w.device}, x on {x.device}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm kernel: w shape {tuple(w.shape)} != ({d},)")
    if d * x.element_size() > _MAX_SMEM:
        raise ValueError(f"rmsnorm kernel: row of {d} x {x.dtype} exceeds "
                         f"{_MAX_SMEM} bytes of shared memory")
    fn = _lib()
    x2 = x.contiguous().view(-1, d)
    w = w.contiguous()
    y = torch.empty(x2.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], d,
             float(eps), _DTYPES[x.dtype], _DTYPES[w.dtype],
             _DTYPES[out_dtype], stream)
    _build.check(err, "rmsnorm_fwd")
    LAUNCHES.count += 1
    return y.view(x.shape)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w over the last axis; fp32
    statistics, output in ``out_dtype`` (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    return _kernel(x, w, eps, out_dtype)

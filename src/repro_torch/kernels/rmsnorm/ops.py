"""RMSNorm op: the Hopper kernel on a CUDA tensor, the plain version on the CPU.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm/kernel.py:fused_rmsnorm_2d``.  A tensor on the CPU
goes through :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`; a CUDA
tensor launches the kernel or raises.

The op is registered with ``torch.library`` as ``repro_torch::rmsnorm``: its
fake implementation gives the shape alone (one traced node per launch), and
its gradient is the VJP of the plain version, recomputed in the backward
pass, as the JAX op's ``custom_vjp`` does (``repro/kernels/rmsnorm/ops.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

LAUNCHES = _build.LaunchCounter("rmsnorm")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def kernel_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The variant of the kernel that x and w take on the card, by the
    kernel's own rule (``rmsnorm_path`` in the source): "warp" (a warp a
    row), "block" (a block a row) or "scalar"."""
    import ctypes

    fn = _build.load("rmsnorm").rmsnorm_path
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    aligned = all(t.contiguous().data_ptr() % 16 == 0 for t in (x, w))
    code = fn(x.shape[-1], _DTYPES[x.dtype], int(aligned))
    return ("scalar", "warp", "block")[code]


def cost(x, w, eps: float, out_dtype) -> tuple[float, float]:
    """(operations, bytes) of one call: four operations an element (square,
    sum, the two scalings); x and w read once, y written once.  It is the
    bound in ``chip_smoke.py`` and the cost of the op's node in a traced
    graph."""
    out_size = out_dtype.itemsize
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + x.numel() * out_size)
    return 4.0 * x.numel(), float(nbytes)


def _impl(x: torch.Tensor, w: torch.Tensor, eps: float,
          out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    return _kernel(x, w, eps, out_dtype)


_rmsnorm_op = torch.library.custom_op("repro_torch::rmsnorm",
                                      mutates_args=())(_impl)


@_rmsnorm_op.register_fake
def _(x, w, eps, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


def _setup(ctx, inputs, output):
    x, w, eps, _ = inputs
    ctx.eps = eps
    ctx.save_for_backward(x, w)


def _backward(ctx, g):
    # here, not at the top: repro_torch.obs imports the model layer
    from repro_torch.obs.record import prange

    ins = ctx.saved_tensors
    with torch.enable_grad(), prange(
            "repro_torch::rmsnorm.backward"):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ins, ctx.needs_input_grad)]
        y = rmsnorm_ref(*leaves, ctx.eps, torch.float32)
        want = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(y, want, g.float()))
    return (*(next(grads) if t.requires_grad else None for t in leaves),
            None, None)


_rmsnorm_op.register_autograd(_backward, setup_context=_setup)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w over the last axis; fp32
    statistics, output in ``out_dtype`` (default ``x.dtype``)."""
    if x.device.type not in ("cpu", "cuda"):
        # checked before dispatch: a meta tensor would reach the fake kernel
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    return _rmsnorm_op(x, w, float(eps), out_dtype or x.dtype)

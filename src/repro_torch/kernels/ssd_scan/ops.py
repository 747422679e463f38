"""SSD-scan op: the Hopper kernel on CUDA tensors, the plain version on the CPU.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan_pallas`` (``_ssd_kernel``).  The
op is registered with ``torch.library`` as ``repro_torch::ssd_scan``:

* its fake implementation gives the shapes alone, so a graph traced with
  ``make_fx`` holds one node per launch (the JAX package's "one
  ``pallas_call`` = one op");
* its gradient is the VJP of the plain version, recomputed in the backward
  pass, as the JAX op's ``custom_vjp`` does (``repro/kernels/ssd_scan/ops.py``);
  the TPU kernel has no backward kernel, so neither has the port.

Tensors on the CPU go through
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_ref`; CUDA tensors launch
the kernel or raise.  B and C may be broadcast over the head axis (stride 0):
the kernel reads them in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

LAUNCHES = _build.LaunchCounter("ssd_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64                 # csrc kMaxP
MAX_STATE = 128                   # csrc kMaxN


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view covers (a stride-0 broadcast
    axis counts once): what reading the tensor once must move."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def cost(x, B, C, dt, A, chunk: int, out_dtype) -> tuple[float, float]:
    """(operations, bytes) of one call: the least work of the function.

    Per chunk of Q tokens and head: the lower triangle of C B^T and its
    product with x dt (Q(Q+1)/2 pairs, n and p long), C times the entering
    state and the chunk's state input (Q n p each), two operations per
    multiply-add.  Bytes: each input read once (B and C broadcast over the
    heads count once), y and the final state written once.  It is the bound
    in ``chip_smoke.py`` and the cost of the op's node in a traced graph."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    pairs = q * (q + 1) // 2
    ops = b * h * (s // q) * (2 * pairs * (n + p) + 4 * q * n * p)
    out_size = out_dtype.itemsize
    nbytes = (sum(distinct_bytes(t) for t in (x, B, C, dt, A))
              + b * s * h * p * out_size + b * h * n * p * 4)
    return float(ops), float(nbytes)


def _lib():
    import ctypes

    fn = _build.load("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        c_void_p, c_int, c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([c_void_p] * 7 + [c_int] * 6 + [c_i64] * 12
                       + [c_int, c_int, c_void_p])
        fn.restype = c_int
    return fn


def _check(x, B, C, dt, A, chunk, out_dtype):
    b, s, h, p = x.shape
    n = B.shape[-1]
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel: x, B, C dtypes {x.dtype}, "
                        f"{B.dtype}, {C.dtype}; one of {list(_DTYPES)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel: dt and A must be float32, got "
                        f"{dt.dtype}, {A.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"ssd_scan kernel: output dtype {out_dtype}")
    if any(t.device != x.device for t in (B, C, dt, A)):
        raise ValueError("ssd_scan kernel: inputs on different devices")
    if (B.shape != (b, s, h, n) or C.shape != B.shape or dt.shape != (b, s, h)
            or A.shape != (h,)):
        raise ValueError(f"ssd_scan kernel: x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel: head_dim {p} > {MAX_HEAD_DIM} or "
                         f"d_state {n} > {MAX_STATE}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan kernel: seq {s} % chunk {chunk} != 0")


def _kernel(x, B, C, dt, A, chunk: int, out_dtype) -> tuple:
    _check(x, B, C, dt, A, chunk, out_dtype)
    b, s, h, p = x.shape
    n = B.shape[-1]
    # the kernel walks the last axis contiguously; any other stride (the
    # head broadcast's 0 included) it takes as given
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    A = A.contiguous()
    fn = _lib()
    y = torch.empty((b, s, h, p), dtype=out_dtype, device=x.device)
    st = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
             A.data_ptr(), y.data_ptr(), st.data_ptr(), b, s, h, p, n, chunk,
             *x.stride()[:3], *B.stride()[:3], *C.stride()[:3],
             *dt.stride()[:3], _DTYPES[x.dtype], _DTYPES[out_dtype], stream)
    _build.check(err, "ssd_scan_fwd")
    LAUNCHES.count += 1
    return y, st


def _impl(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
          dt: torch.Tensor, A: torch.Tensor, chunk: int,
          out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        y, st = ssd_scan_ref(x, B, C, dt, A, chunk)
        return y.to(out_dtype), st
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    return _kernel(x, B, C, dt, A, chunk, out_dtype)


_ssd_op = torch.library.custom_op("repro_torch::ssd_scan",
                                  mutates_args=())(_impl)


@_ssd_op.register_fake
def _(x, B, C, dt, A, chunk, out_dtype):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p), dtype=out_dtype),
            x.new_empty((b, h, B.shape[-1], p), dtype=torch.float32))


def _setup(ctx, inputs, output):
    x, B, C, dt, A, chunk, _ = inputs
    ctx.chunk = chunk
    ctx.save_for_backward(x, B, C, dt, A)


def _backward(ctx, gy, gst):
    ins = ctx.saved_tensors
    with torch.enable_grad(), torch.profiler.record_function(
            "repro_torch::ssd_scan.backward"):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ins, ctx.needs_input_grad)]
        y, st = ssd_scan_ref(*leaves, ctx.chunk)
        want = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad((y, st), want,
                                         (gy.float(), gst.float())))
    return (*(next(grads) if t.requires_grad else None for t in leaves),
            None, None)


_ssd_op.register_autograd(_backward, setup_context=_setup)


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None) -> tuple:
    """Chunked SSD scan.  x: (b,S,h,p); B, C: (b,S,h,n); dt: (b,S,h) fp32;
    A: (h,) fp32 < 0.  Returns (y (b,S,h,p) in ``out_dtype``, default
    ``x.dtype``; final state (b,h,n,p) fp32)."""
    if x.device.type not in ("cpu", "cuda"):
        # checked before dispatch: a meta tensor would reach the fake kernel
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    return _ssd_op(x, B, C, dt, A, chunk, out_dtype or x.dtype)

"""SSD-scan op: the Hopper kernel on CUDA tensors, the plain version on the CPU.

The kernels (``csrc/ssd_scan.cu``) replace the TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan_pallas`` (``_ssd_kernel``).  In
bf16 a call runs three kernels, chunk-parallel (chunk states, state passing,
chunk outputs; their plain versions are ``ref.chunk_state_ref``,
``state_pass_ref`` and ``chunk_out_ref``), cut as :func:`launch_plan` says,
with scratch that the wrapper allocates; in fp32 one kernel.
``LAUNCHES`` counts op calls, one per call either way.  The op is registered
with ``torch.library`` as ``repro_torch::ssd_scan``:

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

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

LAUNCHES = _build.LaunchCounter("ssd_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64                 # csrc kMaxP
MAX_STATE = 128                   # csrc kMaxN
TILE = 64                         # csrc kT: keys and tokens a tile
ROW_BLOCK = 128                   # csrc kRowBlock: query rows of kernel 3
PASS_THREADS = 256                # csrc kPassThreads
BLOCK_SMEM = 232448               # shared memory a block may use on sm_90
ALL_STAGES = 7                    # csrc `stages`: kernels 1, 2 and 3
KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
           "ssd_chunk_out_kernel")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one bf16 call is cut (grids as CUDA's (x, y, z)).

    ``state_grid`` (nc * h, b): kernel 1, a block per (chunk, head, batch);
    ``pass_grid`` (128 * 64 / 4 / 256, b * h): kernel 2, four state columns
    a thread; ``out_grid`` (nc * h * row_blocks, b): kernel 3, a block per
    (chunk, head, 128 query rows, batch), the row blocks of a (chunk, head)
    adjacent.  ``smem_state`` and ``smem_out``: the dynamic shared memory
    of a kernel-1 and a kernel-3 block.  Scratch
    shapes, the state padded to MAX_STATE x MAX_HEAD_DIM: ``states`` (b,
    nc, h, 128, 64) fp32, each chunk's state input; ``st_in`` (b, nc, h, 2,
    128, 64) bf16, the state entering each chunk as high and low parts;
    ``cum`` (b, nc, h, Q) fp64; ``decay`` (b, nc, h) fp32.  The C side
    sizes its launches itself; :func:`library_plan` reads them back."""
    chunks: int
    row_blocks: int
    state_grid: tuple
    pass_grid: tuple
    out_grid: tuple
    smem_state: int
    smem_out: int
    states: tuple
    st_in: tuple
    cum: tuple
    decay: tuple


def smem_bytes(chunk: int) -> tuple[int, int]:
    """(kernel 1, kernel 3) dynamic shared memory of a block, as the csrc
    lays it out, with bf16 rows padded by 16 bytes and the chunk's tokens
    rounded up to whole tiles (qr): kernel 1 two stages of B (64 x 128) and
    x (64 x 64) and per token cum (fp64) and dt (fp32); kernel 3 two stages
    of B and x (C's 128 rows pass through them first), the entering state's
    high and low parts (128 x 64), cum at each key tile's start (fp64) and
    per token a decay exponent and dt (fp32 each)."""
    qr = -(-chunk // TILE) * TILE
    row_b, row_x = (MAX_STATE + 8) * 2, (MAX_HEAD_DIM + 8) * 2
    ring = 2 * TILE * (row_b + row_x)
    return (ring + qr * (8 + 4),
            ring + 2 * MAX_STATE * row_x + 8 * (qr // TILE) + 8 * qr)


def launch_plan(b: int, s: int, h: int, p: int, n: int,
                chunk: int) -> LaunchPlan:
    """The bf16 kernels' launch plan: a pure function of the shapes.  Raises
    for a head_dim or d_state past the kernels' tiles, and where a block's
    shared memory would pass the card's limit (a chunk over ~15k tokens)."""
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: seq {s} % chunk {chunk} != 0")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel: head_dim {p} > {MAX_HEAD_DIM} or "
                         f"d_state {n} > {MAX_STATE}")
    nc = s // chunk
    row_blocks = -(-chunk // ROW_BLOCK)
    smem_state, smem_out = smem_bytes(chunk)
    if max(smem_state, smem_out) > BLOCK_SMEM:
        raise ValueError(f"ssd_scan kernel: chunk {chunk} needs "
                         f"{max(smem_state, smem_out)} bytes of shared memory "
                         f"a block, over {BLOCK_SMEM}")
    state = (MAX_STATE, MAX_HEAD_DIM)
    return LaunchPlan(
        chunks=nc, row_blocks=row_blocks, state_grid=(nc * h, b),
        pass_grid=(MAX_STATE * MAX_HEAD_DIM // 4 // PASS_THREADS, b * h),
        out_grid=(nc * h * row_blocks, b), smem_state=smem_state,
        smem_out=smem_out, states=(b, nc, h) + state,
        st_in=(b, nc, h, 2) + state, cum=(b, nc, h, chunk), decay=(b, nc, h))


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
        fn.argtypes = ([c_void_p] * 11 + [c_int] * 6 + [c_i64] * 12
                       + [c_int] * 6 + [c_void_p])
        fn.restype = c_int
    return fn


def library_plan(b: int, s: int, h: int, chunk: int, out_dtype) -> dict:
    """What the built library launches for the bf16 kernels at these shapes,
    and the resident blocks an SM that the CUDA runtime reports for each
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, registers
    included): ``{kernel: {"grid", "threads", "smem_dynamic",
    "blocks_per_sm"}}``.  Needs a card; :func:`launch_plan` is the same
    sizes computed in Python."""
    import ctypes

    fn = _build.load("ssd_scan").ssd_scan_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 15)()
    _build.check(fn(b, s, h, chunk, _DTYPES[out_dtype], out), "ssd_scan_plan")
    return {name: {"grid": (out[5 * k], out[5 * k + 1]),
                   "threads": out[5 * k + 2],
                   "smem_dynamic": out[5 * k + 3],
                   "blocks_per_sm": out[5 * k + 4]}
            for k, name in enumerate(KERNELS)}


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


def _vec(t: torch.Tensor) -> bool:
    """Rows of t may be copied 16 bytes at a time (bf16): an aligned base,
    and the row width and the (batch, seq, head) strides multiples of 8."""
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
            and all(st % 8 == 0 for st in t.stride()[:3]))


def launch_uncounted(x, B, C, dt, A, chunk: int, out_dtype, stages: int,
                     scratch=None) -> tuple:
    """Checks, the plan, scratch and the C call, without a count: the op's
    body, and the checks' and timings' way to run the bf16 kernels one at a
    time (``stages``: a bit mask of kernels 1, 2 and 3; ``scratch``: the
    tensors an earlier stage wrote).  Returns (y, final state, scratch),
    scratch the bf16 plan's (states, st_in, cum, decay) tensors (None in
    fp32)."""
    _check(x, B, C, dt, A, chunk, out_dtype)
    b, s, h, p = x.shape
    n = B.shape[-1]
    # the kernels walk the last axis contiguously; any other stride (the
    # head broadcast's 0 included) they take as given
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    A = A.contiguous()
    fn = _lib()
    y = torch.empty((b, s, h, p), dtype=out_dtype, device=x.device)
    st = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    vec = (0, 0, 0)
    if x.dtype == torch.bfloat16:
        plan = launch_plan(b, s, h, p, n, chunk)
        if scratch is None:
            scratch = tuple(torch.empty(shape, dtype=dtype, device=x.device)
                            for shape, dtype in ((plan.states, torch.float32),
                                                 (plan.st_in, torch.bfloat16),
                                                 (plan.cum, torch.float64),
                                                 (plan.decay, torch.float32)))
        vec = (int(_vec(x)), int(_vec(B)), int(_vec(C)))
    ptrs = (None,) * 4 if scratch is None else tuple(
        t.data_ptr() for t in scratch)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
             A.data_ptr(), y.data_ptr(), st.data_ptr(), *ptrs, b, s, h, p, n,
             chunk, *x.stride()[:3], *B.stride()[:3], *C.stride()[:3],
             *dt.stride()[:3], _DTYPES[x.dtype], _DTYPES[out_dtype],
             *vec, stages, stream)
    _build.check(err, "ssd_scan_fwd")
    return y, st, scratch


def _kernel(x, B, C, dt, A, chunk: int, out_dtype) -> tuple:
    y, st, _ = launch_uncounted(x, B, C, dt, A, chunk, out_dtype, ALL_STAGES)
    LAUNCHES.count += 1
    return y, st


def run_stages(x, B, C, dt, A, chunk: int, out_dtype=torch.float32) -> dict:
    """The three bf16 kernels one at a time on CUDA tensors, for checking
    each against its plain version (``chip_smoke.py``, the card tests): a
    dict of kernel 1's ``cum`` (b, nc, h, Q), ``states`` (b, nc, h, n, p)
    and ``decay``, kernel 2's ``st_in`` (its high and low parts summed, like
    ``states``) and ``final``, kernel 3's ``y``.  Not counted in
    ``LAUNCHES`` and not a path of the model."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("ssd_scan stages: bf16 CUDA tensors only")
    n, p = B.shape[-1], x.shape[-1]
    ins = (x, B, C, dt, A, chunk, out_dtype)
    _, _, scratch = launch_uncounted(*ins, 1)
    states, st_in, cum, decay = scratch
    out = {"cum": cum.clone(), "decay": decay.clone(),
           "states": states[..., :n, :p].clone()}
    _, out["final"], _ = launch_uncounted(*ins, 2, scratch)
    out["st_in"] = (st_in[..., 0, :n, :p].float()
                    + st_in[..., 1, :n, :p].float())
    out["y"], _, _ = launch_uncounted(*ins, 4, scratch)
    return out


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
    # here, not at the top: repro_torch.obs imports the model layer
    from repro_torch.obs.record import prange

    ins = ctx.saved_tensors
    with torch.enable_grad(), prange(
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

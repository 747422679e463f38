"""Flash-attention op: the Hopper kernel on CUDA tensors, the plain version on
the CPU.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_fwd``.  Masks come
as two optional per-row int32 tensors, ``q_offset`` and ``kv_len`` (see
:mod:`~repro_torch.kernels.flash_attention.ref`), which stay on the device so
the serve path never synchronises to build a mask.  Tensors on the CPU go
through :func:`~repro_torch.kernels.flash_attention.ref.attention_ref`; CUDA
tensors launch the kernel or raise.

The op is ``torch.library.custom_op("repro_torch::flash_attention")``: one
node of a traced graph per launch and a fake implementation for shapes.  Its
gradient, from the saved q, k and v, dispatches on what it is given: bf16
CUDA tensors go to the backward kernels (``csrc/flash_attention_bwd.cu``),
through a second op, ``repro_torch::flash_attention_bwd`` (one node of a
traced backward, counted by ``BWD_LAUNCHES``); fp32 CUDA tensors and every
CPU tensor take the plain version's VJP, recomputing ``attention_ref`` as
the JAX package's ``custom_vjp`` does (the JAX package has no backward
kernel).

In bf16 the kernel packs each GQA group into one block's rows and splits the
KV sweep across blocks; :func:`launch_plan` chooses the layout and the number
of splits from shapes and the SM count alone (never from the device masks),
and the wrapper allocates the splits' fp32 partials.  A call with more than
one split runs a second, combine kernel; ``LAUNCHES`` counts op calls, one
per call either way.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref,
)

LAUNCHES = _build.LaunchCounter("flash_attention")
# backward calls that launched the backward kernels
BWD_LAUNCHES = _build.LaunchCounter("flash_attention_bwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
_F32_BLOCK_Q = 16                   # fp32 body: query rows per block
BLOCK_N = 64                        # keys per K/V tile (csrc kBlockN)
STAGES = 3                          # tiles in the cp.async ring (csrc kStages)
KEYS_MODE_ROWS = 16                 # at most this many packed rows: keys mode
MAX_SPLITS = 32                     # csrc kMaxSplits: a combine lane each
SM_SMEM = 227 * 1024                # shared memory a block may use on sm_90
# resident blocks per SM the split count aims for: keys-mode blocks are light
# (one 16-row mma tile), so up to four share an SM as far as shared memory
# allows; a rows-mode block is four warps of tensor-core work, one an SM
KEYS_MODE_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one bf16 call is cut: ``split_keys`` (keys mode: one 16-row tile,
    four warps over different keys of each tile) or rows mode (64 rows a
    block, 16 a warp); ``row_tiles`` blocks of packed rows per (batch, KV
    head); ``splits`` blocks over the KV sweep, split s taking
    the key tiles s, s + splits, ...; ``scratch`` the fp32 partials' shape
    (splits, B * Sq * H, D + 2), or None for one split."""
    split_keys: bool
    row_tiles: int
    splits: int
    scratch: Optional[tuple]


def launch_plan(b: int, sq: int, skv: int, h: int, kh: int, d: int,
                sm_count: int) -> LaunchPlan:
    """The bf16 kernel's launch plan: a pure function of shapes and the SM
    count.  The KV sweep is split into as many copies of the unsplit grid
    as fit in one wave of resident blocks, at most one split per key tile
    and MAX_SPLITS: a grid that already fills the SMs keeps one split (and
    no combine)."""
    rows = sq * (h // kh)
    split_keys = rows <= KEYS_MODE_ROWS
    block_rows = KEYS_MODE_ROWS if split_keys else 64
    row_tiles = -(-rows // block_rows)
    base = b * kh * row_tiles
    per_sm = (min(KEYS_MODE_BLOCKS_PER_SM, SM_SMEM // smem_bytes(d))
              if split_keys else 1)
    kv_tiles = max(1, -(-skv // BLOCK_N))
    splits = max(1, min(kv_tiles, MAX_SPLITS, per_sm * sm_count // base))
    scratch = (splits, b * sq * h, d + 2) if splits > 1 else None
    return LaunchPlan(split_keys, row_tiles, splits, scratch)


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one bf16 block: the K and V rings of STAGES
    tiles of BLOCK_N rows, each row padded by 16 bytes."""
    return 2 * STAGES * BLOCK_N * (d + 8) * 2


BWD_BLOCK_M = 64        # csrc kRowsDq: packed rows a dq block, the scratch's padding
BWD_KEYS = 64           # csrc kKeysDkdv: keys a dK/dV block
BWD_STAGES = 2          # csrc kStages of the backward's cp.async rings
BWD_THREADS = 128       # four warps a block, each of 16 rows or keys


def bwd_tile(d: int) -> int:
    """The dq kernel's key tile and the dK/dV kernel's row tile (csrc
    ``tile_of``): 64, or 32 at D = 128."""
    return 64 if d <= 64 else 32


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How the backward kernels cut one bf16 call: ``rows_pad`` the packed
    rows (Sq * H / K) of a (batch, KV head) rounded up to ``BWD_BLOCK_M``;
    the dq kernel's grid (row tiles, B * K) and the dK/dV kernel's (key
    tiles, B * K); ``tile`` their key and row tiles; ``scratch`` the fp32
    LSE and D, (2, B * K * rows_pad); each kernel's dynamic shared memory
    (bytes) and ``held_regs``, the accumulator and fragment registers a
    thread of either kernel holds through its loop (tile + D)."""
    rows_pad: int
    dq_grid: tuple
    dkdv_grid: tuple
    tile: int
    scratch: tuple
    dq_smem: int
    dkdv_smem: int
    held_regs: int


def backward_plan(b: int, sq: int, skv: int, h: int, kh: int,
                  d: int) -> BackwardPlan:
    """The backward kernels' plan: a pure function of shapes (the C side
    sizes its launches the same way, from ``rows_pad``)."""
    rows_pad = -(-sq * (h // kh) // BWD_BLOCK_M) * BWD_BLOCK_M
    tile, stride = bwd_tile(d), (d + 8) * 2
    return BackwardPlan(
        rows_pad=rows_pad,
        dq_grid=(rows_pad // BWD_BLOCK_M, b * kh),
        dkdv_grid=(-(-skv // BWD_KEYS), b * kh),
        tile=tile,
        scratch=(2, b * kh * rows_pad),
        dq_smem=BWD_STAGES * 2 * tile * stride,
        dkdv_smem=(2 * BWD_KEYS * stride
                   + BWD_STAGES * (2 * tile * stride + 2 * tile * 4)),
        held_regs=tile + d)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    import ctypes

    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        c_void_p, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([c_void_p] * 7 + [c_int] * 7
                       + [ctypes.c_float, c_int, c_int, c_int, c_void_p])
        fn.restype = c_int
    return fn


def _bwd_lib():
    import ctypes

    fn = _build.load("flash_attention").flash_attention_bwd
    if fn.argtypes is None:
        c_void_p, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([c_void_p] * 10 + [c_int] * 7
                       + [ctypes.c_float, c_int, c_void_p])
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
    if -(-sq // _F32_BLOCK_Q) > 65535 or b * kh > 65535:
        raise ValueError(f"flash attention kernel: grid of Sq {sq}, "
                         f"B * K {b * kh} too large")
    qo = _rows(q_offset, "q_offset", b, q.device)
    kl = _rows(kv_len, "kv_len", b, q.device)
    fn = _lib()
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    split_keys, splits, scratch = False, 1, None
    if q.dtype == torch.bfloat16:
        plan = launch_plan(b, sq, skv, h, kh, d, sm_count(q.device.index or 0))
        split_keys, splits = plan.split_keys, plan.splits
        if plan.scratch is not None:
            scratch = torch.empty(plan.scratch, dtype=torch.float32,
                                  device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if qo is None else qo.data_ptr(),
             None if kl is None else kl.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             b, sq, skv, h, kh, d, int(causal), float(scale),
             _DTYPES[q.dtype], int(split_keys), splits, stream)
    _build.check(err, "flash_attention_fwd")
    LAUNCHES.count += 1
    return o


def _kernel_backward(q, k, v, g, causal, q_offset, kv_len, scale):
    """(dq, dk, dv) of one bf16 call from the backward kernels."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, g)):
        raise TypeError(f"flash attention backward kernel: dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}, {g.dtype}; bf16 only")
    if any(t.device != q.device for t in (k, v, g)):
        raise ValueError("flash attention backward kernel: tensors on "
                         "different devices")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kh
            or g.shape != q.shape):
        raise ValueError(f"flash attention backward kernel: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, grad {tuple(g.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention backward kernel: head_dim {d} not "
                         f"in {HEAD_DIMS}")
    if b * kh > 65535:
        raise ValueError(f"flash attention backward kernel: B * K {b * kh} "
                         "too large")
    if q.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v))
    qo = _rows(q_offset, "q_offset", b, q.device)
    kl = _rows(kv_len, "kv_len", b, q.device)
    fn = _bwd_lib()
    plan = backward_plan(b, sq, skv, h, kh, d)
    q, k, v, g = (_aligned(t) for t in (q, k, v, g))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             None if qo is None else qo.data_ptr(),
             None if kl is None else kl.data_ptr(), scratch.data_ptr(),
             b, sq, skv, h, kh, d, int(causal), float(scale), plan.rows_pad,
             stream)
    _build.check(err, "flash_attention_bwd")
    BWD_LAUNCHES.count += 1
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernel's cp.async)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def cost(q, k, v, causal: bool, q_offset=None, kv_len=None, sm_scale=None
         ) -> tuple[float, float]:
    """(operations, bytes) of one call: the least work of the function.

    Operations: Q K^T and P V, two multiply-adds (four operations) per head
    dimension for every key a row sees.  Bytes: q read and the output
    written once; each KV head's K and V read once for every key that any
    query of the batch row sees (the GQA group shares them); the int32
    masks.  ``q_offset`` and ``kv_len`` are read on the host: call it
    outside any timed region.  It is the bound in ``chip_smoke.py`` and the
    cost of the op's node in a traced graph (``sm_scale`` does not change
    it), where the masks must be ``None``: a traced mask has no values."""
    from torch._subclasses.fake_tensor import is_fake

    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t is not None and is_fake(t):
            raise ValueError(f"flash attention cost: {name} is a traced "
                             "tensor; the cost reads the masks' values on "
                             "the host, so a traced call must pass None")
    offs = [0] * b if q_offset is None else [int(x) for x in q_offset.tolist()]
    lens = [skv] * b if kv_len is None else [int(x) for x in kv_len.tolist()]
    seen = read = 0
    for off, ln in zip(offs, lens):
        lim = min(max(ln, 0), skv)
        if causal:
            seen += sum(min(lim, max(0, off + i + 1)) for i in range(sq))
            read += min(lim, max(0, off + sq))
        else:
            seen += sq * lim
            read += lim
    masks = sum(4 * b for t in (q_offset, kv_len) if t is not None)
    nbytes = (2 * read * kh * d * k.element_size()
              + 2 * b * sq * h * d * q.element_size() + masks)
    return float(4 * h * d * seen), float(nbytes)


def backward_cost(q, k, v, dout, causal: bool, q_offset=None, kv_len=None,
                  sm_scale=None) -> tuple[float, float]:
    """(operations, bytes) of one backward call: the least work.

    Operations: S = q k^T, dP = do v^T, dq, dk and dv, five products where
    the forward has two (2.5 times :func:`cost`'s).  Bytes: the forward's
    reads (q, the keys' K and V, the masks), do read in place of the output
    written, and dq, dk and dv written.  The bound in ``chip_smoke.py`` and
    the cost of a ``repro_torch::flash_attention_bwd`` node."""
    ops, nbytes = cost(q, k, v, causal, q_offset, kv_len, sm_scale)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = (b * sq * h * d + 2 * b * skv * kh * d) * q.element_size()
    return 2.5 * ops, nbytes + float(out)


def _impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset: Optional[torch.Tensor], kv_len: Optional[torch.Tensor],
          sm_scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        # contiguous, as the kernel's output (and the fake's)
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, sm_scale=sm_scale).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    return _kernel(q, k, v, causal, q_offset, kv_len, sm_scale)


_flash_op = torch.library.custom_op("repro_torch::flash_attention",
                                    mutates_args=())(_impl)


@_flash_op.register_fake
def _(q, k, v, causal, q_offset, kv_len, sm_scale):
    return q.new_empty(q.shape)


def _bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              dout: torch.Tensor, causal: bool,
              q_offset: Optional[torch.Tensor], kv_len: Optional[torch.Tensor],
              sm_scale: float) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    if q.device.type == "cpu":
        grads = attention_bwd_ref(q, k, v, dout, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len,
                                  sm_scale=sm_scale)
        # contiguous, as the kernels' outputs (and the fake's)
        return tuple(gr.to(t.dtype).contiguous()
                     for gr, t in zip(grads, (q, k, v)))
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward: no kernel for device "
                         f"{q.device}")
    return _kernel_backward(q, k, v, dout, causal, q_offset, kv_len, sm_scale)


_flash_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd",
                                        mutates_args=())(_bwd_impl)


@_flash_bwd_op.register_fake
def _(q, k, v, dout, causal, q_offset, kv_len, sm_scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup(ctx, inputs, output):
    q, k, v, causal, q_offset, kv_len, sm_scale = inputs
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.save_for_backward(q, k, v, q_offset, kv_len)


def _backward(ctx, g):
    # here, not at the top: repro_torch.obs imports the model layer
    from repro_torch.obs.record import prange

    q, k, v, q_offset, kv_len = ctx.saved_tensors
    need = ctx.needs_input_grad[:3]
    with prange("repro_torch::flash_attention.backward"):
        if q.device.type == "cuda" and q.dtype == torch.bfloat16:
            grads = _flash_bwd_op(q, k, v, g, ctx.causal, q_offset, kv_len,
                                  ctx.sm_scale)
            return (*(gr if n else None for gr, n in zip(grads, need)),
                    None, None, None, None)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip((q, k, v), need)]
            o = attention_ref(*leaves, causal=ctx.causal, q_offset=q_offset,
                              kv_len=kv_len, sm_scale=ctx.sm_scale)
            want = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(o, want, g))
    return (*(next(grads) if t.requires_grad else None for t in leaves),
            None, None, None, None)


_flash_op.register_autograd(_backward, setup_context=_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention with native GQA.  q: (B, Sq, H, D); k, v: (B, Skv, K, D);
    q_offset, kv_len: optional (B,) integer tensors.  Returns (B, Sq, H, D).
    Differentiable in q, k and v."""
    if q.device.type not in ("cpu", "cuda"):
        # checked before dispatch: a meta tensor would reach the fake kernel
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _flash_op(q, k, v, bool(causal), q_offset, kv_len, float(scale))

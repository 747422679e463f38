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
node of a traced graph per launch, a fake implementation for shapes, and a
gradient that is the plain version's VJP recomputed from the saved q, k and
v, as the JAX package's ``custom_vjp`` recomputes ``attention_ref`` (there
is no backward kernel on either side).

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
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = _build.LaunchCounter("flash_attention")
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


def _setup(ctx, inputs, output):
    q, k, v, causal, q_offset, kv_len, sm_scale = inputs
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.save_for_backward(q, k, v, q_offset, kv_len)


def _backward(ctx, g):
    q, k, v, q_offset, kv_len = ctx.saved_tensors
    with torch.enable_grad(), torch.profiler.record_function(
            "repro_torch::flash_attention.backward"):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v), ctx.needs_input_grad)]
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

"""Paged latent-attention op: the Hopper kernel on CUDA tensors, the plain
version on the CPU.

The kernel (``csrc/mla_attention.cu``) replaces no TPU kernel: the JAX
package has no latent attention.  It serves multi-head latent attention
(``models/mla.py``) in its absorbed form from the paged engine's latent pool:
every head of a token attends over its lane's latent rows up to its own
position, read through the block table with no gather, in a decode call and
in a prefill chunk alike (see the source's note for the design and what
bounds it).  A call is one launch, or two where the keys are split over
blocks (the combine): :func:`launch_plan` chooses the splits from host-known
shapes and the SM count alone, so nothing waits on the device.  The kernel
takes bf16, the published widths' rows (``rank`` 512 of 576), heads in
groups of 64 and pages of a multiple of 32 rows.

The op is registered with ``torch.library`` as
``repro_torch::mla_attention``; its fake implementation gives the output's
shape, so a traced graph holds one node a call.  It has no gradient: the
serve path runs under ``inference_mode``.  ``LAUNCHES`` counts kernel
launches (the combine included).

Tensors on the CPU go through
:func:`~repro_torch.kernels.mla_attention.ref.mla_attention_ref`; CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mla_attention.ref import KEY_TILE, mla_attention_ref

LAUNCHES = _build.LaunchCounter("mla_attention")
ROWS = 64                 # query rows a block (csrc kRows)
WIDTH, RANK = 576, 512    # the rows the kernel takes (csrc kD, kR)
MAX_SPLITS = 16           # the wrapper's cap (csrc kMaxSplits is 64)
KERNELS = ("mla_attn_kernel", "mla_combine_kernel")


def work(keys: list[int], lane_keys: list[int], heads: int,
         width: int = WIDTH, rank: int = RANK,
         el: int = 2) -> tuple[float, float]:
    """(operations, bytes) of a call from its numbers: ``keys`` the keys
    each token sees (its position + 1), ``lane_keys`` the rows each lane
    has read (its largest position + 1).  Two operations a multiply-add of
    every score (``width`` long) and every output column (``rank``); each
    lane's rows read once, q read once and the output written once."""
    ops = 2.0 * sum(keys) * heads * (width + rank)
    nbytes = (sum(lane_keys) * width
              + len(keys) * heads * (width + rank)) * el
    return ops, float(nbytes)


def cost(q, pages, tables, lane, pos, rank: int, scale: float,
         keys=None) -> tuple:
    """(operations, bytes) of one call (:func:`work`): ``keys``, the keys
    each token sees, where the caller knows them (each lane then read to
    its tokens' largest); else every token sees the whole view of a lane
    of its own (the most a call can do: the cost of the op's node in a
    traced graph, where positions and lanes are device values)."""
    T, H, D = q.shape
    el = q.element_size()
    if keys is None:
        view = tables.shape[1] * pages.shape[1]
        return work([view] * T, [view] * T, H, D, rank, el)
    lanes: dict = {}
    for ln, k in zip(lane.tolist(), keys):
        lanes[ln] = max(lanes.get(ln, 0), k)
    return work(list(keys), list(lanes.values()), H, D, rank, el)


def launch_plan(tokens: int, heads: int, view: int, sm_count: int) -> int:
    """Key splits of a call: enough blocks for two on every SM, at most
    :data:`MAX_SPLITS` and at most one key tile a split."""
    blocks = max(1, tokens * heads // ROWS)
    want = math.ceil(2 * sm_count / blocks)
    return max(1, min(want, MAX_SPLITS, -(-view // KEY_TILE)))


_SM: dict[int, int] = {}


def sm_count(index: int) -> int:
    if index not in _SM:
        props = torch.cuda.get_device_properties(index)
        _SM[index] = props.multi_processor_count
    return _SM[index]


def _fn():
    fn = _build.load("mla_attention").mla_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel(q, pages, tables, lane, pos, rank, scale) -> torch.Tensor:
    T, H, _ = q.shape
    view = tables.shape[1] * pages.shape[1]
    splits = launch_plan(T, H, view, sm_count(q.device.index or 0))
    out = torch.empty((T, H, rank), dtype=q.dtype, device=q.device)
    o_part = ml = None
    if splits > 1:
        o_part = torch.empty((splits, T, H, rank), dtype=torch.float32,
                             device=q.device)
        ml = torch.empty((splits, T, H, 2), dtype=torch.float32,
                         device=q.device)
    err = _fn()(q.data_ptr(), pages.data_ptr(), tables.data_ptr(),
                lane.data_ptr(), pos.data_ptr(), out.data_ptr(),
                None if o_part is None else o_part.data_ptr(),
                None if ml is None else ml.data_ptr(), T, H,
                pages.shape[1], tables.shape[1], splits, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mla_attention_fwd")
    LAUNCHES.count += 1 + (splits > 1)
    return out


def _impl(q: torch.Tensor, pages: torch.Tensor, tables: torch.Tensor,
          lane: torch.Tensor, pos: torch.Tensor, rank: int,
          scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return mla_attention_ref(q, pages, tables, lane, pos, rank, scale)
    return _kernel(q, pages, tables, lane, pos, rank, scale)


_op = torch.library.custom_op("repro_torch::mla_attention",
                              mutates_args=())(_impl)


@_op.register_fake
def _(q, pages, tables, lane, pos, rank, scale):
    return q.new_empty(q.shape[:2] + (rank,))


def _check(q, pages, tables, lane, pos, rank: int) -> None:
    T, H, D = q.shape
    if (q.dim() != 3 or pages.dim() != 3 or pages.shape[-1] != D
            or not 0 < rank <= D or tables.dim() != 2
            or lane.shape != (T,) or pos.shape != (T,)):
        raise ValueError(f"mla_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(pages.shape)}, tables "
                         f"{tuple(tables.shape)}, lane {tuple(lane.shape)}, "
                         f"pos {tuple(pos.shape)}, rank {rank}")
    if pages.dtype != q.dtype or any(t.dtype != torch.int32
                                     for t in (tables, lane, pos)):
        raise TypeError(f"mla_attention: q and pages of one dtype, tables, "
                        f"lane and pos int32; got {q.dtype}, {pages.dtype}, "
                        f"{tables.dtype}, {lane.dtype}, {pos.dtype}")
    if q.device.type == "cuda" and (
            q.dtype != torch.bfloat16 or H % ROWS or D != WIDTH
            or rank != RANK or pages.shape[1] % KEY_TILE
            or not pages.is_contiguous()):
        raise ValueError(f"mla_attention kernel: bf16, heads a multiple of "
                         f"{ROWS}, rows of {WIDTH} with rank {RANK}, "
                         f"contiguous pages of a multiple of {KEY_TILE} "
                         f"rows; got {q.dtype}, q {tuple(q.shape)}, rank "
                         f"{rank}, pages {tuple(pages.shape)}")


def mla_attention(q, pages, tables, lane, pos, rank: int,
                  scale: float) -> torch.Tensor:
    """Each token's heads over its lane's latent rows up to its position.

    q (T, H, D): the absorbed query rows; pages (blocks, block_size, D):
    one layer of the latent pool; tables (lanes, max_blocks) int32; lane,
    pos (T,) int32: each token's lane and position (it sees rows 0 ..
    pos); ``rank``: the leading values of a row that are its value (the
    latent); ``scale``: the softmax scale.  Returns (T, H, rank) in q's
    dtype."""
    if q.device.type not in ("cpu", "cuda"):
        # checked before dispatch: a meta tensor would reach the fake kernel
        raise ValueError(f"mla_attention: no kernel for device {q.device}")
    _check(q, pages, tables, lane, pos, rank)
    return _op(q.contiguous(), pages, tables.contiguous(), lane.contiguous(),
               pos.contiguous(), int(rank), float(scale))

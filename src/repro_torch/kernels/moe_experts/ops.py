"""Dropless MoE expert ops: the Hopper kernels on CUDA tensors, the plain
version on the CPU.

The kernels (``csrc/moe_experts.cu``) replace no TPU kernel: the JAX
package's ``models/moe.py::moe_ffn`` is plain ``jnp``, a one-hot dispatch
into capacity slots and einsums over every slot.  They were added for the
serve path, where a capacity no expert can overflow makes those einsums
compute every token for every expert; here only the routed rows are
computed, and the call is bound by the routed experts' weight bytes (see
the source's note).  A call is four launches: the routing (counts, offsets,
each choice's sorted row, the tile table), the gate/up grouped GEMM with
the SwiGLU in its epilogue, the down grouped GEMM, and the combine.  None
reads a device value on the host: the grids are sized for the worst case
(:func:`~repro_torch.kernels.moe_experts.ref.max_tiles`), so the path makes
no host synchronisation.  The kernels take bf16 alone (``models/moe.py``
keeps an fp32 call on the card on its einsum path); the plain version takes
fp32 and bf16.  ``LAUNCHES`` counts kernel launches.

The ops are plain functions, not ``torch.library`` ops: the path runs only
without autograd and outside the dry run (``models/moe.py``), so no traced
graph holds them, and a serve decode step calls them 4 x layers times,
where the custom-op dispatch would add host time to every launch.

Tensors on the CPU go through :mod:`~repro_torch.kernels.moe_experts.ref`;
CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_experts import ref as R

LAUNCHES = _build.LaunchCounter("moe_experts")
_DTYPES = (torch.float32, torch.bfloat16)      # the plain version's
MAX_EXPERTS = 1024                # csrc kMaxExperts
_SIGS = {
    "moe_route": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int] + [ctypes.c_void_p] * 5,
    "moe_expert_gemm": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "moe_combine": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def _fn(name: str):
    fn = getattr(_build.load("moe_experts"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cost(x, expert_idx, wg, wu, wd, experts_hit=None,
         rows=None) -> tuple:
    """(operations, bytes) of one call: 2 operations a multiply-add of the
    routed rows' three products (6 D F a row); the weights of each expert
    with rows read once (``experts_hit``: how many have rows, all E where
    None: the E experts the call holds), x read once, h written and read,
    out written and read, y written once, plus the routing's indices.
    ``rows``: the choices of held experts, where the rank holds part of
    them (every choice where None).  The least a call must move, so the
    bound a kernel time is held to."""
    T, D = x.shape
    E, _, Fe = wg.shape
    n = expert_idx.numel() if rows is None else int(rows)
    hit = E if experts_hit is None else int(experts_hit)
    el = x.element_size()
    ops = 6.0 * n * D * Fe
    weights = hit * (wg[0].numel() + wu[0].numel() + wd[0].numel()) * \
        wg.element_size()
    acts = (T * D + 2 * n * Fe + 2 * n * D + T * D) * el
    return ops, float(weights + acts + n * (8 + 4 + 4))


def _check(x, gate, expert_idx, wg, wu, wd) -> None:
    T, D = x.shape
    E, D_, Fe = wg.shape
    if (x.dtype not in _DTYPES or any(w.dtype != x.dtype
                                      for w in (wg, wu, wd))):
        raise TypeError(f"moe_experts: x and the weights must share one of "
                        f"{list(_DTYPES)}, got {x.dtype}, {wg.dtype}, "
                        f"{wu.dtype}, {wd.dtype}")
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise TypeError(f"moe_experts: the kernels take bfloat16, got "
                        f"{x.dtype}")
    if (D_ != D or tuple(wu.shape) != (E, D, Fe)
            or tuple(wd.shape) != (E, Fe, D) or gate.shape != expert_idx.shape
            or gate.shape[0] != T or gate.dim() != 2):
        raise ValueError(f"moe_experts: x {tuple(x.shape)}, gate "
                         f"{tuple(gate.shape)}, expert_idx "
                         f"{tuple(expert_idx.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if gate.dtype != torch.float32 or expert_idx.dtype != torch.int64:
        raise TypeError(f"moe_experts: gate float32 and expert_idx int64, "
                        f"got {gate.dtype}, {expert_idx.dtype}")
    if x.device.type == "cuda" and (D % 8 or Fe % 8):
        raise ValueError(f"moe_experts kernel: d_model and d_ff_expert must "
                         f"be multiples of 8; got {D}, {Fe}")


def _on(device: torch.device) -> bool:
    """True for CUDA tensors (the kernels); False for the CPU (the plain
    version); raises elsewhere (a meta tensor has no kernel)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"moe_experts: no kernel for device {device}")


def route(expert_idx: torch.Tensor, experts: int,
          partial: bool = False) -> dict:
    """The routing of choices (T, k) int64 over ``experts``:
    :func:`~repro_torch.kernels.moe_experts.ref.route_ref`'s tensors
    (``partial``: choices outside [0, experts) may come, and have no row;
    the kernel drops them whatever ``partial`` says)."""
    if not _on(expert_idx.device):
        return R.route_ref(expert_idx, experts, partial)
    if experts > MAX_EXPERTS:
        raise ValueError(f"moe_experts: at most {MAX_EXPERTS} experts, got "
                         f"{experts}")
    idx = expert_idx.contiguous()
    n = idx.numel()
    tiles = R.max_tiles(n, experts)
    # the tile table first: the kernels read it as 8-byte pairs
    buf = torch.empty(2 * tiles + 2 * n + experts + 1, dtype=torch.int32,
                      device=idx.device)
    rows = {"tiles": buf[:2 * tiles].view(tiles, 2),
            "row_of": buf[2 * tiles:2 * tiles + n],
            "src_tok": buf[2 * tiles + n:2 * tiles + 2 * n],
            "offsets": buf[2 * tiles + 2 * n:]}
    err = _fn("moe_route")(
        idx.data_ptr(), n, idx.shape[1], experts, tiles,
        rows["row_of"].data_ptr(), rows["src_tok"].data_ptr(),
        rows["offsets"].data_ptr(), rows["tiles"].data_ptr(),
        _stream(idx))
    _build.check(err, "moe_route")
    LAUNCHES.count += 1
    return rows


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte boundary (the kernels load 16 bytes at a
    time); a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _gemm(a, src_tok, w0, w1, rows: dict, n_rows: int) -> torch.Tensor:
    K, N = w0.shape[1:]
    out = torch.empty((n_rows, N), dtype=a.dtype, device=a.device)
    err = _fn("moe_expert_gemm")(
        a.data_ptr(), None if src_tok is None else src_tok.data_ptr(),
        w0.data_ptr(), None if w1 is None else w1.data_ptr(),
        rows["offsets"].data_ptr(), rows["tiles"].data_ptr(),
        out.data_ptr(), rows["tiles"].shape[0], K, N, _stream(a))
    _build.check(err, "moe_expert_gemm")
    LAUNCHES.count += 1
    return out


def gate_up(x: torch.Tensor, rows: dict, wg, wu) -> torch.Tensor:
    """h (T k, F): silu(x wg[e]) * (x wu[e]) for each sorted row, its token
    gathered from x (T, D)."""
    if not _on(x.device):
        return R.gate_up_ref(x, rows, wg, wu)
    return _gemm(_aligned(x), rows["src_tok"], _aligned(wg), _aligned(wu),
                 rows, rows["row_of"].numel())


def down(h: torch.Tensor, rows: dict, wd) -> torch.Tensor:
    """out (T k, D): h wd[e] for each sorted row."""
    if not _on(h.device):
        return R.down_ref(h, rows, wd)
    return _gemm(_aligned(h), None, _aligned(wd), None, rows, h.shape[0])


def combine(out: torch.Tensor, rows: dict, gate: torch.Tensor):
    """y (T, D) = sum_j gate[t, j] out[row(t, j)], summed in fp32."""
    if not _on(out.device):
        return R.combine_ref(out, rows, gate)
    T, k = gate.shape
    D = out.shape[1]
    g = gate.contiguous()
    y = torch.empty((T, D), dtype=out.dtype, device=out.device)
    out = _aligned(out)
    err = _fn("moe_combine")(
        out.data_ptr(), rows["row_of"].data_ptr(), g.data_ptr(),
        y.data_ptr(), T, k, D, _stream(out))
    _build.check(err, "moe_combine")
    LAUNCHES.count += 1
    return y


def moe_experts(x, gate, expert_idx, wg, wu, wd,
                partial: bool = False) -> torch.Tensor:
    """The routed experts of tokens x (T, D): ``expert_idx`` (T, k) int64
    distinct experts a token, ``gate`` (T, k) fp32 their weights, experts'
    SwiGLU weights wg, wu (E, D, F) and wd (E, F, D) in x's dtype.  Every
    (token, choice) of an expert in [0, E) is computed; none is dropped.
    Where ``partial`` (the rank holds part of the experts), a choice
    outside it (-1: an expert another rank holds) adds nothing.  Returns
    y (T, D) in x's dtype: four launches on the card (bf16), the plain version on the CPU
    (fp32 or bf16)."""
    _check(x, gate, expert_idx, wg, wu, wd)
    rows = route(expert_idx, wg.shape[0], partial)
    h = gate_up(x, rows, wg, wu)
    return combine(down(h, rows, wd), rows, gate)

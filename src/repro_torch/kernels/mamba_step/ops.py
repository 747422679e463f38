"""Mamba-2 decode-step op: the Hopper kernel on CUDA tensors, the plain
version on the CPU.

The kernel (``csrc/mamba_step.cu``) replaces no TPU kernel: the JAX
package's ``models/mamba.py::mamba_step`` is plain ``jnp``.  It was added
because the decode step's state update is bound by bytes (the fp32 state
read once and written once; see the source's note).  One launch does the
recurrent core of a token for every lane: the three causal conv steps with
their new tails, dt's softplus and decay, the state update, and the readout
``C . state + D x``.  ``LAUNCHES`` counts op calls.  The op is registered
with ``torch.library`` as ``repro_torch::mamba_step``; it writes the new
state and tails into the tensors it is given (``mutates_args``) and returns
y, and its fake implementation gives y's shape alone, so a traced graph
holds one node a call.  It has no gradient: the decode step is not trained.

Tensors on the CPU go through
:func:`~repro_torch.kernels.mamba_step.ref.mamba_step_ref`; CUDA tensors
launch the kernel or raise.  Outputs may be their inputs (a step in place,
as the paged engine's state pool takes it); B's and C's tails are then
written to scratch and copied back, since the heads of a group all read
them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_step.ref import mamba_step_ref

LAUNCHES = _build.LaunchCounter("mamba_step")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128                   # csrc kMaxN
MAX_HEAD_DIM = 64                 # csrc kMaxP
MAX_CONV = 4                      # csrc kMaxW
TAILS = ("conv_x", "conv_B", "conv_C")
BIASES = ("conv_x_bias", "conv_B_bias", "conv_C_bias")


def cost(xh, B, C, dt, conv_x, conv_B, conv_C, state, *rest) -> tuple:
    """(operations, bytes) of one call with every lane active: per state
    element three operations of the update and two of the readout; the
    state read once and written once, every other input read once, the
    tails and y written once.  A lane that does not step moves none of its
    state: the bound of a call with k lanes active is this cost at k
    lanes.  It is the bound in ``chip_smoke.py`` and the cost of the op's
    node in a traced graph (``rest``: the op's other arguments, read for
    their bytes)."""
    lanes, h, p = xh.shape
    n, w = B.shape[-1], conv_x.shape[1] + 1
    g = B.shape[1]
    ops = lanes * (5 * h * n * p + 2 * w * (h * p + 2 * g * n))
    ins = (xh, B, C, dt, conv_x, conv_B, conv_C, state) + tuple(
        t for t in rest[:9] if isinstance(t, torch.Tensor))
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + state.numel() * 4
              + sum(t.numel() * t.element_size()
                    for t in (conv_x, conv_B, conv_C, xh)))
    return float(ops), float(nbytes)


def _lib():
    import ctypes

    fn = _build.load("mamba_step").mamba_step_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel(xh, B, C, dt, conv_x, conv_B, conv_C, state, w_x, w_B, w_C,
            b_x, b_B, b_C, A_log, dt_bias, D_skip, active, state_out,
            conv_x_out, conv_B_out, conv_C_out) -> torch.Tensor:
    lanes, h, p = xh.shape
    g, n = B.shape[1:]
    if state.data_ptr() % 16 or state_out.data_ptr() % 16:
        raise ValueError("mamba_step kernel: the state is not 16-byte "
                         "aligned")
    ws = (w_x, w_B, w_C) + ((b_x, b_B, b_C) if b_x is not None else ())
    if any(t.dtype != w_x.dtype for t in ws) or w_x.dtype not in _DTYPES:
        ws = tuple(t.float() for t in ws)
    ws = tuple(t.contiguous() for t in ws)
    wb = ws[3:] or (None,) * 3
    # the kernel reads them in fp32 (a serve tree may hold them in bf16)
    A_log, dt_bias, D_skip = (t.float().contiguous()
                              for t in (A_log, dt_bias, D_skip))
    y = torch.empty_like(xh)
    # B's and C's tails in place: the group's heads all read them, so the
    # kernel writes them to scratch, copied back after the launch
    outs = [torch.empty_like(t_in)
            if t_out.data_ptr() == t_in.data_ptr() and g != h else t_out
            for t_in, t_out in ((conv_B, conv_B_out), (conv_C, conv_C_out))]
    act = None if active is None else active.contiguous()
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = _lib()(
        _ptr(xh), _ptr(B), _ptr(C), _ptr(dt), _ptr(conv_x), _ptr(conv_B),
        _ptr(conv_C), _ptr(state), *(_ptr(t) for t in ws[:3]),
        *(_ptr(t) for t in wb), _ptr(A_log), _ptr(dt_bias), _ptr(D_skip),
        _ptr(act), _ptr(state_out), _ptr(conv_x_out), _ptr(outs[0]),
        _ptr(outs[1]), _ptr(y), lanes, h, g, n, p, conv_x.shape[1] + 1,
        _DTYPES[xh.dtype], _DTYPES[ws[0].dtype], stream)
    _build.check(err, "mamba_step_fwd")
    for t_out, written in zip((conv_B_out, conv_C_out), outs):
        if written is not t_out:
            t_out.copy_(written)
    LAUNCHES.count += 1
    return y


def _impl(xh: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
          dt: torch.Tensor, conv_x: torch.Tensor, conv_B: torch.Tensor,
          conv_C: torch.Tensor, state: torch.Tensor, w_x: torch.Tensor,
          w_B: torch.Tensor, w_C: torch.Tensor, b_x: Optional[torch.Tensor],
          b_B: Optional[torch.Tensor], b_C: Optional[torch.Tensor],
          A_log: torch.Tensor, dt_bias: torch.Tensor, D_skip: torch.Tensor,
          active: Optional[torch.Tensor], state_out: torch.Tensor,
          conv_x_out: torch.Tensor, conv_B_out: torch.Tensor,
          conv_C_out: torch.Tensor) -> torch.Tensor:
    if xh.device.type == "cpu":
        p = {"conv_x": w_x, "conv_B": w_B, "conv_C": w_C, "A_log": A_log,
             "dt_bias": dt_bias, "D_skip": D_skip}
        if b_x is not None:
            p.update(zip(BIASES, (b_x, b_B, b_C)))
        y, tails, st = mamba_step_ref(
            xh, B, C, dt, dict(zip(TAILS, (conv_x, conv_B, conv_C))), state,
            p, active)
        state_out.copy_(st)
        for out, t in zip((conv_x_out, conv_B_out, conv_C_out),
                          tails.values()):
            out.copy_(t)
        return y
    if xh.device.type != "cuda":
        raise ValueError(f"mamba_step: no kernel for device {xh.device}")
    return _kernel(xh, B, C, dt, conv_x, conv_B, conv_C, state, w_x, w_B,
                   w_C, b_x, b_B, b_C, A_log, dt_bias, D_skip, active,
                   state_out, conv_x_out, conv_B_out, conv_C_out)


_step_op = torch.library.custom_op(
    "repro_torch::mamba_step",
    mutates_args=("state_out", "conv_x_out", "conv_B_out", "conv_C_out"),
)(_impl)


@_step_op.register_fake
def _(xh, B, C, dt, conv_x, conv_B, conv_C, state, w_x, w_B, w_C, b_x, b_B,
      b_C, A_log, dt_bias, D_skip, active, state_out, conv_x_out, conv_B_out,
      conv_C_out):
    return torch.empty_like(xh)


def _check(xh, B, C, dt, cache, p, active, out):
    lanes, h, hd = xh.shape
    g, n = B.shape[1:]
    w = p["conv_x"].shape[0]
    if xh.dtype not in _DTYPES or B.dtype != xh.dtype or C.dtype != xh.dtype:
        raise TypeError(f"mamba_step: xh, B, C dtypes {xh.dtype}, {B.dtype}, "
                        f"{C.dtype}; one of {list(_DTYPES)}")
    if n > MAX_STATE or hd > MAX_HEAD_DIM or hd % 4 or w > MAX_CONV:
        raise ValueError(f"mamba_step kernel: d_state {n} (at most "
                         f"{MAX_STATE}), head_dim {hd} (at most "
                         f"{MAX_HEAD_DIM}, a multiple of 4), conv width {w} "
                         f"(at most {MAX_CONV})")
    state = cache["state"]
    want = {"state": (lanes, h, n, hd), "conv_x": (lanes, w - 1, h, hd),
            "conv_B": (lanes, w - 1, g, n), "conv_C": (lanes, w - 1, g, n)}
    if (C.shape != B.shape or B.shape[0] != lanes or h % g
            or dt.shape != (lanes, h)
            or any(tuple(cache[k].shape) != s for k, s in want.items())
            or (active is not None and active.shape != (lanes,))):
        raise ValueError(
            f"mamba_step: xh {tuple(xh.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, dt {tuple(dt.shape)}, "
            + ", ".join(f"{k} {tuple(cache[k].shape)}" for k in want))
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError(f"mamba_step: the state must be a contiguous "
                         f"float32 tensor, got {state.dtype}, strides "
                         f"{state.stride()}")
    for k in ("state",) + TAILS:
        t, dtype = out[k], torch.float32 if k == "state" else xh.dtype
        if (t.shape != cache[k].shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"mamba_step: the new {k} must be a contiguous "
                             f"{dtype} tensor of shape "
                             f"{tuple(cache[k].shape)}, got {t.dtype}, "
                             f"{tuple(t.shape)}, strides {t.stride()}")
    if dt.dtype != torch.float32:
        raise TypeError(f"mamba_step: dt must be float32, got {dt.dtype}")


def mamba_step(xh, B, C, dt, cache: dict, p: dict, *, active=None,
               out: Optional[dict] = None) -> tuple:
    """One decode token's recurrent core for every lane.

    xh (L,H,P), B and C (L,G,N): the projections before the conv, in the
    compute dtype; dt (L,H) fp32 before its bias and softplus; cache: the
    conv tails ``conv_x`` (L,w-1,H,P), ``conv_B``/``conv_C`` (L,w-1,G,N) and
    ``state`` (L,H,N,P) fp32, contiguous; p: the mixer's parameters;
    active: optional (L,) bool, the lanes that step (the others keep state
    and tails, and get y = 0).  out: the tensors the new state and tails
    are written to, with the cache's keys; a tensor of ``cache`` steps it in
    place.  None: fresh tensors, the cache as it came.

    Returns (y (L,H,P) in xh's dtype: ``C . state + D x``, the new cache)."""
    if xh.device.type not in ("cpu", "cuda"):
        # checked before dispatch: a meta tensor would reach the fake kernel
        raise ValueError(f"mamba_step: no kernel for device {xh.device}")
    cache = {k: cache[k].to(xh.dtype) for k in TAILS} | {
        "state": cache["state"]}
    if out is None:
        out = {k: torch.empty_like(v) for k, v in cache.items()}
    _check(xh, B, C, dt, cache, p, active, out)
    xh, B, C, dt = (t.contiguous() for t in (xh, B, C, dt))
    tails = [cache[k].contiguous() for k in TAILS]
    y = _step_op(xh, B, C, dt, *tails, cache["state"], p["conv_x"],
                 p["conv_B"], p["conv_C"], *(p.get(k) for k in BIASES),
                 p["A_log"], p["dt_bias"], p["D_skip"], active, out["state"],
                 *(out[k] for k in TAILS))
    return y, dict(out)

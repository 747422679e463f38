"""The Mamba-2 decode-step op (``repro_torch::mamba_step``) on the CPU.

Its CPU path is the plain version (``kernels/mamba_step/ref.py``), the
step's arithmetic as ``models/mamba.py::mamba_step`` had it before the op: a
frozen copy of that function (``_before``) is the reference here, and the
op's output and the model's step must equal it bit for bit.  Also: lanes
that do not step keep their state and tails bit for bit and get y = 0; a
step written in place equals the fresh one; ``torch.library.opcheck``; the
wrapper's shape checks; one traced node a call, priced by the op's cost.
The kernel itself is checked on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels.mamba_step import ops
from repro_torch.models import mamba as MB
from repro_torch.models.layers import dtype_of, proj

LANES = 5


def _cfg(name):
    """The smoke variants at their widths (d_state 16, head_dim 16, 16
    heads): granite (conv bias) in bf16, mamba2 in fp32, mamba2 with two
    groups of B and C, and mamba2 in bf16 with every leaf in bf16, A_log,
    dt_bias and D_skip too (a serve tree, as the dry run's decode cells
    hold it)."""
    arch = {"granite": "granite-4.0-h-small", "mamba2": "mamba2-2.7b",
            "groups": "mamba2-2.7b", "bf16_tree": "mamba2-2.7b"}[name]
    cfg = smoke_variant(get_config(arch))
    if name in ("granite", "bf16_tree"):
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    if name == "groups":
        cfg = dataclasses.replace(
            cfg, mamba=dataclasses.replace(cfg.mamba, ngroups=2))
    return cfg


def _setup(name, seed=0, dtype=None):
    """(cfg, mixer params, x (L,1,D), cache): the init's parameters with
    A_log, dt_bias, D and the conv biases drawn too, and a random cache;
    ``dtype``: another compute dtype."""
    cfg = _cfg(name)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=str(dtype)[6:])
    gen = torch.Generator().manual_seed(seed)
    p = MB.init_mamba(gen, cfg)
    for k in ("A_log", "dt_bias", "D_skip") + ops.BIASES:
        if k in p:
            p[k] = (0.5 * torch.randn(p[k].shape, generator=gen)).to(
                p[k].dtype)
    if name == "bf16_tree":
        p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    cdt = dtype_of(cfg.compute_dtype)
    cache = MB.init_mamba_cache(LANES, cfg, cdt, "cpu")
    cache = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in cache.items()}
    x = torch.randn((LANES, 1, cfg.d_model), generator=gen).to(cdt)
    return cfg, p, x, cache


def _before_core(p, x, cfg, cache, active=None):
    """``models/mamba.py::mamba_step`` before the op, up to the D skip:
    (y fp32 (B,1,nh,hd) rounded to the compute dtype, z, new cache)."""
    _, _, nh = MB.mamba_dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    z, xh, B_, C_, dt = MB._project(p, x, cfg)

    def conv_step(tail, new, kernel, bias):
        window = torch.cat([tail.to(new.dtype), new], dim=1)
        y = torch.einsum("bw...,w...->b...", window.float(),
                         kernel.float()).contiguous()[:, None]
        if bias is not None:
            y = y + bias.float()
        new_tail = window[:, 1:]
        if active is not None:
            keep = active.view((-1,) + (1,) * (tail.dim() - 1))
            new_tail = torch.where(keep, new_tail, tail.to(new.dtype))
        return F.silu(y).to(new.dtype), new_tail

    xh, tx = conv_step(cache["conv_x"], xh, p["conv_x"], p.get("conv_x_bias"))
    B_, tb = conv_step(cache["conv_B"], B_, p["conv_B"], p.get("conv_B_bias"))
    C_, tc = conv_step(cache["conv_C"], C_, p["conv_C"], p.get("conv_C_bias"))
    B_h = MB._expand_groups(B_, nh)[:, 0]
    C_h = MB._expand_groups(C_, nh)[:, 0]
    xh1 = xh[:, 0]
    dt1 = dt[:, 0]
    if active is not None:
        dt1 = dt1 * active[:, None]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A)
    st = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", B_h.float() * dt1[..., None], xh1.float())
    y = torch.einsum("bhn,bhnp->bhp", C_h.float(), st)
    y = y + xh1.float() * p["D_skip"][None, :, None]
    return (y[:, None].to(cdt), z,
            {"conv_x": tx, "conv_B": tb, "conv_C": tc, "state": st})


def _before(p, x, cfg, cache, active=None):
    """The whole step before the op: (out, new cache)."""
    cdt = dtype_of(cfg.compute_dtype)
    y, z, new = _before_core(p, x, cfg, cache, active)
    y = y * F.silu(z)
    y = MB._gated_norm(y, p["norm"], cfg)
    return proj(y, p["wo"].to(cdt), 2), new


def _op_inputs(p, x, cfg):
    _, xh, B_, C_, dt = MB._project_raw(p, x, cfg)
    return xh[:, 0], B_[:, 0], C_[:, 0], dt[:, 0]


def _active():
    return torch.tensor([True, False, True, True, False])


def _equal(a, b):
    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("name", ["granite", "mamba2", "groups",
                                  "bf16_tree"])
def test_step_equals_the_step_before_the_op(name, use_active):
    cfg, p, x, cache = _setup(name)
    active = _active() if use_active else None
    keep = active if use_active else torch.ones(LANES, dtype=torch.bool)
    want_y, _, want_cache = _before_core(p, x, cfg, cache, active)
    y, new = ops.mamba_step(*_op_inputs(p, x, cfg), cache, p, active=active)
    _equal(y[keep], want_y[:, 0][keep])
    for k in want_cache:
        _equal(new[k], want_cache[k])
    out, new = MB.mamba_step(p, x, cfg, cache, active=active)
    want_out, want_cache = _before(p, x, cfg, cache, active)
    _equal(out[keep], want_out[keep])
    for k in want_cache:
        _equal(new[k], want_cache[k])
    assert ops.LAUNCHES.count == 0     # the CPU path launches nothing


@pytest.mark.parametrize("name", ["granite", "groups"])
def test_inactive_lanes_keep_state_and_tails_and_read_zero(name):
    cfg, p, x, cache = _setup(name, seed=1)
    active = _active()
    y, new = ops.mamba_step(*_op_inputs(p, x, cfg), cache, p, active=active)
    for k in cache:
        _equal(new[k][~active], cache[k][~active])
        assert not torch.equal(new[k][active], cache[k][active])
    assert torch.count_nonzero(y[~active]) == 0
    assert torch.count_nonzero(y[active]) > 0


@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("name", ["granite", "groups"])
def test_state_out_in_place_equals_the_fresh_step(name, use_active):
    cfg, p, x, cache = _setup(name, seed=2)
    active = _active() if use_active else None
    fresh_out, fresh = MB.mamba_step(p, x, cfg, cache, active=active)
    pool = {k: v.clone() for k, v in cache.items()}
    out, new = MB.mamba_step(p, x, cfg, pool, active=active,
                             state_out=pool["state"])
    _equal(out, fresh_out)
    for k in cache:
        assert new[k] is pool[k]       # the cache stepped in place
        _equal(pool[k], fresh[k])
    for k in cache:                    # the fresh step left its cache alone
        assert not torch.equal(cache[k], fresh[k])


def _op_args(dtype, seed=3):
    cfg, p, x, cache = _setup("granite", seed, dtype)
    xh, B, C, dt = _op_inputs(p, x, cfg)
    tails = [cache[k] for k in ops.TAILS]
    return (xh, B, C, dt, *tails, cache["state"], p["conv_x"], p["conv_B"],
            p["conv_C"], *(p[k] for k in ops.BIASES), p["A_log"],
            p["dt_bias"], p["D_skip"], _active(),
            torch.empty_like(cache["state"]),
            *(torch.empty_like(t) for t in tails))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck(dtype):
    torch.library.opcheck(ops._step_op, _op_args(dtype))


@pytest.mark.parametrize("what", ["d_state", "head_dim", "contiguous"])
def test_wrapper_checks_raise(what):
    cfg, p, x, cache = _setup("mamba2", seed=4)
    xh, B, C, dt = _op_inputs(p, x, cfg)
    if what == "d_state":
        n = ops.MAX_STATE + 1
        B, C = (torch.zeros(B.shape[:2] + (n,)) for _ in range(2))
        cache = dict(cache, state=torch.zeros(cache["state"].shape[:2]
                                              + (n, xh.shape[-1])),
                     conv_B=torch.zeros(cache["conv_B"].shape[:3] + (n,)),
                     conv_C=torch.zeros(cache["conv_C"].shape[:3] + (n,)))
    elif what == "head_dim":
        hd = ops.MAX_HEAD_DIM + 8
        xh = torch.zeros(xh.shape[:2] + (hd,))
        cache = dict(cache, state=torch.zeros(cache["state"].shape[:3] + (hd,)),
                     conv_x=torch.zeros(cache["conv_x"].shape[:3] + (hd,)))
    else:
        cache = dict(cache, state=cache["state"].transpose(2, 3).contiguous()
                     .transpose(2, 3))
    with pytest.raises(ValueError, match=what.replace("contiguous",
                                                      "contiguous float32")):
        ops.mamba_step(xh, B, C, dt, cache, p)


def test_traced_step_is_one_node_priced_by_the_op():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.fx_graph import graph_from_fx

    cfg, p, x, cache = _setup("granite", seed=5)
    args = _op_args(torch.bfloat16, seed=5)[:-4]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]

        def step(*a):
            return ops.mamba_step(*a[:4], dict(zip(
                ops.TAILS + ("state",), a[4:8])), dict(zip(
                    ("conv_x", "conv_B", "conv_C") + ops.BIASES
                    + ("A_log", "dt_bias", "D_skip"), a[8:17])),
                active=a[17])[0]

        gm = make_fx(step)(*fake)
    nodes = [n for n in graph_from_fx(gm, "decode").nodes
             if n.kind == "custom-call"]
    assert [n.meta["kernel"] for n in nodes] == ["mamba_step"]
    want_ops, want_bytes = ops.cost(*args)
    assert nodes[0].flops == want_ops
    assert nodes[0].in_bytes + nodes[0].out_bytes == want_bytes

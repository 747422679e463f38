"""The port's SSD-scan op against the JAX package's.

On the CPU the op runs its plain version (``kernels/ssd_scan/ref.py``); it
is held against the JAX package's public op (the Pallas kernel, in interpret
mode on the CPU, as the JAX package's own tests run it) and against its
oracle ``ssd_scan_ref``, over the sweep of ``tests/test_kernels.py``
(fp32 within 2e-4, bf16 within 5e-2), against the token-by-token
recurrence, and in its gradient against ``jax.vjp`` of the JAX op (2e-4).
Inputs are made with numpy from a seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _inputs(seed, b, s, h, p, n, dt_hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.standard_normal((b, s, h, n)).astype(np.float32),
            rng.standard_normal((b, s, h, n)).astype(np.float32),
            rng.uniform(0.01, dt_hi, (b, s, h)).astype(np.float32),
            (-np.exp(rng.standard_normal(h))).astype(np.float32))


def _both(arrs, dtype: str):
    """(jax arrays, torch tensors) of the same values; x, B, C in ``dtype``,
    dt and A in fp32."""
    jx = [jnp.asarray(a, dtype if i < 3 else "float32")
          for i, a in enumerate(arrs)]
    tt = [torch.tensor(np.asarray(j, np.float32)).to(getattr(torch, dtype)
                                                     if i < 3 else torch.float32)
          for i, j in enumerate(jx)]
    return jx, tt


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


# tests/test_kernels.py::test_ssd_scan_sweep
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 32, 32),
    (2, 256, 4, 32, 64, 64),
    (1, 192, 1, 64, 128, 64),
    (2, 64, 8, 16, 16, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel_and_oracle(b, s, h, p, n, chunk,
                                                     dtype):
    jx, tt = _both(_inputs(s + n, b, s, h, p, n), dtype)
    n0 = ssd_ops.LAUNCHES.count
    y, st = ssd_scan(*tt, chunk=chunk)
    assert ssd_ops.LAUNCHES.count == n0      # the CPU launches no kernel
    assert y.dtype == tt[0].dtype and st.dtype == torch.float32
    jy, jst = jax_ssd_scan(*jx, chunk=chunk)     # Pallas, interpret mode
    ry, rst = jax_ssd_ref(*jx, chunk)
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    for want_y, want_st in ((jy, jst), (ry, rst)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), **tol)
        np.testing.assert_allclose(_f32(st), _f32(want_st), **tol)


def test_out_dtype_is_explicit():
    _, tt = _both(_inputs(0, 1, 64, 2, 16, 16), "bfloat16")
    y, _ = ssd_scan(*tt, chunk=16, out_dtype=torch.float32)
    yr, _ = ssd_scan_ref(*tt, 16)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, yr, rtol=0, atol=0)


def test_state_equals_sequential_recurrence():
    """tests/test_kernels.py::test_ssd_state_equals_sequential_recurrence"""
    b, s, h, p, n = 1, 64, 2, 8, 16
    x, B, C, dt, A = _inputs(7, b, s, h, p, n, dt_hi=0.5)
    _, st = ssd_scan(*(torch.tensor(a) for a in (x, B, C, dt, A)), chunk=16)
    state = np.zeros((b, h, n, p), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * A)
        contrib = np.einsum("bhn,bhp->bhnp", B[:, t] * dt[:, t][..., None],
                            x[:, t])
        state = state * decay[:, :, None, None] + contrib
    np.testing.assert_allclose(st.numpy(), state, rtol=2e-4, atol=2e-4)


def test_broadcast_heads_read_in_place():
    """B and C broadcast over the heads (stride 0, the model's ngroups = 1)
    give what their materialized copies give."""
    x, B, C, dt, A = _inputs(3, 2, 64, 4, 16, 16)
    t = [torch.tensor(a) for a in (x, B[:, :, :1], C[:, :, :1], dt, A)]
    Bv, Cv = (u.expand(2, 64, 4, 16) for u in t[1:3])
    assert Bv.stride(2) == 0
    y1, s1 = ssd_scan(t[0], Bv, Cv, t[3], t[4], chunk=16)
    y2, s2 = ssd_scan(t[0], Bv.contiguous(), Cv.contiguous(), t[3], t[4],
                      chunk=16)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


def test_gradient_matches_jax_vjp():
    b, s, h, p, n, chunk = 2, 64, 3, 16, 16, 16
    arrs = _inputs(11, b, s, h, p, n)
    rng = np.random.default_rng(12)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gst = rng.standard_normal((b, h, n, p)).astype(np.float32)
    jx = [jnp.asarray(a) for a in arrs]
    _, vjp = jax.vjp(lambda *a: jax_ssd_scan(*a, chunk=chunk), *jx)
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gst)))
    leaves = [torch.tensor(a).requires_grad_() for a in arrs]
    y, st = ssd_scan(*leaves, chunk=chunk)
    grads = torch.autograd.grad((y, st), leaves,
                                (torch.tensor(gy), torch.tensor(gst)))
    for g, jg in zip(grads, jgrads):
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4 * scale)


def test_op_traces_to_one_node():
    """One launch is one traced node (the JAX package's one pallas_call =
    one op), whatever the plain version does inside."""
    from torch.fx.experimental.proxy_tensor import make_fx

    tt = [torch.tensor(a) for a in _inputs(5, 1, 32, 2, 8, 8)]
    gm = make_fx(lambda *a: ssd_scan(*a, chunk=16), tracing_mode="fake")(*tt)
    calls = [n for n in gm.graph.nodes if n.op == "call_function"
             and "ssd_scan" in str(n.target)]
    assert len(calls) == 1


def test_cost_counts_the_triangle_and_broadcast_once():
    x, B, C, dt, A = (torch.tensor(a) for a in _inputs(0, 2, 64, 4, 8, 16))
    Bv, Cv = B[:, :, :1].expand(2, 64, 4, 16), C[:, :, :1].expand(2, 64, 4, 16)
    ops, nbytes = ssd_ops.cost(x, Bv, Cv, dt, A, 16, torch.float32)
    q, pairs = 16, 16 * 17 // 2
    assert ops == 2 * 4 * (64 // q) * (2 * pairs * (16 + 8) + 4 * q * 16 * 8)
    # x, B and C once each (B, C without the head axis), dt, A; y, state
    want = 4 * (2 * 64 * 4 * 8 + 2 * 2 * 64 * 16 + 2 * 64 * 4 + 4
                + 2 * 64 * 4 * 8 + 2 * 4 * 16 * 8)
    assert nbytes == want


def test_gradient_stays_finite_where_the_decay_overflows_above_the_diagonal():
    """At a 256-token chunk with dt |A| ~ 0.7 (the model's init), cum falls
    below -88 within the chunk, so exp(cum_q - cum_t) overflows above the
    diagonal.  The JAX oracle masks after the exp and its VJP gives NaN
    there (ROADMAP.md, C5); the port masks before it: the same values, and
    a finite gradient."""
    b, s, h, p, n, chunk = 1, 256, 2, 4, 4, 256
    x, B, C, dt, A = _inputs(13, b, s, h, p, n)
    dt[:] = 0.7
    A[:] = -1.0
    jx = [jnp.asarray(a) for a in (x, B, C, dt, A)]
    _, vjp = jax.vjp(lambda *a: jax_ssd_ref(*a, chunk), *jx)
    jy, jst = jax_ssd_ref(*jx, chunk)
    jg = vjp((jnp.ones_like(jy), jnp.ones_like(jst)))
    assert not np.isfinite(np.asarray(jg[3])).all()
    leaves = [torch.tensor(a).requires_grad_() for a in (x, B, C, dt, A)]
    y, st = ssd_scan(*leaves, chunk=chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=2e-4, atol=2e-4)
    grads = torch.autograd.grad((y.sum() + st.sum()), leaves)
    assert all(torch.isfinite(g).all() for g in grads)

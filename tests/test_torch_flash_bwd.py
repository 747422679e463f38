"""The flash-attention backward on the CPU: its plain version, its op and
its cost.

``attention_bwd_ref`` computes the gradient as the backward kernels do (LSE,
D = rowsum(P dP), P, dP, dS, the GQA group's sums); it is held here against
``torch.autograd`` of ``attention_ref``.  ``repro_torch::flash_attention_bwd``
is the op the flash op's gradient calls for bf16 CUDA tensors; on the CPU it
computes ``attention_bwd_ref``, and the flash op's own gradient on the CPU
stays the plain VJP.  The CUDA kernels run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.core.fx_graph import graph_from_fx  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref,
)

torch.set_num_threads(2)


def _inputs(seed, b, sq, skv, h, kh, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)

    return t(b, sq, h, d), t(b, skv, kh, d), t(b, skv, kh, d), t(b, sq, h, d)


def _autograd(q, k, v, do, **kw):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)


# (B, Sq, Skv, H, K, D, causal, q_offset, kv_len): GQA groups 1, 4 and 16
# at head dims 32, 64 and 128, causal and not; then the serve-style masks,
# a query block that starts mid-cache, and rows that see no key
BWD_CASES = {
    f"{'causal' if c else 'full'} G{h // kh} D{d}":
        (2, 24, 24 if c else 37, h, kh, d, c, None, None)
    for c in (True, False)
    for h, kh in ((4, 4), (8, 2), (16, 1))
    for d in (32, 64, 128)
}
BWD_CASES.update({
    "q_offset and kv_len, causal": (2, 12, 40, 8, 2, 64, True, [20, 5],
                                    [40, 17]),
    "kv_len < keys, non-causal": (2, 12, 40, 8, 2, 64, False, None, [40, 9]),
    "rows that see no key: kv_len 0": (2, 12, 40, 4, 4, 32, False, None,
                                       [0, 40]),
    "rows that see no key: q_offset < 0": (1, 16, 16, 8, 2, 64, True, [-6],
                                           None),
    "GQA 16 with masks": (2, 5, 70, 32, 2, 128, True, [60, 3], [70, 50]),
})


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_ref_matches_autograd_of_attention_ref(case):
    b, sq, skv, h, kh, d, causal, qo, kl = BWD_CASES[case]
    q, k, v, do = _inputs(7, b, sq, skv, h, kh, d)
    kw = dict(causal=causal,
              q_offset=None if qo is None else torch.tensor(qo),
              kv_len=None if kl is None else torch.tensor(kl))
    want = _autograd(q, k, v, do, **kw)
    got = attention_bwd_ref(q, k, v, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=name)


def test_backward_ref_rows_that_see_no_key_add_nothing():
    """kv_len 0 for batch row 0 and q_offset -6 for row 1: those queries
    get a zero dq, and keys no query sees a zero dk and dv."""
    q, k, v, do = _inputs(3, 2, 10, 30, 8, 2, 64)
    dq, dk, dv = attention_bwd_ref(q, k, v, do, causal=True,
                                   q_offset=torch.tensor([4, -6]),
                                   kv_len=torch.tensor([0, 30]))
    assert not dq[0].any() and not dk[0].any() and not dv[0].any()
    # row 1: query i sees keys j <= i - 6, so queries 0-5 see none, and
    # keys 4 and up are seen by no query
    assert not dq[1, :6].any() and dq[1, 6:].abs().amax() > 0
    assert not dk[1, 4:].any() and not dv[1, 4:].any()


def test_backward_ref_sums_the_gqa_group():
    """dk and dv of a KV head are the sums of the MHA gradients of the
    heads that share it."""
    q, k, v, do = _inputs(5, 1, 16, 16, 8, 2, 32)
    _, dk, dv = attention_bwd_ref(q, k, v, do)
    kr, vr = (t.repeat_interleave(4, dim=2) for t in (k, v))
    _, dk_mha, dv_mha = attention_bwd_ref(q, kr, vr, do)
    torch.testing.assert_close(dk, dk_mha.reshape(1, 16, 2, 4, 32).sum(3))
    torch.testing.assert_close(dv, dv_mha.reshape(1, 16, 2, 4, 32).sum(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_op_on_the_cpu_is_the_plain_version(dtype):
    q, k, v, do = _inputs(11, 2, 20, 20, 8, 2, 32, dtype)
    kw = dict(q_offset=torch.tensor([3, 0]), kv_len=torch.tensor([20, 7]))
    got = fa_ops._flash_bwd_op(q, k, v, do, True, kw["q_offset"],
                               kw["kv_len"], 0.2)
    want = attention_bwd_ref(q, k, v, do, causal=True, sm_scale=0.2, **kw)
    for a, w, t in zip(got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape and a.is_contiguous()
        assert torch.equal(a, w.to(dtype))
    torch.library.opcheck(fa_ops._flash_bwd_op,
                          (q, k, v, do, True, kw["q_offset"], kw["kv_len"],
                           0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_gradient_keeps_the_plain_vjp(dtype):
    """On the CPU the flash op's gradient is ``attention_ref``'s VJP, bit
    for bit, and launches nothing."""
    q, k, v, do = _inputs(13, 2, 24, 24, 8, 2, 64, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0, b0 = fa_ops.LAUNCHES.count, fa_ops.BWD_LAUNCHES.count
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves), leaves, do)
    want = _autograd(q, k, v, do)
    assert (fa_ops.LAUNCHES.count, fa_ops.BWD_LAUNCHES.count) == (n0, b0)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_backward_cost_is_five_products_and_the_gradients_bytes():
    q, k, v, do = _inputs(0, 2, 48, 48, 8, 2, 64, torch.bfloat16)
    ops, nbytes = fa_ops.cost(q, k, v, True)
    b_ops, b_bytes = fa_ops.backward_cost(q, k, v, do, True)
    # S, dP, dq, dk and dv: 2 flops a multiply-add, D of them for each
    # (query, key) pair a head sees
    seen = 2 * 48 * 49 // 2
    assert b_ops == 2.5 * ops == 5 * 2 * 8 * 64 * seen
    # the forward's q in and output out become do in; dq, dk, dv out
    assert b_bytes == nbytes + 2 * (2 * 48 * 8 * 64 + 2 * 2 * 48 * 2 * 64)


def test_backward_node_is_one_custom_call_priced_by_its_cost():
    """A traced call of the backward op is one ``custom-call`` node whose
    operations and bytes are ``backward_cost``'s (as on the card, where the
    flash op's bf16 gradient calls it)."""
    q, k, v, do = _inputs(1, 2, 32, 32, 8, 2, 64, torch.bfloat16)

    def fn(q, k, v, do):
        return fa_ops._flash_bwd_op(q, k, v, do, True, None, None,
                                    1 / math.sqrt(64))

    g = graph_from_fx(make_fx(fn, tracing_mode="fake")(q, k, v, do))
    calls = [n for n in g.nodes if n.kind == "custom-call"]
    assert [n.meta["kernel"] for n in calls] == ["flash_attention_bwd"]
    ops, nbytes = fa_ops.backward_cost(q, k, v, do, True)
    assert calls[0].flops == ops
    assert calls[0].bytes_accessed == nbytes
    assert calls[0].meta["call"]["op"] == "repro_torch::flash_attention_bwd"

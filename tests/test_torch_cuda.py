"""The port's CUDA kernels and engine on a card (marked ``cuda``).

These need an NVIDIA card and the CUDA toolkit; on a host without them they
skip.  Run them on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the card's
machine need not have.)  ``chip_smoke.py`` covers the same kernels at the
full serve and train shapes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_versions(dev, dtype, tol):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(37, 2048, generator=g, device=dev).to(dtype)
    w = torch.randn(2048, generator=g, device=dev)
    n0 = rms.LAUNCHES.count
    torch.testing.assert_close(rms.fused_rmsnorm(x, w), rmsnorm_ref(x, w),
                               rtol=tol, atol=tol)
    assert rms.LAUNCHES.count == n0 + 1
    q = torch.randn(3, 50, 8, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(3, 90, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(3, 90, 2, 64, generator=g, device=dev).to(dtype)
    kw = dict(causal=True, q_offset=torch.tensor([0, 20, 40], device=dev),
              kv_len=torch.tensor([90, 60, 5], device=dev))
    torch.testing.assert_close(fa.flash_attention(q, k, v, **kw),
                               attention_ref(q, k, v, **kw),
                               rtol=tol, atol=tol)


# (B, Sq, Skv, H, K, D, causal, q_offset, kv_len): decode rows whose visible
# keys end around a split boundary (filled in from the card's plan), kv_len
# short of the view, head dims 32 and 128, non-causal Sq != Skv, keys mode
# with several queries and rows mode with MHA
ATTN_EDGE_CASES = {
    "decode at split edges": (8, 1, 2048, 32, 8, 64, True, "split-edges",
                              [2048] * 8),
    "decode kv_len < view": (4, 1, 512, 32, 8, 64, True, [100, 300, 511, 40],
                             [64, 200, 300, 41]),
    "prefill kv_len < view": (2, 64, 512, 32, 8, 64, True, [100, 400],
                              [130, 450]),
    "non-causal kv_len < view": (2, 40, 300, 8, 2, 64, False, None,
                                 [77, 300]),
    "prefill D32": (2, 100, 300, 8, 2, 32, True, [200, 0], [300, 100]),
    "decode D32": (4, 1, 1024, 16, 4, 32, True, [5, 300, 700, 1023], None),
    "prefill D128": (2, 100, 300, 8, 2, 128, True, [200, 0], [300, 100]),
    "decode D128": (4, 1, 1024, 16, 4, 128, True, [5, 300, 700, 1023], None),
    "keys mode 3 queries": (2, 3, 700, 8, 2, 64, True, [600, 10], None),
    "MHA rows mode": (1, 40, 200, 4, 4, 64, True, [160], None),
}


@pytest.mark.parametrize("case", list(ATTN_EDGE_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 4e-3)])
def test_attention_kernel_at_split_and_mask_edges(dev, case, dtype, tol):
    """K/V past kv_len hold 1e4, so a read past the edge shows.  bf16 holds
    chip_smoke.py's attention tolerance (4e-3); one op call counts one
    launch, split and combine kernels together."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, sq, skv, h, kh, d, causal, qo, kl = ATTN_EDGE_CASES[case]
    if qo == "split-edges":
        edge = fa.BLOCK_N * fa.launch_plan(b, sq, skv, h, kh, d,
                                           fa.sm_count(dev.index)).splits
        qo = [n - 1 for n in (edge - 1, edge, edge + 1, 63, 64, 65, 1, skv)]
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device=dev)

    q, k, v = t(b, sq, h, d), t(b, skv, kh, d), t(b, skv, kh, d)
    if kl is not None:
        for i, n in enumerate(kl):
            k[i, n:] = 1e4
            v[i, n:] = 1e4
    kw = dict(causal=causal,
              q_offset=None if qo is None else torch.tensor(qo, device=dev),
              kv_len=None if kl is None else torch.tensor(kl, device=dev))
    n0 = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == n0 + 1
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d,misaligned,path", [
    (7, 2050, False, "scalar"),   # not a multiple of 8
    (16, 8192, False, "block"),   # the widest d_model in configs/
    (5, 2560, True, "scalar"),    # a 16-byte misaligned x
    (3, 12288, False, "block"),   # 48 KB of fp32
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_kernel_at_widths(dev, n, d, misaligned, path, dtype, tol):
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(n * d + 1, generator=g, device=dev).to(dtype)
    x = (x[1:] if misaligned else x[:-1]).view(n, d)
    w = torch.randn(d, generator=g, device=dev)
    assert rms.kernel_path(x, w) == path
    for out_dtype in (dtype, torch.float32):
        torch.testing.assert_close(
            rms.fused_rmsnorm(x, w, out_dtype=out_dtype),
            rmsnorm_ref(x, w, out_dtype=out_dtype), rtol=tol, atol=tol)


def test_engine_on_card_matches_cpu(dev):
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              num_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
               for n in (21, 9)]
    outs = []
    for device in (dev, "cpu"):
        eng = ServeEngine(model, params, slots=2, max_len=48, block_size=8,
                          chunk=8, device=device)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
        outs.append({r.rid: r.output for r in eng.run_until_done()})
    assert outs[0] == outs[1]


def _ssd_inputs(dev, dtype, b, s, h, p, n, bcast, tail=0, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, dtype=dtype):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device=dev)

    x = t(b, s, h, p)
    if bcast:
        B, C = (t(b, s, 1, n).expand(b, s, h, n) for _ in range(2))
    else:
        B, C = t(b, s, h, n), t(b, s, h, n)
    dt = torch.tensor(rng.uniform(0.01, 1.0, (b, s, h)), dtype=torch.float32,
                      device=dev)
    if tail:
        dt[:, s - tail:] = 0.0
    A = torch.tensor(-np.exp(rng.standard_normal(h)), dtype=torch.float32,
                     device=dev)
    return x, B, C, dt, A


# the JAX kernel tests' sweep (tests/test_kernels.py::test_ssd_scan_sweep),
# the train path's shape with B and C broadcast over the heads, and the bf16
# kernels' edges: chunks of 64 and 128, a single chunk, B and C per head at
# chunk 256, dt = 0 on a padded tail (the SSM prefill), a chunk that is not
# a multiple of the 64-row tiles, and rows that cannot be copied 16 bytes at
# a time (head_dim 36, d_state 44: element loads)
@pytest.mark.parametrize("b,s,h,p,n,chunk,bcast,tail", [
    (1, 128, 2, 32, 32, 32, False, 0),
    (2, 256, 4, 32, 64, 64, False, 0),
    (1, 192, 1, 64, 128, 64, False, 0),
    (2, 64, 8, 16, 16, 16, False, 0),
    (2, 512, 8, 64, 128, 256, True, 0),
    (2, 1024, 8, 64, 128, 64, True, 0),
    (2, 1024, 8, 64, 128, 128, True, 0),
    (1, 256, 8, 64, 128, 256, True, 0),
    (1, 1024, 8, 64, 128, 256, False, 0),
    (2, 768, 8, 64, 128, 256, True, 253),
    (1, 384, 2, 64, 128, 96, True, 0),
    (1, 320, 3, 36, 44, 64, False, 0),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
def test_ssd_kernel_matches_plain_version(dev, b, s, h, p, n, chunk, bcast,
                                          tail, dtype, tol):
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    x, B, C, dt, A = _ssd_inputs(dev, dtype, b, s, h, p, n, bcast, tail)
    n0 = ssd.LAUNCHES.count
    y, st = ssd.ssd_scan(x, B, C, dt, A, chunk=chunk,
                         out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES.count == n0 + 1
    # the plain version on the same values, evaluated in fp64: at the train
    # shape y sums 256 terms of magnitude ~5, so two fp32 evaluations in
    # different orders already differ by ~2e-4 where y is near zero
    yr, str_ = ssd_scan_ref(*(t.double() for t in (x, B, C, dt, A)), chunk)
    torch.testing.assert_close(y.double(), yr, rtol=tol, atol=tol)
    torch.testing.assert_close(st.double(), str_, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk,bcast", [
    (2, 1024, 8, 64, 128, 256, True),
    (1, 320, 3, 36, 44, 64, False),
])
def test_ssd_bf16_kernels_one_at_a_time_match_their_plain_versions(
        dev, b, s, h, p, n, chunk, bcast):
    """Kernel 1's cumsum and decays (fp32 tolerance) and chunk states (bf16
    products: 5e-2), kernel 2 fed kernel 1's states (fp32), kernel 3 fed
    the kernels' cum and entering states (5e-2); no launch is counted."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import (
        chunk_out_ref, chunk_state_ref, state_pass_ref,
    )

    ins = _ssd_inputs(dev, torch.bfloat16, b, s, h, p, n, bcast, seed=4)
    n0 = ssd.LAUNCHES.count
    got = ssd.run_stages(*ins, chunk)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES.count == n0
    x, B, C, dt, A = (t.double() for t in ins)
    cum, states, decay = chunk_state_ref(x, B, dt, A, chunk)
    st_in, final = state_pass_ref(got["states"].double(),
                                  got["decay"].double())
    y = chunk_out_ref(x, B, C, dt, got["cum"].transpose(2, 3),
                      got["st_in"].double(), chunk)
    for out, ref, tol in ((got["cum"], cum.transpose(2, 3), 2e-4),
                          (got["decay"], decay, 2e-4),
                          (got["states"], states, 5e-2),
                          (got["st_in"], st_in, 2e-4),
                          (got["final"], final, 2e-4),
                          (got["y"], y, 5e-2)):
        torch.testing.assert_close(out.double(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk,bcast", [
    (2, 512, 4, 64, 128, 256, True),
    (1, 256, 3, 64, 128, 64, False),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
def test_ssd_kernel_takes_a_negative_dt(dev, b, s, h, p, n, chunk, bcast,
                                        dtype, tol):
    """dt of either sign, as the plain version takes it: the bf16 chunk
    outputs multiply the scores by dt (no log of dt), so y stays finite and
    equal to the plain version's."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    x, B, C, dt, A = _ssd_inputs(dev, dtype, b, s, h, p, n, bcast, seed=7)
    dt = dt - 0.3
    assert float(dt.min()) < 0
    y, st = ssd.ssd_scan(x, B, C, dt, A, chunk=chunk,
                         out_dtype=torch.float32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    yr, str_ = ssd_scan_ref(*(t.double() for t in (x, B, C, dt, A)), chunk)
    torch.testing.assert_close(y.double(), yr, rtol=tol, atol=tol)
    torch.testing.assert_close(st.double(), str_, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 2048, 80, 64, 128, 256),
    (1, 384, 2, 64, 128, 96),
    (1, 320, 3, 36, 44, 64),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_ssd_library_launches_what_the_plan_says(dev, b, s, h, p, n, chunk,
                                                 out_dtype):
    """The built library's grids and shared memory are launch_plan's, and
    the runtime keeps at least one block of each kernel on an SM."""
    from repro_torch.kernels.ssd_scan import ops as ssd

    plan = ssd.launch_plan(b, s, h, p, n, chunk)
    lib = ssd.library_plan(b, s, h, chunk, out_dtype)
    want = {"ssd_chunk_state_kernel": (plan.state_grid, plan.smem_state),
            "ssd_state_pass_kernel": (plan.pass_grid, 0),
            "ssd_chunk_out_kernel": (plan.out_grid, plan.smem_out)}
    for name, (grid, smem) in want.items():
        assert (lib[name]["grid"], lib[name]["smem_dynamic"]) == (grid, smem)
        assert lib[name]["blocks_per_sm"] >= 1, name


def test_ssd_kernel_raises_on_what_it_does_not_take(dev):
    from repro_torch.kernels.ssd_scan import ops as ssd

    x, B, C, dt, A = _ssd_inputs(dev, torch.bfloat16, 1, 128, 2, 64, 128,
                                 False)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, B, C, dt, A, chunk=100)
    with pytest.raises(ValueError, match="head_dim"):
        ssd.ssd_scan(torch.cat([x, x[..., :8]], -1), B, C, dt, A, chunk=64)


def test_ssd_and_rmsnorm_gradients_on_card_match_cpu(dev):
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    rng = np.random.default_rng(1)
    b, s, h, p, n = 1, 128, 4, 32, 32
    cpu = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
           for shape in ((b, s, h, p), (b, s, h, n), (b, s, h, n))]
    cpu.append(torch.tensor(rng.uniform(0.01, 1.0, (b, s, h)),
                            dtype=torch.float32))
    cpu.append(torch.tensor(-np.exp(rng.standard_normal(h)),
                            dtype=torch.float32))
    w_cpu = torch.tensor(rng.standard_normal(p), dtype=torch.float32)
    grads = []
    for device in ("cpu", dev):
        ins = [t.to(device).requires_grad_() for t in cpu]
        w = w_cpu.to(device).requires_grad_()
        y, st = ssd_scan(*ins, chunk=64)
        loss = fused_rmsnorm(y, w).square().sum() + st.sum()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, ins + [w])])
    for g_cpu, g_dev in zip(*grads):
        torch.testing.assert_close(g_dev, g_cpu, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_op_at_the_train_shape_matches_plain_version(dev, dtype, tol):
    """One microbatch of llama3.2-1b: q (2, 2048, 32, 64) against k, v
    (2, 2048, 8, 64), causal, no masks, as ``layers.attention`` calls it."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 2048, n, 64, generator=g, device=dev).to(dtype)
               for n in (32, 8, 8))
    n0 = fa.LAUNCHES.count
    out = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES.count == n0 + 1
    torch.testing.assert_close(out, attention_ref(q, k, v), rtol=tol,
                               atol=tol)


def test_flash_gradient_on_card_matches_plain_vjp(dev):
    """The op's gradient is the plain version's VJP: on the card it equals
    ``attention_ref``'s own gradient there and the CPU's; the backward
    launches no kernel."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(2)
    cpu = [torch.tensor(rng.standard_normal((2, 64, n, 32)),
                        dtype=torch.float32) for n in (4, 2, 2)]
    gout = torch.tensor(rng.standard_normal((2, 64, 4, 32)),
                        dtype=torch.float32)
    grads = {}
    for name, device, fn in (("cpu", "cpu", fa.flash_attention),
                             ("op", dev, fa.flash_attention),
                             ("plain", dev, attention_ref)):
        ins = [t.to(device).requires_grad_() for t in cpu]
        out = fn(*ins, causal=True)
        n0 = fa.LAUNCHES.count
        grads[name] = [g.cpu() for g in torch.autograd.grad(
            out, ins, gout.to(device))]
        assert fa.LAUNCHES.count == n0
    for a, b, c in zip(grads["op"], grads["plain"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(a, c, rtol=2e-5, atol=2e-5)


def test_flash_opcheck_on_card(dev):
    from repro_torch.kernels.flash_attention import ops as fa

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 128, n, 64, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_() for n in (8, 2, 2))
    torch.library.opcheck(fa._flash_op, (q, k, v, True, None, None, 0.125))


def test_llama_train_step_at_full_width_two_layers(dev):
    """One train step of llama3.2-1b at its widths (2 of its 16 layers),
    bf16 compute, per-layer remat, grad_accum 2: a finite loss, and per
    microbatch a flash launch a layer for the forward and the recompute and
    an RMSNorm launch per block norm in each, plus the final norm."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train.step import init_state, make_train_step

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    model = build_model(cfg)
    opt = adamw()
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt)
    step = make_train_step(model, opt, cosine_with_warmup(3e-4, 1, 10),
                           grad_accum=2)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTokens(
        cfg.vocab_size, 512, 4, seed=0).batch_at(0).items()}
    f0, r0 = fa.LAUNCHES.count, rms.LAUNCHES.count
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["aux"]) == 0.0
    assert fa.LAUNCHES.count - f0 == 2 * 2 * 2
    assert rms.LAUNCHES.count - r0 == (2 * 2 * 2 + 1) * 2

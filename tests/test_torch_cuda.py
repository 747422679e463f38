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


# the encoder-decoder's and jamba's attention shapes (B, Sq, Skv, H, K, D,
# causal): seamless-m4t's encoder and cross-attention in training (frames as
# long as the tokens), its decoder self-attention, a decode step's cross-
# attention over the 4096-frame memory, and jamba's 64/8 heads of 128
NEW_PATH_SHAPES = {
    "encdec encoder / cross": (4, 2048, 2048, 16, 16, 64, False),
    "encdec decoder self": (4, 2048, 2048, 16, 16, 64, True),
    "encdec cross, Sq != Skv": (2, 300, 2048, 16, 16, 64, False),
    "encdec decode cross": (2, 1, 4096, 16, 16, 64, False),
    "jamba 64/8 heads of 128": (2, 2048, 2048, 64, 8, 128, True),
}


@pytest.mark.parametrize("case", list(NEW_PATH_SHAPES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 4e-3)])
def test_flash_op_at_encdec_and_jamba_shapes(dev, case, dtype, tol):
    """Non-causal rows see every key; no mask, as ``layers.attention``
    calls the op for the encoder and the cross-attention."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, sq, skv, h, kh, d, causal = NEW_PATH_SHAPES[case]
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, skv, kh, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    n0 = fa.LAUNCHES.count
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == n0 + 1
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=causal),
                               rtol=tol, atol=tol)


def test_paged_moe_decode_on_card_matches_sequential_decode(dev):
    """The smoke qwen3-moe at a capacity no group can overflow: prefill one
    request chunk by chunk into the pool on the card, then four decode
    steps, each against ``Model.prefill`` / ``decode`` on the card."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import build_model
    from repro_torch.serve import paged
    from repro_torch.serve.policy import ServeConfig

    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-moe-235b-a22b")),
                              num_layers=2)
    m = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    scfg = ServeConfig(slots=1, max_len=48, block_size=8, chunk=8)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, 19,
                                               dtype=np.int32)
    pool = paged.init_pool(cfg, scfg, dev)
    table = torch.arange(1, scfg.max_blocks_per_slot + 1, dtype=torch.int32,
                         device=dev)
    with torch.inference_mode():
        start = 0
        while start < len(prompt):
            width = min(scfg.chunk, len(prompt) - start)
            toks = np.zeros((1, scfg.bucket(width)), np.int32)
            toks[0, :width] = prompt[start:start + width]
            logits, pool = paged.prefill_chunk(
                params, pool, torch.as_tensor(toks, device=dev), start,
                width, table, 0, cfg, scfg)
            start += width
        want, cache = model.prefill(
            params, torch.as_tensor(prompt[None], device=dev), scfg.max_len)
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
        clen = len(prompt)
        for _ in range(4):
            tok = torch.argmax(want[:, -1], -1)[:, None].to(torch.int32)
            logits, pool = paged.decode_batch(
                params, pool, tok, torch.tensor([clen], dtype=torch.int32,
                                                device=dev),
                table[None], cfg, scfg)
            want, cache = model.decode(params, cache, tok, clen)
            torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
            clen += 1


def test_seamless_smoke_trains_two_steps_on_card(dev):
    """The smoke seamless-m4t through ``launch.train`` on the card: finite
    losses, and a step's kernel launches as the code runs them (per
    microbatch each encoder layer's attention and two block norms, each
    decoder layer's two attentions and three block norms, forward and remat
    recompute, plus the encoder's and the decoder's final norms)."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.launch.train import train

    cfg = smoke_variant(get_config("seamless-m4t-large-v2"))
    counts = []
    seen = [fa.LAUNCHES.count, rms.LAUNCHES.count]

    def on_step(i, rec):
        counts.append((fa.LAUNCHES.count - seen[0],
                       rms.LAUNCHES.count - seen[1]))
        seen[:] = [fa.LAUNCHES.count, rms.LAUNCHES.count]

    _, losses = train(cfg, steps=2, seq=64, batch=4, grad_accum=2,
                      device=dev, on_step=on_step, log_fn=lambda _: None)
    assert np.isfinite(losses).all()
    enc, dec = cfg.encoder_layers, cfg.num_layers
    assert counts == [(2 * 2 * (enc + 2 * dec),
                       2 * (2 * (2 * enc + 3 * dec) + 2))] * 2


@pytest.mark.parametrize("schedule,vstages", [("1f1b", 1), ("gpipe", 1),
                                              ("interleaved_1f1b", 2)])
def test_pp_dp_step_on_card_matches_unpipelined_step(dev, schedule, vstages):
    """llama3.2-1b at its widths (4 of its 16 layers), pp=2 x dp=2 logical
    ranks on the card: the pipelined step's loss and grad norm equal the
    unpipelined step's over the same eight microbatches (grad_accum 8) on
    the same weights and tokens within 1e-4, and so does every gradient
    leaf (the relative norm of the difference of the first moments a step
    from a fresh AdamW state writes; chip_smoke.PP_CHECK_TOL), with a flash
    launch a layer and microbatch for the forward and the recompute."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan
    from repro_torch.optim import adamw
    from repro_torch.train.step import (
        init_state,
        make_pipeline_train_step,
        make_train_step,
    )
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=4)
    model = build_model(cfg)
    opt = adamw()
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt)
    zero_lr = lambda step: torch.zeros((), device=dev)  # noqa: E731
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTokens(
        cfg.vocab_size, 256, 8, seed=0).batch_at(0).items()}
    mesh = make_mesh((2, 2), ("data", "stage"), device=dev)
    plan = make_plan(cfg, 2, 4, schedule=schedule, vstages=vstages)
    pstep = make_pipeline_train_step(model, opt, zero_lr, mesh, plan)

    def run(step, state):
        state = state._replace(opt_state=opt.init(state.params))
        state, m = step(state, batch)
        return state, m, [t.clone() for t in leaves(state.opt_state["m"])]

    f0 = fa.LAUNCHES.count
    state, pm, pmom = run(pstep, state)
    assert fa.LAUNCHES.count - f0 == 8 * cfg.num_layers * 2
    state, rm, rmom = run(make_train_step(model, opt, zero_lr, grad_accum=8),
                          state)
    for k in ("loss", "grad_norm"):
        assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-4)
    errs = [float((p - r).norm() / r.norm()) for p, r in zip(pmom, rmom)]
    assert max(errs) <= 1e-4, errs


def test_compressed_pp_dp_step_on_card_trains(dev):
    """The int8-compressed pp=2 x dp=2 step on the card: losses finite and
    falling over 4 steps at a high learning rate, residuals carried."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.train.step import init_state, make_pipeline_train_step
    from repro_torch.tree import leaves

    cfg = smoke_variant(get_config("llama3.2-1b"))
    model = build_model(cfg)
    opt = adamw()
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt,
                       compression="int8", dp=2)
    mesh = make_mesh((2, 2), ("data", "stage"), device=dev)
    step = make_pipeline_train_step(
        model, opt, cosine_with_warmup(3e-3, 1, 100), mesh,
        make_plan(cfg, 2, 2), compression="int8")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticTokens(
        cfg.vocab_size, 64, 8, seed=0).batch_at(0).items()}
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert max(float(r.abs().max()) for r in leaves(state.comp_state)) > 0


def test_ep_recompute_on_the_autograd_thread_takes_ep(dev):
    """On the card autograd runs the backward, and a "full" remat's
    recompute, on its own device thread, where the thread-local sharding
    context is unset: the recompute must re-enter the forward's context and
    take EP again.  The smoke qwen3-moe (fp32) through EP on 4 logical
    ranks: every MoE call EP, loss and gradients equal the einsum path's."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.models.sharding import make_ctx, use_sharding
    from repro_torch.tree import leaves, tree_map

    cfg = smoke_variant(get_config("qwen3-moe-235b-a22b"))
    cfg = dataclasses.replace(cfg, num_layers=2, moe=dataclasses.replace(
        cfg.moe, impl="ep_a2a"))
    assert cfg.remat_policy == "full"
    model = build_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(), model.init(
        torch.Generator(device=dev).manual_seed(0)))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(1, cfg.vocab_size, (8, 64), generator=g,
                              device=dev) for k in ("tokens", "labels")}
    ctx = make_ctx(make_mesh((4, 1), ("data", "model"), dev))
    moe.reset_ep_calls()
    with use_sharding(ctx):
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves(params))
    assert moe.EP_CALLS == {"ep_a2a": 2 * cfg.num_layers}
    loss_e, _ = model.loss(params, batch)
    grads_e = torch.autograd.grad(loss_e, leaves(params))
    torch.testing.assert_close(loss.detach(), loss_e.detach(), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(grads, grads_e):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_slot_sharded_decode_on_card_matches_unsharded(dev):
    """The decode batch split over 4 logical ranks of the card (2 lanes
    each) against the whole batch in one call, bf16, on one fixed batch:
    logits within the repo's bf16 tolerance of their scale (the lanes' GEMMs
    take other cuBLAS kernels at 2 rows than at 8)."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.build import compute_params, to_device
    from repro_torch.serve import paged
    from repro_torch.serve.policy import ServeConfig

    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              num_layers=2, compute_dtype="bfloat16")
    scfg = ServeConfig(slots=8, max_len=256, block_size=16, chunk=32)
    params = compute_params(to_device(build_model(cfg).init(
        torch.Generator().manual_seed(0)), dev), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    pool = paged.init_pool(cfg, scfg, dev)
    for t in pool.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
    mb = scfg.max_blocks_per_slot
    tables = torch.arange(8 * mb, dtype=torch.int32, device=dev).view(8, mb)
    lens = torch.tensor([5, 40, 100, 255, 0, 17, 128, 200],
                        dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (8, 1), generator=g, device=dev,
                         dtype=torch.int32)
    mesh = make_mesh((4,), ("serve",), dev)
    with torch.inference_mode():
        plain, _ = paged.decode_batch(params, pool, toks, lens, tables + 1,
                                      cfg, scfg)
        sharded, _ = paged.decode_slot_sharded(
            paged.replicas(params, pool, mesh), toks, lens, tables + 1,
            cfg, scfg, mesh)
    assert sharded.shape == plain.shape and sharded.device == plain.device
    scale = float(plain.abs().max())
    torch.testing.assert_close(sharded.float(), plain.float(), rtol=0,
                               atol=2e-2 * max(1.0, scale))


def test_replay_span_covers_its_ops_device_time(dev, monkeypatch):
    """Each F/B replay span is at least the CUDA-event time of the very
    call it measures: the replay synchronises the card before reading the
    clock at both ends.  At one layer of llama3.2-1b at full width over
    2048 tokens the op's device time is several times its launch time, so
    a span without the synchronisation would come out shorter."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan
    from repro_torch.obs import Recorder
    from repro_torch.obs import replay as R

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    plan = make_plan(cfg, 2, 2)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    calls = []
    real_fns = R._chunk_fns

    def timed_fns(*a):
        fns = real_fns(*a)

        def timed(fn):
            def run(*args):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*args)
                ev[1].record()
                calls.append(ev)
                return out
            return run

        return tuple(timed(f) for f in fns)

    monkeypatch.setattr(R, "_chunk_fns", timed_fns)
    pairs = []

    class Rec(Recorder):
        def emit(self, name, device, t0, t1, **kw):
            if kw.get("kind") in ("fwd", "bwd"):
                calls[-1][1].synchronize()
                pairs.append((t1 - t0,
                              calls[-1][0].elapsed_time(calls[-1][1]) / 1e3))
            return super().emit(name, device, t0, t1, **kw)

    mesh = make_mesh((1, 2), ("data", "stage"), dev)
    graph = model_pipeline_graph(cfg, plan.strategy(dp=1), 1, 2048)
    counts = R.replay_pipeline_ops(Rec(), graph, cfg=cfg, plan=plan,
                                   mesh=mesh, params=params, micro_batch=1,
                                   seq=2048, log_fn=lambda s: None)
    assert counts["skipped"] == 0 and len(pairs) == 8
    for span, device_s in pairs:
        assert span >= device_s > 0


def test_checkpoint_of_card_tensors_round_trips(dev, tmp_path):
    """The async checkpointer's snapshot of tensors on the card is a
    completed host copy (the step updates its tensors in place right
    after), and restore places each leaf on its like-leaf's device and
    dtype, bf16 included."""
    from repro_torch.ckpt import AsyncCheckpointer, restore

    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn(64, 32, generator=gen, device=dev)
            .requires_grad_(),
            "h": torch.randn(128, generator=gen, device=dev)
            .to(torch.bfloat16),
            "n": torch.tensor(5, dtype=torch.int32, device=dev)}
    want = {k: v.detach().clone() for k, v in tree.items()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(tree, 5)
    with torch.no_grad():
        for v in tree.values():
            v.add_(1)
    ck.wait()
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    like["w"].requires_grad_()
    restored, step = restore(like, str(tmp_path))
    assert step == 5
    for k, v in restored.items():
        assert v.device == dev and v.dtype == want[k].dtype
        assert torch.equal(v.detach(), want[k]), k
    assert restored["w"].requires_grad
    on_cpu, _ = restore({k: v.cpu() for k, v in want.items()},
                        str(tmp_path))
    assert all(v.device.type == "cpu" for v in on_cpu.values())


def test_psum_scatter_and_the_sweep_on_card(dev):
    """``psum_scatter`` over 4 logical ranks of the card equals the CPU
    mesh's, and the sweep runs every kind there without a skip."""
    from repro_torch.core.database import ProfileDB
    from repro_torch.dist import mesh as M
    from repro_torch.netprof.sweep import SweepConfig, sweep_collectives

    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 16, generator=gen) for _ in range(4)]
    got = {}
    for d in (dev, torch.device("cpu")):
        mesh = M.make_mesh((2, 2), ("data", "model"), d)
        vals = {c: xs[mesh.flat(c)].to(d) for c in mesh.coords()}
        M.reset_traffic()
        got[d.type] = mesh.psum_scatter(vals, "data")
        assert M.TRAFFIC == {"psum_scatter": 4 * 3 * 16 * 4}
    for c, t in got["cuda"].items():
        assert t.device == dev and t.shape == (3, 8)
        torch.testing.assert_close(t.cpu(), got["cpu"][c], rtol=1e-6,
                                   atol=1e-6)
    db = ProfileDB()
    n = sweep_collectives(db, config=SweepConfig.smoke(), ranks=4,
                          device=dev)
    assert n == 5 * 3 * 3      # kinds x payloads x (x, dp, pp)
    meta = db.meta("h100_sxm")["netprof"]
    assert meta["backend"] == "cuda" and meta["ranks"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quantize_on_card_equals_cpu_bit_for_bit(dev, dtype):
    """The int8 cache's quantiser on the card gives the CPU's int8 values
    and bf16 scales bit for bit (true divisions on both: no reciprocal),
    over magnitudes e^-12 .. e^12, an all-zero row and exact ties."""
    from repro_torch.models import layers

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64, 8, 64))
    x *= np.exp(rng.uniform(-12.0, 12.0, (8, 64, 8, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1] = np.resize(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5],
                                    np.float32), 64)
    # amax / 127 an ulp off amax * fl(1/127), and an element whose quotient
    # is 1.4999999 by the one and 1.5 by the other: PyTorch's CUDA kernel
    # multiplies by the reciprocal of a host scalar divisor
    x[2, 2, 2] = 0.0
    x[2, 2, 2, :2] = (1.8894879, 0.022316786)
    t = torch.from_numpy(x).to(dtype)
    q_cpu, s_cpu = layers._kv_quantize(t)
    q, s = layers._kv_quantize(t.to(dev))
    assert q.device.type == "cuda"
    assert torch.equal(q.cpu(), q_cpu)
    assert torch.equal(s.cpu(), s_cpu)
    if dtype == torch.float32:
        assert int(q_cpu[2, 2, 2, 1]) == 1


def test_int8_decode_on_card_matches_cpu_decode(dev):
    """The smoke llama3.2-1b with ``kv_cache_dtype="int8"`` (fp32 compute):
    prefill and four greedy decode steps on the card through the kernels
    against the same on the CPU through the plain versions, within the
    bf16 tolerance (a value on a rounding tie may quantise to its
    neighbour on one device); the int8 leaves agree but for such ties."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              num_layers=2, kv_cache_dtype="int8")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    dparams = tree_map(lambda t: t.to(dev), params)
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 21),
                                               dtype=np.int32)
    with torch.inference_mode():
        lc, cc = model.prefill(params, torch.from_numpy(tokens), 32)
        ld, cd = model.prefill(dparams, torch.from_numpy(tokens).to(dev), 32)
        for k in ("k", "v"):
            diff = (cd[k].cpu().int() - cc[k].int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) \
                < 1e-3, k
        torch.testing.assert_close(ld.cpu(), lc, rtol=2e-2, atol=2e-2)
        clen = tokens.shape[1]
        for _ in range(4):
            tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
            lc, cc = model.decode(params, cc, tok, clen)
            ld, cd = model.decode(dparams, cd, tok.to(dev), clen)
            torch.testing.assert_close(ld.cpu(), lc, rtol=2e-2, atol=2e-2)
            clen += 1
    assert cd["k"].dtype == torch.int8 and cd["k_scale"].device.type == "cuda"


def test_bench_gate_executor_rows_on_card(dev):
    """The port's bench gate's executor rows on the card from the port's own
    seeded init: the worst gradient leaf within the baseline's band (5e-4,
    which does not depend on the init), the loss finite, and the step
    through both kernels."""
    import importlib.util
    import os

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.models import build_model

    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "bench_gate_port.py")
    spec = importlib.util.spec_from_file_location("bench_gate_port", path)
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    params = build_model(gate.exec_config()).init(
        torch.Generator(device=dev).manual_seed(0))
    n_fa, n_rms = fa.LAUNCHES.count, rms.LAUNCHES.count
    loss, grad = gate.execution_rows(params, dev)
    assert fa.LAUNCHES.count > n_fa and rms.LAUNCHES.count > n_rms
    assert loss["launches"]["flash_attention"] > 0
    assert loss["launches"]["rmsnorm"] > 0
    assert np.isfinite(loss["value"])
    assert grad["value"] <= 5e-4

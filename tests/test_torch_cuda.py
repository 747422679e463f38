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


# the JAX kernel tests' sweep (tests/test_kernels.py::test_ssd_scan_sweep)
# plus the train path's shape with B and C broadcast over the heads
@pytest.mark.parametrize("b,s,h,p,n,chunk,bcast", [
    (1, 128, 2, 32, 32, 32, False),
    (2, 256, 4, 32, 64, 64, False),
    (1, 192, 1, 64, 128, 64, False),
    (2, 64, 8, 16, 16, 16, False),
    (2, 512, 8, 64, 128, 256, True),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
def test_ssd_kernel_matches_plain_version(dev, b, s, h, p, n, chunk, bcast,
                                          dtype, tol):
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    rng = np.random.default_rng(0)

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
    A = torch.tensor(-np.exp(rng.standard_normal(h)), dtype=torch.float32,
                     device=dev)
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

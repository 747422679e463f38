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

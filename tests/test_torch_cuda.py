"""The port's CUDA kernels and engine on a card (marked ``cuda``).

These need an NVIDIA card and the CUDA toolkit; on a host without them they
skip.  Run them on the card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the card's
machine need not have.)  ``chip_smoke.py`` covers the same kernels at the
full serve shapes.
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

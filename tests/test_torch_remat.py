"""The port's per-layer remat against the JAX package's policies.

``"dots"`` follows ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
the projections (``layers.proj``, one ``aten.mm`` each) are saved and the
rest of the layer is recomputed, so the backward pass issues no ``aten.mm``
to recompute them; ``"full"`` recomputes the whole layer; ``"none"`` saves
everything.  Every policy computes the same loss and gradients, which match
the JAX package's ``"dots"`` step on the smoke llama3.2-1b within 1e-4
relative to each leaf's largest entry (fp32; the loss within 1e-5).
"""
import dataclasses
from collections import deque

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
MM = torch.ops.aten.mm.default


class CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched while active (the backward pass's
    included: the engine carries the mode into its thread)."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _smoke(configs, arch, **kw):
    return dataclasses.replace(
        configs.smoke_variant(configs.get_config(arch)), num_layers=2, **kw)


def _batch(cfg, rng, b=2, s=32):
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


def _port_step(arch, policy, params_np, batch):
    """(loss, grads, forward mm count, backward mm count) of one port loss
    and gradient under ``policy``."""
    model = build_model(_smoke(port_configs, arch, remat_policy=policy))
    params = load_jax_params(params_np, device="cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with CountOps() as fwd:
        loss, _ = model.loss(params, tb)
    with CountOps() as bwd:
        grads = torch.autograd.grad(loss, flat)
    return (float(loss.detach()), [g.numpy() for g in grads],
            fwd.counts.get(MM, 0), bwd.counts.get(MM, 0))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_policies_match_jax_dots_and_dots_recomputes_no_mm(arch):
    jcfg = _smoke(jax_configs, arch)
    assert jcfg.remat_policy == "dots"
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg, np.random.default_rng(0))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jb)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    runs = {}
    for policy in ("none", "full", "dots"):
        loss, grads, fwd_mm, bwd_mm = _port_step(arch, policy, params_np,
                                                 batch)
        assert loss == pytest.approx(float(jloss), rel=LOSS_RTOL)
        for g, r in zip(grads, want):
            np.testing.assert_allclose(
                g, r, rtol=GRAD_RTOL,
                atol=GRAD_RTOL * float(np.abs(r).max() + 1e-8))
        runs[policy] = (fwd_mm, bwd_mm)
    # the projections are mm (layers.proj): forward counts agree
    assert runs["none"][0] == runs["full"][0] == runs["dots"][0] > 0
    # "none" saves everything: its backward is the gradients' mm alone;
    # "dots" recomputes no mm on top of that, "full" recomputes them
    assert runs["dots"][1] == runs["none"][1]
    assert runs["full"][1] > runs["none"][1]


def test_dots_saves_each_projection_output_and_replays_it():
    """Under ``dots_saved`` the first call keeps every ``proj`` output
    (and nothing else), and the next call hands each back in order without
    a matmul, differentiating as the matmul would."""
    from repro_torch.models.layers import dots_saved, proj

    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((3, 4, 8)), dtype=torch.float32,
                     requires_grad=True)
    w1 = torch.tensor(rng.standard_normal((8, 5)), dtype=torch.float32,
                      requires_grad=True)
    w2 = torch.tensor(rng.standard_normal((5, 2, 3)), dtype=torch.float32,
                      requires_grad=True)

    def fn(x, w1, w2):
        return torch.tanh(proj(torch.exp(x) * 0.1, w1)).square().sum(), \
            proj(x[..., :5] * 2.0, w2)

    body = dots_saved(fn)
    a, b = body(x, w1, w2)             # the checkpoint's forward
    (store,) = [c.cell_contents for c in body.__closure__
                if isinstance(c.cell_contents, deque)]
    assert [tuple(t.shape) for t in store] == [(12, 5), (12, 6)]
    with CountOps() as c:
        ra, rb = body(x, w1, w2)       # its recompute
    assert c.counts.get(MM, 0) == 0 and len(store) == 0
    want = torch.autograd.grad(a + b.sum(), [x, w1, w2])
    got = torch.autograd.grad(ra + rb.sum(), [x, w1, w2])
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


def test_proj_is_one_mm_and_matches_einsum():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 5, 8, 4)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((8, 4, 6)), dtype=torch.float32)
    from repro_torch.models.layers import proj

    with CountOps() as c:
        y = proj(x, w, 2)
    assert c.counts.get(MM, 0) == 1
    torch.testing.assert_close(y, torch.einsum("bqhk,hkd->bqd", x, w),
                               rtol=1e-5, atol=1e-5)

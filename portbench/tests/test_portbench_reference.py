"""The plain references against the port at toy sizes on the CPU, both in
float32: the encoder-decoder's loss and gradient, the MoE model's logits,
and the served tokens of the paged engine read against the reference."""
import pytest
import torch

from portbench.kinds import serve, train
from portbench.kinds.common import arch_config, dims
from portbench.lib.weights import flatten, make_weights
from portbench.reference import encdec, moe_lm
from portbench.reference.common import Precision
from portbench.tests import tiny


def test_encdec_loss_and_gradient():
    from repro_torch.models import build_model

    cfg = arch_config(tiny.fp32(tiny.seamless()))
    model = build_model(cfg)
    layout, _ = model.abstract_params()
    job = tiny.train_cell()["traffic"]
    batch = train.feed(cfg, job, 5, 0, tiny.CPU)
    batch["frames"] = batch["frames"].float()
    w = make_weights(layout, 5, tiny.CPU)
    leaves = [t.requires_grad_(True) for _, t in flatten(w)]
    loss, _ = model.loss(w, batch)
    g_prog = torch.autograd.grad(loss, leaves)
    ref = encdec.loss_sum(w, batch["frames"], batch["tokens"],
                          batch["labels"], dims(cfg), Precision()) \
        / batch["tokens"].numel()
    g_ref = torch.autograd.grad(ref, leaves)
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    for a, b in zip(g_prog, g_ref):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7


def test_moe_logits():
    from repro_torch.models import build_model

    cfg = arch_config(tiny.fp32(tiny.qwen()))
    model = build_model(cfg)
    layout, _ = model.abstract_params()
    w = make_weights(layout, 9, tiny.CPU)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 37), generator=gen)
    ref = moe_lm.logits(w, toks[0], dims(cfg), Precision())
    for n in (1, 17, 37):
        got, _ = model.prefill(w, toks[:, :n].to(torch.int32))
        assert torch.allclose(got[0, -1], ref[n - 1], atol=1e-4, rtol=1e-4)


def test_served_tokens_are_the_reference_argmax():
    """In float32 the paged engine's greedy tokens are the reference's best,
    so the widest gap is rounding."""
    ctx = tiny.context("serve", 21, seconds=1.0, exact=True)
    cfg, weights, engine = serve.build(ctx)
    from portbench.lib import traffic

    reqs = traffic.make_requests(ctx.workload["traffic"], ctx.seed, 1.0)
    want = {r.rid: engine.serve_cfg.effective_max_tokens(
        r.prompt_len, r.max_new_tokens) for r in reqs}
    win = serve.serve_window(engine, reqs, cfg.vocab_size, 1.0, 30.0)
    sample = serve.check_sample(reqs, win, want, ctx.seed, 40)
    assert sample and sample[0].prompt_len + want[sample[0].rid] == max(
        r.prompt_len + want[r.rid] for r in reqs)
    served = [(traffic.prompt_tokens(r, cfg.vocab_size),
               engine.requests[r.rid].output) for r in sample]
    gaps = serve.served_gaps(weights, served, dims(cfg), tiny.CPU)
    assert gaps is not None and float(gaps.max()) < 1e-3


def test_fp8_rounds_every_product():
    x = torch.linspace(-3, 3, 101)
    r = Precision("fp8").r(x)
    assert not torch.equal(r, x)
    assert float((r - x).abs().max()) <= 3 * 2 ** -4
    assert torch.equal(Precision("fp32").r(x), x)

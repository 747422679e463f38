"""The comparison that decides ``correct`` fails what it must, at toy sizes
on the CPU with each cell's own limits: the control (the reference in
float8 put in the program's place) and each fault a cell can have, planted
under a whole run of the program in float32; a sound run in float32
passes."""
import pytest
import torch

from portbench.kinds import train
from portbench.tests import tiny


def _correct(run):
    return all(c.ok for c in run.checks) and run.failed == 0


def test_sound_runs_pass():
    for cell in ("train", "serve"):
        ctx = tiny.context(cell, 2**31 + 3, seconds=1.0, exact=True)
        run = __import__(f"portbench.kinds.{ctx.workload['kind']}",
                         fromlist=["run"]).run(ctx)
        assert _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


def test_train_control_fails():
    ctx = tiny.context("train", 7)
    prog = train.Program(ctx)
    prog.free()
    ref = train.reference_readings(ctx, prog.layout, prog.dims)
    low = train.reference_readings(ctx, prog.layout, prog.dims,
                                   precision="fp8")
    r = train.readings(ref, low["losses"], low["first_grad"], low["change"],
                       prog.names)
    lim = ctx.workload["limits"]
    assert any(r[k] > lim[k] for k in lim), (r, lim)


def test_serve_control_fails():
    from portbench import calibrate

    ctx = tiny.context("serve", 7)
    got = calibrate.serve_readings(ctx, control=True)
    lim = ctx.workload["limits"]["mean_logit_gap"]
    assert got["control_fp8"]["mean"] > lim, got


def _wrap_step(monkeypatch, broken):
    import repro_torch.train.step as step_mod

    real = step_mod.make_train_step

    def make(*a, **k):
        return broken(real(*a, **k))

    monkeypatch.setattr(step_mod, "make_train_step", make)


def test_state_left_unchanged_fails(monkeypatch):
    from repro_torch.tree import leaves

    def broken(step):
        def call(state, batch):
            keep = [t.detach().clone() for t in leaves(state.params)
                    + leaves(state.opt_state)]
            new, metrics = step(state, batch)
            with torch.no_grad():
                for t, k in zip(leaves(new.params) + leaves(new.opt_state),
                                keep):
                    t.copy_(k)
            return state, metrics
        return call

    _wrap_step(monkeypatch, broken)
    run = train.run(tiny.context("train", 8, seconds=0.5, exact=True))
    assert not _correct(run)
    assert {c.name for c in run.checks if not c.ok} >= {"change_gap"}


def test_half_batch_fails(monkeypatch):
    def broken(step):
        def call(state, batch):
            half = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return call

    _wrap_step(monkeypatch, broken)
    run = train.run(tiny.context("train", 9, seconds=0.5, exact=True))
    assert not _correct(run)


def test_token_altered_fails(monkeypatch):
    import repro_torch.serve.paged as paged

    from portbench.kinds import serve

    real = paged.decode_batch

    def broken(*a, **k):
        logits, pool = real(*a, **k)
        return logits.roll(1, dims=-1), pool

    monkeypatch.setattr(paged, "decode_batch", broken)
    run = serve.run(tiny.context("serve", 10, seconds=1.0, exact=True))
    assert not _correct(run)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_large_seeds_run(seed):
    ctx = tiny.context("serve", seed, seconds=0.5)
    from portbench.kinds import serve

    assert serve.run(ctx).attempted > 0

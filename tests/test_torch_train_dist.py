"""The port's launcher and train steps with strategies, on the CPU.

``launch.train`` with ``--ranks 4 --pp 2 --compression int8`` on the smoke
llama3.2-1b prints the simulated plan, the byte parity of the simulated
graph against the executor and the gradient traffic, and trains with
finite losses; the data-parallel compressed step (no pipeline) runs through
the same launcher; and the one-rank int8 step (error feedback, no mesh)
follows the JAX package's compressed step's loss trajectory within 1e-4
relative (fp32).
"""
import dataclasses
import math
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import init_state as jax_init_state  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.train.step import TrainState, make_train_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(2)


def _run(capsys, *argv):
    launcher.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                   "--steps", "3", "--seq", "32", *argv])
    return capsys.readouterr().out


def _losses(out):
    return [float(x) for x in re.findall(r"loss=([0-9.naif+-]+)", out)]


def test_launcher_pp_dp_int8_prints_plan_parity_comm(capsys):
    out = _run(capsys, "--batch", "8", "--ranks", "4", "--pp", "2",
               "--microbatches", "2", "--compression", "int8",
               "--pp-schedule", "1f1b")
    for tag in ("[pp-plan]", "[pp-exec]", "[pp-parity]", "[comm]",
                "[done]"):
        assert tag in out, out
    assert "simulated step" in out and "parity ok" in out
    assert "dp2xpp2" in out and "ACTIVE: error-feedback psum" in out
    assert re.search(r"executed hops moved (\d+) bytes a pipeline pass "
                     r"\(twin \1\)", out), out
    assert all(math.isfinite(x) for x in _losses(out))


def test_launcher_interleaved_and_sharded_dp(capsys, tmp_path):
    out = _run(capsys, "--batch", "8", "--ranks", "2", "--pp", "2",
               "--vstages", "2", "--microbatches", "4",
               "--pp-schedule", "interleaved_1f1b", "--overlap-buckets", "2")
    assert "parity ok" in out and "dp1xpp2" in out
    out = _run(capsys, "--batch", "8", "--ranks", "4",
               "--compression", "int8", "--overlap-buckets", "3")
    assert "[comm] dp=4" in out and "[pp-plan]" not in out
    losses = _losses(out)
    assert losses and all(math.isfinite(x) for x in losses)
    with pytest.raises(ValueError, match="divisible"):
        _run(capsys, "--batch", "8", "--ranks", "3", "--pp", "2")
    # --ckpt-dir (it raised before the checkpointer was ported): the
    # compressed dp step checkpoints its residuals and a second launch
    # resumes from them
    ck = str(tmp_path / "ck")
    out = _run(capsys, "--batch", "8", "--ranks", "4", "--compression",
               "int8", "--ckpt-dir", ck)
    assert "[ckpt] step 3 written" in out and "[restore]" not in out
    launcher.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                   "--steps", "4", "--seq", "32", "--batch", "8", "--ranks",
                   "4", "--compression", "int8", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 3" in out
    assert "[step     4]" in out and "[step     1]" not in out


def test_one_rank_int8_step_follows_jax_compressed_step():
    jcfg = dataclasses.replace(
        jax_configs.smoke_variant(jax_configs.get_config("llama3.2-1b")),
        num_layers=2)
    tcfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get_config("llama3.2-1b")),
        num_layers=2)
    jmodel = jax_build_model(jcfg)
    jopt, jlr = jax_optim.adamw(), jax_optim.cosine_with_warmup(1e-3, 2, 100)
    jstate, _ = jax_init_state(jmodel, jax.random.PRNGKey(0), jopt,
                               compression="int8", dp=1)
    tmodel = build_model(tcfg)
    topt, tlr = optim.adamw(), optim.cosine_with_warmup(1e-3, 2, 100)
    params = tree_map(lambda p: p.requires_grad_(), load_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu"))
    from repro_torch.dist.compress import init_feedback_state

    tstate = TrainState(torch.zeros((), dtype=torch.int32), params,
                        topt.init(params), init_feedback_state(params, 1))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, jlr,
                                        compression="int8"))
    tstep = make_train_step(tmodel, topt, tlr, compression="int8")
    rng = np.random.default_rng(0)
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (2, 33)).astype(np.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        jstate, jm = jstep(jstate, {k: jax.numpy.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.tensor(v)
                                    for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    res = [np.asarray(r) for r in jax.tree_util.tree_leaves(
        jstate.comp_state)]
    for got, want in zip(leaves(tstate.comp_state), res):
        assert tuple(got.shape) == want.shape
    assert max(float(r.abs().max()) for r in leaves(tstate.comp_state)) > 0

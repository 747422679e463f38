"""The int8-compressed data-parallel steps of the port against the JAX
package's, step by step.

The JAX steps run on real device meshes: a subprocess with four forced CPU
devices runs ``make_pipeline_train_step(compression="int8")`` on a
(data 2 x stage 2) mesh under 1f1b and interleaved 1f1b (vstages 2), and
``make_sharded_train_step(compression="int8")`` on a data mesh of 2.  It
writes its initial parameters, batches, per-step losses and grad norms, and
the final residuals and parameters to an ``.npz``.  The port runs the same
steps from those parameters on logical CPU ranks.  What this holds is how
the steps compose ``compressed_psum``: the rows each stage quantizes (both
chunks of an interleaved stage as one leaf), the tied table's two paths
merged before the int8 reduction, and the residuals written back into the
``(dp, ...)`` state.

Tolerances: the loss and grad norm of every step at 1e-4 relative, and the
parameters after the last step at 1e-4/1e-5 (the single-process trajectory
test's, in tests/test_torch_dense.py).  int8 rounding makes one exception.
A residual element is ``acc - q * scale``, with ``|.| <= scale / 2``.  Where
the two packages' fp32 gradients straddle a rounding boundary of
``acc / scale``, their int8 values differ by one, their residuals by one
``scale``, and the update of that element by up to the step's learning
rate.  So the residuals after the first step agree within 1e-3 of the
leaf's scale, and the parameters at the tolerance above, except at a few
such elements: at most 4 plus 1 in 10,000 of a leaf's residuals, and 4 plus
1 in 1,000 of its parameters after four steps (flips carry over).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.dist.compress import init_feedback_state  # noqa: E402
from repro_torch.dist import mesh as M  # noqa: E402
from repro_torch.models import build_model, load_jax_params  # noqa: E402
from repro_torch.models import pipeline as port_pipe  # noqa: E402
from repro_torch.optim import adamw, cosine_with_warmup  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainState,
    make_pipeline_train_step,
    make_sharded_train_step,
)
from repro_torch.tree import leaves, tree_map, unflatten_like  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = {"num_layers": 4, "d_model": 64, "num_heads": 2, "num_kv_heads": 2,
        "head_dim": 32, "d_ff": 128, "vocab_size": 256}
STEPS, SEQ, BATCH = 4, 16, 8
# name -> (data ranks, pipeline stages, schedule, vstages)
CASES = {
    "pp_1f1b": (2, 2, "1f1b", 1),
    "pp_interleaved": (2, 2, "interleaved_1f1b", 2),
    "dp2": (2, 1, None, 1),
}

_SCRIPT = textwrap.dedent(
    """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import base as C
    from repro.models import build_model
    from repro.models import pipeline as P
    from repro.models.build import make_concrete_batch
    from repro.optim import adamw, cosine_with_warmup
    from repro.train.step import (init_state, make_pipeline_train_step,
                                  make_sharded_train_step)

    out_path, steps, seq, batch, tiny, cases = sys.argv[1:7]
    steps, seq, batch = int(steps), int(seq), int(batch)
    tiny, cases = eval(tiny), eval(cases)
    cfg = dataclasses.replace(
        C.smoke_variant(C.get_config("llama3.2-1b")), **tiny)
    model = build_model(cfg)
    opt = adamw()
    batches = [make_concrete_batch(cfg, C.ShapeConfig("b", seq, batch,
                                                      "train"), seed=i)
               for i in range(steps)]
    out = {}
    for i, b in enumerate(batches):
        for k, x in b.items():
            out[f"batch/{i}/{k}"] = np.asarray(x)
    for name, (dp, pp, sched, v) in cases.items():
        lr = cosine_with_warmup(1e-3, 1, 100)
        if pp > 1:
            mesh = jax.make_mesh((dp, pp), ("data", "stage"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
            plan = P.make_plan(cfg, pp, 2, schedule=sched, vstages=v)
            step = make_pipeline_train_step(model, opt, lr, mesh, plan,
                                            compression="int8")
        else:
            mesh = jax.sharding.Mesh(np.array(jax.devices()[:dp]),
                                     ("data",))
            step = make_sharded_train_step(model, opt, lr, mesh,
                                           compression="int8")
        step = jax.jit(step)
        state, _ = init_state(model, jax.random.PRNGKey(0), opt,
                              compression="int8", dp=dp)
        for j, x in enumerate(jax.tree_util.tree_leaves(state.params)):
            out[f"{name}/init/{j}"] = np.asarray(x)
        loss, gnorm = [], []
        for i, b in enumerate(batches):
            state, m = step(state, b)
            loss.append(float(m["loss"]))
            gnorm.append(float(m["grad_norm"]))
            if i == 0:
                for j, x in enumerate(
                        jax.tree_util.tree_leaves(state.comp_state)):
                    out[f"{name}/res0/{j}"] = np.asarray(x)
        out[f"{name}/loss"] = np.array(loss)
        out[f"{name}/grad_norm"] = np.array(gnorm)
        for j, x in enumerate(jax.tree_util.tree_leaves(state.params)):
            out[f"{name}/params/{j}"] = np.asarray(x)
    np.savez(out_path, **out)
    print("jax_compressed_steps_ok")
    """
)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_comp") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, path, str(STEPS), str(SEQ),
         str(BATCH), repr(TINY), repr(CASES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "jax_compressed_steps_ok" in out.stdout
    with np.load(path) as z:
        return dict(z)


def _port_state(model, ref, name, opt, dp):
    like, _ = model.abstract_params()
    flat = [ref[f"{name}/init/{j}"] for j in range(len(leaves(like)))]
    params = tree_map(lambda t: t.requires_grad_(), load_jax_params(
        unflatten_like(like, flat), device="cpu"))
    return TrainState(torch.zeros((), dtype=torch.int32), params,
                      opt.init(params), init_feedback_state(params, dp))


def _assert_close_but_flips(got, want, atol, rtol, per, tag):
    """``got`` equals ``want`` within ``atol + rtol * |want|`` except at
    most ``4 + size / per`` elements (int8 rounding flips)."""
    off = np.abs(got - want) > atol + rtol * np.abs(want)
    assert off.sum() <= 4 + want.size / per, (tag, int(off.sum()), off.size)


@pytest.mark.parametrize("name", list(CASES))
def test_compressed_step_matches_jax_step_by_step(jax_run, name):
    dp, pp, sched, v = CASES[name]
    cfg = dataclasses.replace(port_configs.smoke_variant(
        port_configs.get_config("llama3.2-1b")), **TINY)
    model = build_model(cfg)
    opt, lr = adamw(), cosine_with_warmup(1e-3, 1, 100)
    if pp > 1:
        mesh = M.make_mesh((dp, pp), ("data", "stage"), device="cpu")
        plan = port_pipe.make_plan(cfg, pp, 2, schedule=sched, vstages=v)
        step = make_pipeline_train_step(model, opt, lr, mesh, plan,
                                        compression="int8")
    else:
        mesh = M.make_mesh((dp,), ("data",), device="cpu")
        step = make_sharded_train_step(model, opt, lr, mesh,
                                       compression="int8")
    state = _port_state(model, jax_run, name, opt, dp)
    loss, gnorm = [], []
    for i in range(STEPS):
        pre = f"batch/{i}/"
        batch = {k[len(pre):]: torch.tensor(x) for k, x in jax_run.items()
                 if k.startswith(pre)}
        state, m = step(state, batch)
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
        if i == 0:
            res0 = [r.clone() for r in leaves(state.comp_state)]
    np.testing.assert_allclose(loss, jax_run[f"{name}/loss"], rtol=1e-4)
    np.testing.assert_allclose(gnorm, jax_run[f"{name}/grad_norm"],
                               rtol=1e-4)
    n = len(leaves(state.params))
    assert len(res0) == n
    for j, (p, r) in enumerate(zip(leaves(state.params), res0)):
        want = jax_run[f"{name}/res0/{j}"]
        assert tuple(r.shape) == want.shape == (dp,) + tuple(p.shape)
        # every data rank carries its own non-zero residual
        assert all(np.abs(want[d]).max() > 0 for d in range(dp)), j
        scale = 2 * float(np.abs(want).max())
        _assert_close_but_flips(r.numpy(), want, 1e-3 * scale, 0.0, 1e4,
                                f"{name} residual {j}")
        _assert_close_but_flips(p.detach().numpy(),
                                jax_run[f"{name}/params/{j}"], 1e-5, 1e-4,
                                1e3, f"{name} param {j}")

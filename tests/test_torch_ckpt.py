"""The port's checkpointer (``repro_torch.ckpt``) against the JAX package's.

Each checkpoint test of ``tests/test_ckpt_data_ft.py`` (and the format-2
cases of ``tests/test_train_compressed.py``) runs on the port.  Across the
packages, on the smoke llama3.2-1b ``TrainState`` (2 layers) with AdamW,
with Adafactor and with int8 error-feedback residuals: the port's tree
flattens to the reference's leaf keys in the reference's order, a
checkpoint written by the JAX package restores into the port leaf for leaf,
a port checkpoint restores into the JAX package, and both packages write
the same files byte for byte (manifest included), bf16 leaves too.  The
JAX package cannot restore a bf16 leaf (ROADMAP.md, C16); the port
restores its own and the JAX package's.  On the CPU, training 2 steps,
restoring and training 2 more equals 4 uninterrupted steps exactly.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.ckpt import restore as jax_restore  # noqa: E402
from repro.ckpt import save as jax_save  # noqa: E402
from repro.ckpt.checkpoint import _path_key  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train.step import init_state as jax_init_state  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    CKPT_FORMAT,
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.step import TrainState, init_state  # noqa: E402
from repro_torch.tree import flatten_with_path, map_with_path  # noqa: E402

torch.set_num_threads(2)

ARCH = "llama3.2-1b"
# (optimizer, compression, data ranks of the residuals)
STATES = {"adamw": ("adamw", None, 1), "adafactor": ("adafactor", None, 1),
          "int8": ("adamw", "int8", 2)}


def tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
    }


def _configs(optimizer="adamw", **kw):
    j, t = (dataclasses.replace(c.smoke_variant(c.get_config(ARCH)),
                                num_layers=2, optimizer=optimizer, **kw)
            for c in (jax_configs, port_configs))
    return j, t


def _jax_state(jcfg, compression=None, dp=1, seed=0):
    """A JAX ``TrainState`` (numpy leaves) with every leaf filled from
    ``seed``: moments and residuals are not zeros."""
    state, _ = jax_init_state(jax_build_model(jcfg), jax.random.PRNGKey(0),
                              jax_optim.make_optimizer(jcfg.optimizer),
                              compression=compression, dp=dp)
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return np.full(x.shape, 7, x.dtype)
        return rng.standard_normal(x.shape).astype(x.dtype)

    return jax.tree_util.tree_map(fill, state)


def _port_like(tcfg, compression=None, dp=1):
    return init_state(build_model(tcfg), torch.Generator().manual_seed(1),
                      optim.make_optimizer(tcfg.optimizer),
                      compression=compression, dp=dp)


def _jax_flat(tree) -> dict:
    return {"/".join(_path_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_same(port_tree, jax_tree):
    """Leaf keys (in order), shapes and values equal."""
    jflat = _jax_flat(jax_tree)
    tflat = flatten_with_path(port_tree)
    assert ["/".join(p) for p, _ in tflat] == list(jflat)
    for path, t in tflat:
        j = jflat["/".join(path)]
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_array_equal(_np(t), _jnp(j), err_msg=str(path))


def _port_from_jax(jstate, like):
    """The JAX state's values in the port's tree (same keys)."""
    jflat = _jax_flat(jstate)

    def leaf(path, t):
        a = jflat["/".join(path)]
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return map_with_path(leaf, like)


# -- the reference's checkpoint tests, on the port ------------------------------


def test_ckpt_roundtrip(tmp_path):
    t = tree()
    save(t, str(tmp_path), step=5)
    out = restore(t, str(tmp_path))
    assert out is not None
    restored, step = out
    assert step == 5
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["b"]["c"], t["b"]["c"])


def test_ckpt_gc_keeps_last_k(tmp_path):
    t = tree()
    for s in range(6):
        save(t, str(tmp_path), step=s, keep=3)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step"))
    assert steps == [3, 4, 5]


def test_ckpt_corruption_falls_back(tmp_path):
    t = tree()
    save(t, str(tmp_path), step=1)
    save(t, str(tmp_path), step=2)
    bad = os.path.join(tmp_path, "step_00000002", "manifest.json")
    with open(bad, "w") as f:
        f.write("{not json")
    logs = []
    restored, step = restore(t, str(tmp_path), log_fn=logs.append)
    assert step == 1
    # the skip is logged with its step and reason, never silent
    assert len(logs) == 1 and "skipped step 2" in logs[0]
    assert "JSONDecodeError" in logs[0]


def test_ckpt_incomplete_manifest_skipped(tmp_path):
    t = tree()
    save(t, str(tmp_path), step=1)
    save(t, str(tmp_path), step=3)
    m = os.path.join(tmp_path, "step_00000003", "manifest.json")
    data = json.load(open(m))
    data["complete"] = False
    json.dump(data, open(m, "w"))
    logs = []
    restored, step = restore(t, str(tmp_path), log_fn=logs.append)
    assert step == 1
    assert logs == [f"[restore] skipped step 3 in {tmp_path}: ValueError: "
                    "incomplete manifest"]


def test_async_checkpointer(tmp_path):
    t = tree()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(t, 7)
    ck.wait()
    assert latest_step(str(tmp_path)) == 7
    assert ck.last["step"] == 7 and ck.last["bytes"] == 6 * 4 + 3 * 4
    assert ck.last["snapshot_s"] >= 0 and ck.last["write_s"] >= 0


def test_ckpt_full_train_state_roundtrip(tmp_path):
    """NamedTuple fields produce named leaf files, and a full TrainState
    roundtrips exactly."""
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    opt = optim.adamw()
    state = TrainState(torch.tensor(11, dtype=torch.int32), params,
                       opt.init(params), None)
    path = save(state, str(tmp_path), step=11)
    files = os.listdir(path)
    assert not any(f.startswith(".") for f in files), files
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert "step" in manifest["leaves"]
    assert any(k.startswith("params/") for k in manifest["leaves"])
    restored, at = restore(state, str(tmp_path))
    assert at == 11 and int(restored.step) == 11
    assert isinstance(restored, TrainState)
    for (pa, a), (pb, b) in zip(flatten_with_path(state),
                                flatten_with_path(restored)):
        assert pa == pb and torch.equal(a, b)


def test_ckpt_shape_mismatch_rejected(tmp_path):
    t = tree()
    save(t, str(tmp_path), step=1)
    other = {"a": torch.zeros((3, 3)),
             "b": {"c": torch.zeros((3,), dtype=torch.int32)}}
    logs = []
    assert restore(other, str(tmp_path), log_fn=logs.append) is None
    assert "checkpoint shape (2, 3) != expected (3, 3)" in logs[0]


def test_v2_checkpoint_roundtrips_residuals(tmp_path):
    _, tcfg = _configs()
    state = _port_from_jax(_jax_state(_configs()[0], "int8", 2),
                           _port_like(tcfg, "int8", 2))
    save(state, str(tmp_path), step=2)
    man = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    assert man["format"] == CKPT_FORMAT
    assert any(k.startswith("comp_state/") for k in man["leaves"])
    restored, at = restore(_port_like(tcfg, "int8", 2), str(tmp_path))
    assert at == 2
    for (_, a), (_, b) in zip(flatten_with_path(state.comp_state),
                              flatten_with_path(restored.comp_state)):
        assert torch.equal(a, b) and bool(a.any())


def test_v1_checkpoint_restores_into_v2_schema(tmp_path):
    """A v1 checkpoint (dotted attribute keys, no format field, no
    comp_state) restores into the v2 TrainState with zero residuals."""
    _, tcfg = _configs()
    dense = _port_like(tcfg)
    save(dense, str(tmp_path), step=9)
    cdir = tmp_path / "step_00000009"
    man = json.load(open(cdir / "manifest.json"))
    del man["format"]
    v1 = {}
    for key, fname in man["leaves"].items():
        segs = key.split("/")
        segs[0] = "." + segs[0]
        old = "/".join(segs)
        os.rename(cdir / fname, cdir / (old.replace("/", "__") + ".npy"))
        v1[old] = old.replace("/", "__") + ".npy"
    man["leaves"] = v1
    json.dump(man, open(cdir / "manifest.json", "w"))
    like = init_state(build_model(tcfg), torch.Generator().manual_seed(5),
                      optim.adamw(), compression="int8", dp=2)
    restored, at = restore(like, str(tmp_path))
    assert at == 9
    for (_, a), (_, b) in zip(flatten_with_path(dense.params),
                              flatten_with_path(restored.params)):
        assert torch.equal(a, b)
    for _, leaf in flatten_with_path(restored.comp_state):
        assert leaf.shape[0] == 2 and not bool(leaf.any())


def test_v2_dense_checkpoint_restores_into_compressed_schema(tmp_path):
    _, tcfg = _configs()
    dense = _port_like(tcfg)
    save(dense, str(tmp_path), step=3)
    restored, at = restore(_port_like(tcfg, "int8", 1), str(tmp_path))
    assert at == 3
    for (_, a), (_, b) in zip(flatten_with_path(dense.params),
                              flatten_with_path(restored.params)):
        assert torch.equal(a, b)
    for _, leaf in flatten_with_path(restored.comp_state):
        assert not bool(leaf.any())


# -- the port's own guarantees -----------------------------------------------------


def test_snapshot_is_a_completed_host_copy(tmp_path):
    """The train step updates its tensors in place: a save must hold the
    values at the call, whatever happens to the tensors afterwards."""
    t = tree()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(t, 1)
    t["a"].add_(100.0)
    t["b"]["c"].mul_(0)
    ck.wait()
    restored, _ = restore(tree(), str(tmp_path))
    assert torch.equal(restored["a"], tree()["a"])
    assert torch.equal(restored["b"]["c"], tree()["b"]["c"])


def test_restore_takes_the_like_leaves_device_dtype_and_grad(tmp_path):
    save({"w": torch.linspace(-2, 2, 12).reshape(3, 4),
          "n": torch.tensor(3, dtype=torch.int32)}, str(tmp_path), step=1)
    like = {"w": torch.zeros((3, 4), dtype=torch.bfloat16).requires_grad_(),
            "n": torch.zeros((), dtype=torch.int64)}
    restored, _ = restore(like, str(tmp_path))
    assert restored["w"].dtype == torch.bfloat16
    assert restored["w"].requires_grad and restored["w"].is_leaf
    assert torch.equal(restored["w"], torch.linspace(-2, 2, 12).reshape(
        3, 4).to(torch.bfloat16))
    assert restored["n"].dtype == torch.int64 and int(restored["n"]) == 3


def test_async_writer_error_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ck = AsyncCheckpointer(str(blocker / "ck"))
    ck.save(tree(), 1)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()   # raised once


# -- across the packages -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(STATES))
def test_train_state_flattens_to_the_reference_keys(name):
    opt, comp, dp = STATES[name]
    jcfg, tcfg = _configs(opt)
    jkeys = list(_jax_flat(_jax_state(jcfg, comp, dp)))
    tkeys = ["/".join(p) for p, _ in
             flatten_with_path(_port_like(tcfg, comp, dp))]
    assert tkeys == jkeys


@pytest.mark.parametrize("name", sorted(STATES))
def test_jax_checkpoint_restores_into_port(tmp_path, name):
    opt, comp, dp = STATES[name]
    jcfg, tcfg = _configs(opt)
    jstate = _jax_state(jcfg, comp, dp)
    jax_save(jstate, str(tmp_path), step=4)
    restored, at = restore(_port_like(tcfg, comp, dp), str(tmp_path))
    assert at == 4 and isinstance(restored, TrainState)
    _assert_same(restored, jstate)
    assert all(t.requires_grad for _, t in flatten_with_path(restored.params))


@pytest.mark.parametrize("name", sorted(STATES))
def test_port_checkpoint_restores_into_jax(tmp_path, name):
    opt, comp, dp = STATES[name]
    jcfg, tcfg = _configs(opt)
    like = _jax_state(jcfg, comp, dp, seed=1)
    state = _port_from_jax(_jax_state(jcfg, comp, dp, seed=0),
                           _port_like(tcfg, comp, dp))
    save(state, str(tmp_path), step=6)
    out = jax_restore(like, str(tmp_path))
    assert out is not None
    restored, at = out
    assert at == 6
    _assert_same(state, restored)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_both_packages_write_the_same_files(tmp_path, param_dtype):
    jcfg, tcfg = _configs(param_dtype=param_dtype)
    jstate = _jax_state(jcfg, "int8", 2)
    state = _port_from_jax(jstate, _port_like(tcfg, "int8", 2))
    jpath = jax_save(jstate, str(tmp_path / "jax"), step=2)
    tpath = save(state, str(tmp_path / "port"), step=2)
    files = sorted(os.listdir(jpath))
    assert sorted(os.listdir(tpath)) == files
    for f in files:
        with open(os.path.join(jpath, f), "rb") as a, \
                open(os.path.join(tpath, f), "rb") as b:
            assert a.read() == b.read(), f
    if param_dtype == "bfloat16":
        head = open(os.path.join(tpath, "params__embed.npy"), "rb").read(64)
        assert b"'descr': '<V2'" in head


def test_bf16_leaf_round_trips_and_jax_bf16_restores_in_port(tmp_path):
    """C16: the JAX package restores no bf16 leaf (its ``astype`` has no
    cast from the void type numpy reads back, and ``restore`` skips the
    step); the port restores both packages' bf16 leaves."""
    jcfg, tcfg = _configs(param_dtype="bfloat16")
    jstate = _jax_state(jcfg)
    jax_save(jstate, str(tmp_path / "jax"), step=1)
    assert jax_restore(jstate, str(tmp_path / "jax")) is None   # C16
    like = _port_like(tcfg)
    assert flatten_with_path(like.params)[0][1].dtype == torch.bfloat16
    restored, _ = restore(like, str(tmp_path / "jax"))
    _assert_same(restored, jstate)
    save(restored, str(tmp_path / "port"), step=1)
    again, _ = restore(_port_like(tcfg), str(tmp_path / "port"))
    for (_, a), (_, b) in zip(flatten_with_path(restored),
                              flatten_with_path(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("extra", [(), ("--ranks", "2", "--compression",
                                        "int8")], ids=["dense", "int8_dp2"])
def test_resume_equals_uninterrupted_run(tmp_path, extra):
    """2 steps, a checkpoint, a restore and 2 more steps: the losses and
    the final state equal 4 uninterrupted steps bit for bit."""
    tcfg = _configs()[1]
    kw = dict(seq=32, batch=4, device="cpu", log_fn=lambda _: None)
    if extra:
        kw.update(ranks=2, compression="int8")
    ck = str(tmp_path / "ck")
    _, first = launcher.train(tcfg, steps=2, ckpt_dir=ck, **kw)
    resumed, second = launcher.train(tcfg, steps=4, ckpt_dir=ck, **kw)
    whole, losses = launcher.train(tcfg, steps=4, **kw)
    assert first + second == losses and len(second) == 2
    pairs = list(zip(flatten_with_path(resumed), flatten_with_path(whole)))
    assert len(pairs) == len(flatten_with_path(whole))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and torch.equal(a, b), pa
    assert int(resumed.step) == 4
    assert sorted(os.listdir(ck)) == ["hb", "step_00000002", "step_00000004"]


def test_launcher_saves_every_ckpt_every_steps_and_no_restore_starts_over(
        tmp_path):
    """``ckpt_every`` saves inside the run (the last 3 kept, the end's
    included), ``restore_from=False`` (``--no-restore``) trains from step
    0 over a directory of checkpoints, and the heartbeat names the last
    step."""
    tcfg = _configs()[1]
    kw = dict(seq=32, batch=4, device="cpu", log_fn=lambda _: None)
    ck = str(tmp_path / "ck")
    events = []
    _, losses = launcher.train(tcfg, steps=5, ckpt_dir=ck, ckpt_every=2,
                               on_ckpt=events.append, **kw)
    assert sorted(os.listdir(ck)) == ["hb", "step_00000002", "step_00000004",
                                      "step_00000005"]
    assert [e["event"] for e in events] == ["save"]
    assert events[0]["step"] == 5 and events[0]["write_s"] >= 0
    assert json.load(open(os.path.join(ck, "hb", "host_0.hb")))["step"] == 4
    _, again = launcher.train(tcfg, steps=5, ckpt_dir=ck, restore_from=False,
                              **kw)
    assert again == losses

"""The port's fault tolerance (``repro_torch.ft``) and the parameters'
logical axes of every family, against the JAX package's.

The heartbeat monitor, the step-time monitor and straggler policy, and
``plan_remesh`` are copies: over a grid of clocks, step times, policies and
meshes every answer equals the reference's, and ``predicted_impact`` on
the port's autotuner equals it on the reference's.  ``apply_remesh``
places each leaf on a mesh of logical ranks: for the smoke llama, mamba2,
jamba and seamless parameters every rank's piece equals the shard
``jax.device_put`` gives the device at the same mesh coordinate (a
subprocess with 4 forced CPU devices, as ``tests/test_torch_serve_shard.py``
runs the JAX engine).  ``Model.param_axes()`` of the ssm, hybrid and audio
families equals the axes tree the JAX ``init_params`` returns, at the smoke
and the published shapes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import ft as jax_ft  # noqa: E402
from repro.configs import base as jax_configs  # noqa: E402
from repro.core import autotuner as jax_tuner  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import ft  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import autotuner as port_tuner  # noqa: E402
from repro_torch.core import hardware as port_hw  # noqa: E402
from repro_torch.dist.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.sharding import make_ctx  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# the families whose axes are new to the port, and one of the others
NEW_AXES = ("mamba2-2.7b", "jamba-1.5-large-398b", "seamless-m4t-large-v2")
REMESH_ARCHS = ("llama3.2-1b",) + NEW_AXES
REMESH_MESHES = ((2, 2), (4, 1))


def _smoke(configs, arch):
    cfg = configs.smoke_variant(configs.get_config(arch))
    if cfg.family == "hybrid":     # one whole period
        return cfg
    return dataclasses.replace(cfg, num_layers=2)


# -- heartbeat -------------------------------------------------------------------


def test_heartbeat_detects_dead(tmp_path):
    clock = {"t": 1000.0}
    hb = ft.HeartbeatMonitor(str(tmp_path), num_hosts=3, timeout_s=30,
                             clock=lambda: clock["t"])
    for h in range(3):
        hb.beat(h, step=1)
    assert hb.dead_hosts() == []
    clock["t"] += 60
    hb.beat(1, step=2)
    assert hb.dead_hosts() == [0, 2]
    assert not hb.quorum()
    assert hb.last_seen(1) == {"host": 1, "step": 2, "t": 1060.0}


@pytest.mark.parametrize("timeout", [5.0, 30.0, 120.0])
def test_heartbeat_equals_reference_over_a_grid(tmp_path, timeout):
    rng = np.random.default_rng(int(timeout))
    clock = {"t": 0.0}
    mons = [pkg.HeartbeatMonitor(str(tmp_path / name), num_hosts=5,
                                 timeout_s=timeout, clock=lambda: clock["t"])
            for pkg, name in ((jax_ft, "jax"), (ft, "port"))]
    for step in range(40):
        clock["t"] += float(rng.exponential(10.0))
        for h in range(5):
            if rng.random() < 0.6:
                for m in mons:
                    m.beat(h, step)
        got = [(m.dead_hosts(), m.quorum(),
                [m.last_seen(h) for h in range(5)]) for m in mons]
        assert got[1] == got[0]


# -- step-time monitor and straggler policy ----------------------------------------


def test_straggler_policy_escalates():
    mon = ft.StepTimeMonitor(window=8)
    pol = ft.StragglerPolicy(slow_factor=1.5, evict_after=2)
    for _step in range(4):
        for h in range(4):
            mon.record(h, 1.0 if h != 2 else 3.0)
        verdict = pol.assess(mon)
    assert verdict[2] == "evict"
    assert verdict[0] == "ok"


@pytest.mark.parametrize("slow_factor,evict_after,window",
                         [(1.5, 3, 32), (1.2, 1, 4), (2.0, 2, 8)])
def test_straggler_verdicts_equal_reference(slow_factor, evict_after, window):
    rng = np.random.default_rng(window)
    pair = [(pkg.StepTimeMonitor(window=window),
             pkg.StragglerPolicy(slow_factor=slow_factor,
                                 evict_after=evict_after))
            for pkg in (jax_ft, ft)]
    slow = {h: rng.random() < 0.3 for h in range(6)}
    for step in range(50):
        if step % 10 == 0:      # stragglers come and go
            slow = {h: rng.random() < 0.3 for h in range(6)}
        times = {h: float(rng.lognormal(0.0, 0.1)) * (2.5 if slow[h]
                                                      else 1.0)
                 for h in range(6)}
        got = []
        for mon, pol in pair:
            for h, t in times.items():
                mon.record(h, t)
            got.append((pol.assess(mon), mon.fleet_median(),
                        [mon.smoothed(h) for h in range(7)]))
        assert got[1] == got[0]


def test_predicted_impact_on_the_port_autotuner_equals_reference():
    jt = jax_tuner.Autotuner(jax_configs.get_config("llama3.2-1b"), chips=4,
                             global_batch=32, seq=512,
                             platform=jax_hw.TPU_V5E)
    tt = port_tuner.Autotuner(port_configs.get_config("llama3.2-1b"),
                              chips=4, global_batch=32, seq=512,
                              platform=port_hw.TPU_V5E)
    for stage, factor in ((0, 2.0), (1, 1.5)):
        j = jax_ft.StragglerPolicy().predicted_impact(jt, stage, factor)
        t = ft.StragglerPolicy().predicted_impact(tt, stage, factor)
        assert t == pytest.approx(j, rel=1e-12) and t >= 1.0
        assert tt.straggler_stage is None and tt.straggler_factor == 1.0


# -- plan_remesh ---------------------------------------------------------------------


def test_plan_remesh_shrinks_data_axis():
    plan = ft.plan_remesh((2, 16, 16), ("pod", "data", "model"),
                          available_chips=16 * 16, global_batch=256)
    assert plan.new_shape[-1] == 16
    assert plan.new_chips <= 256
    assert plan.batch_divisible


def test_plan_remesh_too_small_raises():
    with pytest.raises(ValueError):
        ft.plan_remesh((2, 16, 16), ("pod", "data", "model"),
                       available_chips=8, global_batch=256)


@pytest.mark.parametrize("shape,names", [
    ((2, 16, 16), ("pod", "data", "model")),
    ((16, 16), ("data", "model")),
    ((8, 1), ("data", "model")),
    ((2, 4, 2), ("pod", "data", "model")),
    ((4, 2), ("data", "model")),
])
def test_plan_remesh_equals_reference_over_a_grid(shape, names):
    for chips in (1, 2, 3, 7, 8, 15, 16, 31, 64, 255, 509, 512):
        for batch in (7, 96, 256):
            def run(pkg):
                try:
                    return dataclasses.asdict(
                        pkg.plan_remesh(shape, names, chips, batch))
                except ValueError as e:
                    return ("ValueError", str(e))

            assert run(ft) == run(jax_ft), (chips, batch)


# -- the new families' logical axes ----------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", NEW_AXES)
def test_param_axes_equal_jax_init_axes(arch, smoke):
    def cfg(configs):
        c = configs.get_config(arch)
        return configs.smoke_variant(c) if smoke else c

    _, jaxes = jax_build_model(cfg(jax_configs)).abstract_params()
    model = build_model(cfg(port_configs))
    shapes, taxes = model.abstract_params()
    assert model.param_axes() == jaxes and taxes == jaxes
    # one logical axis per dimension of every leaf, in the same tree
    axes_by_path = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            axes_by_path[path] = t

    walk(taxes, ())
    for path, leaf in flatten_with_path(shapes):
        assert len(axes_by_path[path]) == len(leaf.shape), path


# -- apply_remesh against jax.device_put -------------------------------------------

_REMESH_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, sys
    import jax, numpy as np
    from repro.compat import make_mesh
    from repro.configs import base as C
    from repro.ft import apply_remesh
    from repro.models import build_model
    from repro.models.sharding import make_ctx

    out_path, archs, meshes = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
    out = {}
    for arch in archs:
        cfg = C.smoke_variant(C.get_config(arch))
        if cfg.family != "hybrid":
            cfg = dataclasses.replace(cfg, num_layers=2)
        params, axes = build_model(cfg).init(jax.random.PRNGKey(0))
        for shape in meshes:
            mesh = make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
            ctx = make_ctx(mesh, overrides=cfg.sharding_overrides)
            placed = apply_remesh(params, axes, ctx)
            coord = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
                     for d in mesh.devices.flat}
            for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
                key = "/".join(str(k.key) for k in path)
                out[f"{arch}|{shape}|{key}"] = sorted(
                    (coord[s.device.id],
                     [[sl.start or 0, n if sl.stop is None else sl.stop]
                      for sl, n in zip(s.index, arr.shape)])
                    for s in arr.addressable_shards)
    json.dump(out, open(out_path, "w"))
    """
)


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("remesh") / "shards.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    out = subprocess.run(
        [sys.executable, "-c", _REMESH_SCRIPT, path, repr(REMESH_ARCHS),
         repr(REMESH_MESHES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.load(open(path))


@pytest.mark.parametrize("shape", REMESH_MESHES)
@pytest.mark.parametrize("arch", REMESH_ARCHS)
def test_apply_remesh_pieces_equal_jax_device_put_shards(jax_shards, arch,
                                                         shape):
    cfg = _smoke(port_configs, arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    placed = ft.apply_remesh(params, model.param_axes(),
                             make_ctx(mesh, overrides=cfg.sharding_overrides))
    # each placed leaf is {coord: piece}, so it flattens one level deeper
    pieces: dict = {}
    for p, t in flatten_with_path(placed):
        pieces.setdefault(p[:-1], {})[p[-1]] = t
    n = 0
    for path, x in flatten_with_path(params):
        want = jax_shards[f"{arch}|{shape}|{'/'.join(path)}"]
        got = pieces[path]
        assert len(got) == len(want) == mesh.n_ranks
        for coord, idx in want:
            piece = got[str(tuple(coord))]
            sl = tuple(slice(a, b) for a, b in idx)
            assert torch.equal(piece, x[sl]), (path, coord)
            n += 1
    assert n == mesh.n_ranks * len(flatten_with_path(params))

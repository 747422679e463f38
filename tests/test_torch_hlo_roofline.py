"""The port's copies of ``core/hlo_parser.py`` and ``core/roofline.py``
against the JAX package's.

JAX lowers and compiles the HLO text: single-device programs in this
process (a scan, a nested scan, a dot, an elementwise reduction, the smoke
llama3.2-1b train step), and the collectives (all-reduce, all-gather,
collective-permute, all-to-all under ``shard_map`` on a (data 2 x model 4)
mesh) in one subprocess with 8 forced CPU devices, which writes the text to
a temporary directory.  On the same text both packages' ``parse_module``,
``to_graph`` (node for node: kind, flops, bytes, collective fields, edges),
``trip_count``, ``decode_replica_groups`` and ``module_summary`` are equal;
on the same summaries so are ``model_flops``, ``build_report`` and
``to_row`` for every config and every shape, at TPU v5e and the H100 SXM.
That pins ROADMAP C17 in the copy: the fraction divides by the v5e peak
whatever the platform.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.core import hlo_parser as jax_hlo  # noqa: E402
from repro.core import roofline as jax_roofline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_concrete_batch  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import abstract_state as jax_abstract_state  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import hardware as port_hw  # noqa: E402
from repro_torch.core import hlo_parser as port_hlo  # noqa: E402
from repro_torch.core import roofline as port_roofline  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (data 2 x model 4): a mesh whose "data" axis is priced as DCN below
MESH = ((2, 4), ("data", "model"))
COLLECTIVES = ("all_reduce", "all_gather", "collective_permute",
               "all_to_all")

_COLLECTIVE_SCRIPT = r"""
import os, sys
import repro  # noqa: F401  (the JAX package's compat shims)
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P

out, shape, names = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
mesh = jax.make_mesh(shape, names,
                     axis_types=(jax.sharding.AxisType.Auto,) * len(names))
x = jax.ShapeDtypeStruct((8, 64, 32), jnp.float32)
spec = P("data", "model")


def sm(f, out_specs=spec):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,),
                                 out_specs=out_specs, check_vma=False))


progs = {
    "all_reduce": sm(lambda a: jax.lax.psum(jnp.tanh(a), "model")),
    "all_gather": sm(lambda a: jax.lax.all_gather(a, "data", axis=0,
                                                  tiled=True),
                     out_specs=P(None, "model")),
    "collective_permute": sm(lambda a: jax.lax.ppermute(
        a, "model", [(i, (i + 1) % 4) for i in range(4)])),
    "all_to_all": sm(lambda a: jax.lax.all_to_all(a, "model", 2, 2,
                                                  tiled=True)),
}
for name, f in progs.items():
    with open(os.path.join(out, name + ".hlo"), "w") as fh:
        fh.write(f.lower(x).compile().as_text())
print("hlo_collectives_ok")
"""


def _compiled(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax.jit(f).lower(*args).compile().as_text()


def _scan(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None

    return jax.lax.scan(body, x, None, length=6)[0]


def _nested_scan(x, w):
    def outer(c, _):
        def inner(c2, _):
            return c2 @ w, None

        return jax.lax.scan(inner, c, None, length=3)[0], None

    return jax.lax.scan(outer, x, None, length=4)[0]


def _smoke_train_step_text():
    cfg = dataclasses.replace(
        jax_configs.smoke_variant(jax_configs.get_config("llama3.2-1b")),
        num_layers=2)
    model, opt = jax_build_model(cfg), jax_adamw()
    step = jax_make_train_step(model, opt, jax_cosine(1e-3, 10, 1000))
    state, _ = jax_abstract_state(model, opt)
    data = make_concrete_batch(cfg, jax_configs.ShapeConfig("t", 32, 2,
                                                            "train"))
    return jax.jit(step).lower(state, data).compile().as_text()


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    """name -> compiled HLO text."""
    out = {
        "scan": _compiled(_scan, (128, 128), (128, 128)),
        "nested_scan": _compiled(_nested_scan, (32, 32), (32, 32)),
        "dot": _compiled(lambda a, b: a @ b, (64, 256), (256, 32)),
        "reduce": _compiled(lambda x: jnp.sum(jnp.tanh(x) * x), (1024,)),
        "llama_train_step": _smoke_train_step_text(),
    }
    d = tmp_path_factory.mktemp("hlo")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        [sys.executable, "-c", _COLLECTIVE_SCRIPT, str(d), repr(MESH[0]),
         repr(MESH[1])], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "hlo_collectives_ok" in run.stdout
    for name in COLLECTIVES:
        out[name] = (d / f"{name}.hlo").read_text()
    return out


def _meshes(pkg):
    return (None, pkg.MeshInfo(MESH[1], MESH[0], dcn_axes=("data",)))


def _nodes(g):
    return [dataclasses.asdict(n) for n in g.nodes]


PROGRAMS = ("scan", "nested_scan", "dot", "reduce", "llama_train_step") \
    + COLLECTIVES


@pytest.mark.parametrize("name", PROGRAMS)
def test_parse_and_graph_equal_jax(texts, name):
    """``parse_module`` gives the same module (every computation and
    instruction), ``to_graph`` the same graph node for node, with and
    without a mesh, and ``trip_count`` the same count for every loop."""
    text = texts[name]
    jm, tm = jax_hlo.parse_module(text), port_hlo.parse_module(text)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for jmesh, tmesh in zip(_meshes(jax_hlo), _meshes(port_hlo)):
        jg, tg = jax_hlo.to_graph(jm, jmesh), port_hlo.to_graph(tm, tmesh)
        assert tg.name == jg.name
        assert len(tg) == len(jg) > 0
        assert _nodes(tg) == _nodes(jg)
        assert tg.total_flops() == jg.total_flops()
        assert tg.total_bytes() == jg.total_bytes()
        assert tg.successors() == jg.successors()
    loops = [ins.attrs["condition"].lstrip("%")
             for comp in tm.computations.values() for ins in comp.instrs
             if ins.opcode == "while"]
    for cond in loops:
        assert port_hlo.trip_count(tm, cond) == jax_hlo.trip_count(jm, cond)
    trips = sorted(port_hlo.trip_count(tm, c) for c in loops)
    if name == "scan":
        assert trips == [6]
    if name == "nested_scan":
        assert trips == [3, 4]


@pytest.mark.parametrize("name", PROGRAMS)
def test_module_summary_equals_jax(texts, name):
    """Every key of ``module_summary`` equal, the graph node for node."""
    for jmesh, tmesh in zip(_meshes(jax_hlo), _meshes(port_hlo)):
        js = jax_hlo.module_summary(texts[name], jmesh)
        ts = port_hlo.module_summary(texts[name], tmesh)
        assert sorted(ts) == sorted(js)
        for key in ts:
            if key == "graph":
                assert _nodes(ts[key]) == _nodes(js[key])
            else:
                assert ts[key] == js[key], key
        if name in COLLECTIVES:
            kind = name.replace("_", "-")
            assert ts["collectives"][kind]["count"] >= 1
            if tmesh is not None:
                # all-gather varies "data", which the mesh puts on DCN
                link = "dcn" if name == "all_gather" else "ici"
                assert ts[f"collective_bytes_{link}"] > 0


# the golden strings of tests/test_hlo_parser.py, and the collectives'
# explicit groups as XLA wrote them on the (2, 4) mesh
REPLICA_GROUPS = (
    ("[2,4]<=[8]", None),
    ("[256,2]<=[2,16,16]T(1,2,0)", ("pod", "data", "model"), (2, 16, 16)),
    ("[32,16]<=[512]", ("pod", "data", "model"), (2, 16, 16)),
    ("[8,64]<=[2,16,16]T(0,2,1)", ("pod", "data", "model"), (2, 16, 16)),
    ("{{0,1,2,3},{4,5,6,7}}", MESH[1], MESH[0]),
    ("{{0,4},{1,5},{2,6},{3,7}}", MESH[1], MESH[0]),
    ("{{0,1,2,3,4,5,6,7}}", MESH[1], MESH[0]),
    ("{}", MESH[1], MESH[0]),
)


@pytest.mark.parametrize("case", REPLICA_GROUPS, ids=lambda c: c[0])
def test_decode_replica_groups_equal_jax(case):
    rg = case[0]
    if case[1] is None:
        jmesh = tmesh = None
    else:
        dcn = ("pod",) if "pod" in case[1] else ("data",)
        jmesh = jax_hlo.MeshInfo(case[1], case[2], dcn_axes=dcn)
        tmesh = port_hlo.MeshInfo(case[1], case[2], dcn_axes=dcn)
    got = port_hlo.decode_replica_groups(rg, tmesh)
    assert got == jax_hlo.decode_replica_groups(rg, jmesh)
    if rg == "[2,4]<=[8]":
        assert got[0] == 4
    if rg == "[256,2]<=[2,16,16]T(1,2,0)":
        assert got == (2, "dcn")
    if rg == "[32,16]<=[512]":
        assert got == (16, "ici")


def _jax_platform(p):
    """The JAX package's PlatformSpec with the port's constants (the JAX
    package has no H100 spec)."""
    return jax_hw.PlatformSpec(
        name=p.name, chip=jax_hw.ChipSpec(**dataclasses.asdict(p.chip)),
        ici=jax_hw.LinkSpec(**dataclasses.asdict(p.ici)),
        dcn=jax_hw.LinkSpec(**dataclasses.asdict(p.dcn)))


def _summaries(texts):
    """The summaries the reports are built on: the train step, every
    collective on the mesh, and one with a folded loop and DCN bytes."""
    mesh = port_hlo.MeshInfo(MESH[1], MESH[0], dcn_axes=("data",))
    out = [port_hlo.module_summary(texts["llama_train_step"])]
    out += [port_hlo.module_summary(texts[n], mesh) for n in COLLECTIVES]
    out.append({"flops": 3.5e15, "bytes": 2.25e12,
                "collective_bytes_ici": 4.0e9, "collective_bytes_dcn": 1.5e9,
                "collectives": {
                    "folded": {"count": 2, "bytes": 3.0e9, "max_group": 16},
                    "all-gather": {"count": 1, "bytes": 2.5e9,
                                   "max_group": 1}}})
    return out


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_roofline_reports_equal_jax(texts, arch):
    """``model_flops``, ``build_report`` and ``to_row`` equal for every
    shape at TPU v5e and the H100 SXM, on the same summaries; the fraction
    divides by the v5e peak on both platforms (ROADMAP C17)."""
    tcfg, jcfg = port_configs.get_config(arch), jax_configs.get_config(arch)
    for shape_name, tshape in port_configs.SHAPES.items():
        jshape = jax_configs.SHAPES[shape_name]
        mf = port_roofline.model_flops(tcfg, tshape)
        assert mf == jax_roofline.model_flops(jcfg, jshape) > 0
        for platform in (port_hw.TPU_V5E, port_hw.H100_SXM):
            jplat = _jax_platform(platform)
            for chips, summary in enumerate(_summaries(texts), start=1):
                kw = dict(xla_cost={"flops": 1.0, "bytes accessed": 2.0},
                          notes="n")
                tr = port_roofline.build_report(
                    tcfg, tshape, "m", chips, summary, platform=platform,
                    **kw)
                jr = jax_roofline.build_report(
                    jcfg, jshape, "m", chips, summary, platform=jplat, **kw)
                assert port_roofline.to_row(tr) == jax_roofline.to_row(jr)
                assert tr.bound_time_s == jr.bound_time_s
                useful = (mf / chips) / port_hw.TPU_V5E.chip.peak_flops
                if tr.bound_time_s > 0:
                    assert tr.roofline_fraction == pytest.approx(
                        useful / tr.bound_time_s, rel=1e-12)


def test_roofline_of_a_traced_port_step():
    """A roofline of the port's own traced step: ``step_summary``'s flops
    and bytes through ``build_report`` at the H100, and the train model
    flops 6 N tokens."""
    cfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get_config("llama3.2-1b")),
        num_layers=2)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_with_warmup

    summary = port_core.step_summary(build_model(cfg), adamw(),
                                     cosine_with_warmup(1e-3, 10, 1000),
                                     batch=2, seq=32, device="cpu")
    shape = port_configs.ShapeConfig("simtrain", 32, 2, "train")
    r = port_core.build_report(cfg, shape, "single", 1, summary,
                               platform=port_core.H100_SXM)
    assert r.compute_s == summary["flops"] / 989e12 > 0
    assert r.memory_s == summary["bytes"] / 3.35e12 > 0
    assert r.collective_s == r.collective_ring_s == 0.0
    assert r.model_flops_global == port_core.model_flops(cfg, shape) \
        == 6.0 * cfg.active_params() * 64


def test_core_exports_what_the_jax_core_exports():
    import repro.core as jax_core

    names = [n for n in dir(jax_core)
             if not n.startswith("_") and not isinstance(
                 getattr(jax_core, n), type(sys))]
    assert names
    missing = [n for n in names if not hasattr(port_core, n)]
    assert not missing
    for n in ("MeshInfo", "module_summary", "parse_module", "to_graph",
              "RooflineReport", "build_report", "model_flops"):
        assert getattr(port_core, n).__module__.startswith("repro_torch.")

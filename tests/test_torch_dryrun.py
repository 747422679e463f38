"""The port's dry run (``repro_torch.launch.{mesh,dryrun,hillclimb}``)
against the JAX package's.

The JAX side runs in one subprocess with 512 forced CPU devices (the JAX
dry run sets that count at import): the production meshes, the abstract
inputs of every config and shape, ``build_cell``'s specs, drops and
per-device argument bytes (the ``NamedSharding.shard_shape`` bytes of its
in-shardings) for the tier-1 cells, the hillclimb cells, and, on a
(2, 2) mesh patched in for ``make_production_mesh``, XLA's compiled
``argument_size_in_bytes`` of the smoke train and decode cells and the keys
of one record.  The port must match all of it exactly.  The port's own
checks: the rank's trace on a data-only mesh is the step at the rank's
batch, the kernel nodes of a traced step are its launches, the three traps
of the per-rank program (kv heads a rank holds but does not read, the
``seqpar`` query split, a rank's experts), the skip rule, the CLI.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import fx_graph  # noqa: E402
from repro_torch.dist.mesh import Mesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import (batch_logical_axes, build_model,  # noqa: E402
                                input_specs)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.schedules import cosine_with_warmup  # noqa: E402
from repro_torch.train import abstract_state  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIER1 = ("llama3.2-1b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
         "mamba2-2.7b")
SMOKE_ARCHS = ("llama3.2-1b", "qwen3-moe-235b-a22b", "mamba2-2.7b")
SMALL_MESH = ((2, 2), ("data", "model"))
# hillclimb variants whose configs carry what no shipped config does: a
# selective FSDP flag (fsdp_exclude) and the config's sharding_overrides
VARIANTS = (("kimi", "no_fsdp_experts"), ("kimi", "ep2d"), ("phi4", "seqpar"))
# the smoke cells' shapes, under the production names (their rules apply)
SMALL_SHAPES = {"train_4k": (64, 8, "train"), "decode_32k": (64, 8, "decode")}


def _cells(archs, meshes=("single", "multi")):
    out = []
    for a in archs:
        cfg = port_configs.get_config(a)
        for s, shape in port_configs.SHAPES.items():
            if port_configs.shape_applicable(cfg, shape)[0]:
                out += [(a, s, m) for m in meshes]
    return out


_JAX_SCRIPT = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import repro  # noqa: F401  (the JAX package's compat shims)
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import repro.launch.dryrun as D
from repro.compat import AxisType, make_mesh
from repro.configs.base import (SHAPES, ShapeConfig, get_config, list_archs,
                                smoke_variant)
from repro.launch import hillclimb as HC
from repro.launch.mesh import make_production_mesh, mesh_info
from repro.models import batch_logical_axes, build_model, input_specs
from repro.models.sharding import use_sharding
from repro.optim import make_optimizer
from repro.train.step import abstract_state

out_path, cells, small = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])


def part(p):
    return list(p) if isinstance(p, tuple) else p


def sds(x):
    return [list(x.shape), np.dtype(x.dtype).name]


def leaves_of(shapes, shardings):
    ls = jax.tree_util.tree_leaves(shapes)
    ss = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(ls) == len(ss), (len(ls), len(ss))
    return [sds(l) + [[part(p) for p in s.spec]] for l, s in zip(ls, ss)]


def shard_bytes(shapes, shardings):
    ls = jax.tree_util.tree_leaves(shapes)
    ss = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    return int(sum(int(np.prod(s.shard_shape(l.shape), dtype=np.int64))
                   * np.dtype(l.dtype).itemsize for l, s in zip(ls, ss)))


out = {"mesh": {}, "inputs": {}, "cells": {}, "compiled": {}, "hill": {}}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    mi = mesh_info(m)
    out["mesh"][str(mp)] = [list(m.axis_names), list(m.devices.shape),
                            [list(mi.axis_names), list(mi.axis_sizes),
                             list(mi.dcn_axes)]]

for a in list_archs():
    cfg = get_config(a)
    model = build_model(cfg)
    st, axes = abstract_state(model, make_optimizer(cfg.optimizer))
    rec = {"state": [sds(l) for l in jax.tree_util.tree_leaves(st)],
           "axes": [list(x) for x in jax.tree_util.tree_leaves(
               axes, is_leaf=lambda x: isinstance(x, tuple))],
           "shapes": {}}
    for s, shape in SHAPES.items():
        rec["shapes"][s] = {
            "specs": {k: sds(v) for k, v in input_specs(cfg, shape).items()},
            "axes": {k: list(v) for k, v in
                     batch_logical_axes(cfg, shape).items()},
            "cache": [sds(l) for l in jax.tree_util.tree_leaves(
                model.abstract_cache(shape.global_batch, shape.seq_len))],
        }
    out["inputs"][a] = rec

for a, s, m in cells:
    fn, shapes, in_sh, out_sh, ctx, meta = D.build_cell(a, s, m == "multi")
    out["cells"]["|".join((a, s, m))] = {
        "in": leaves_of(shapes, in_sh), "drops": [str(d) for d in ctx.drops],
        "arg_bytes": shard_bytes(shapes, in_sh), "meta": meta}

out["variants"] = {}
for cell, variant in small["variants"]:
    arch, s, variants = HC.CELLS[cell]
    t = next(t for v, _, t in variants if v == variant)
    fn, shapes, in_sh, out_sh, ctx, meta = D.build_cell(
        arch, s, False, cfg=t(get_config(arch)))
    out["variants"][f"{cell}|{variant}"] = {
        "in": leaves_of(shapes, in_sh), "drops": [str(d) for d in ctx.drops],
        "arg_bytes": shard_bytes(shapes, in_sh)}

for name, (arch, shape, variants) in HC.CELLS.items():
    base = get_config(arch)
    out["hill"][name] = [arch, shape, [
        [v, hyp, dataclasses.asdict(t(base))] for v, hyp, t in variants]]

skip = D.run_cell("llama3.2-1b", "long_500k", "single", small["out"])
out["skip"] = [skip["status"], skip["reason"]]

# the smoke cells compiled on a small mesh
shape_, names = small["mesh"]
D.make_production_mesh = lambda multi_pod=False: make_mesh(
    tuple(shape_), tuple(names), axis_types=(AxisType.Auto,) * len(names))
D.SHAPES = {k: ShapeConfig(k, *v) for k, v in small["shapes"].items()}
for a in small["archs"]:
    cfg = smoke_variant(get_config(a))
    for s in small["shapes"]:
        fn, shapes, in_sh, out_sh, ctx, meta = D.build_cell(a, s, False,
                                                            cfg=cfg)
        with use_sharding(ctx):
            lowered = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                              donate_argnums=meta.get("donate", ())
                              ).lower(*shapes)
        ma = lowered.compile().memory_analysis()
        out["compiled"]["|".join((a, s))] = {
            "xla": int(ma.argument_size_in_bytes),
            "shards": shard_bytes(shapes, in_sh)}
rec = D.run_cell(small["archs"][0], "decode_32k", "single", small["out"],
                 cfg=smoke_variant(get_config(small["archs"][0])))
out["record"] = {"keys": sorted(rec), "status": rec["status"],
                 "memory": sorted(rec["memory"]),
                 "summary": sorted(rec["summary"]),
                 "roofline": sorted(rec["roofline"])}
json.dump(out, open(out_path, "w"))
print("jax_dryrun_ok")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    small = {"mesh": SMALL_MESH, "shapes": SMALL_SHAPES,
             "archs": SMOKE_ARCHS, "out": str(d / "records"),
             "variants": VARIANTS}
    run = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "jax.json"),
         json.dumps(_cells(TIER1)), json.dumps(small)],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "jax_dryrun_ok" in run.stdout
    return json.loads((d / "jax.json").read_text())


def _dtype(t) -> str:
    return str(t).split(".")[-1]


def _sds(x):
    return [list(x.shape), _dtype(x.dtype)]


def _part(p):
    return list(p) if isinstance(p, tuple) else p


def _port_leaves(shapes, specs):
    return [_sds(sd) + [[_part(p) for p in sp]]
            for sd, sp in D._pairs(shapes, specs)]


def _small_mesh():
    shape, names = SMALL_MESH
    return Mesh(names, shape, (torch.device("meta"),) * math.prod(shape))


def _small_shape(name):
    return port_configs.ShapeConfig(name, *SMALL_SHAPES[name])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_and_mesh_info_equal_jax(jax_side, multi_pod):
    m = M.make_production_mesh(multi_pod=multi_pod)
    mi = M.mesh_info(m)
    assert [list(m.axis_names), list(m.shape),
            [list(mi.axis_names), list(mi.axis_sizes), list(mi.dcn_axes)]] \
        == jax_side["mesh"][str(multi_pod)]
    assert {d.type for d in m.devices} == {"meta"}   # nothing placed


# the archs of both packages: the port registers granite-4.0-h-small besides
@pytest.mark.parametrize("arch", [a for a in port_configs.list_archs()
                                  if a != "granite-4.0-h-small"])
def test_abstract_inputs_equal_jax(jax_side, arch):
    """input_specs, batch_logical_axes, abstract_cache (every shape) and
    abstract_state (shapes, dtypes, parameter axes) equal JAX's."""
    ref = jax_side["inputs"][arch]
    cfg = port_configs.get_config(arch)
    model = build_model(cfg)
    st, axes = abstract_state(model, make_optimizer(cfg.optimizer))
    flat = [st.step] + leaves(st.params) + leaves(st.opt_state)
    assert [_sds(x) for x in flat] == ref["state"]
    assert [list(a) for a in leaves(axes)] == ref["axes"]
    for s, shape in port_configs.SHAPES.items():
        r = ref["shapes"][s]
        assert {k: _sds(v) for k, v in input_specs(cfg, shape).items()} \
            == r["specs"]
        assert {k: list(v) for k, v in
                batch_logical_axes(cfg, shape).items()} == r["axes"]
        cache = model.abstract_cache(shape.global_batch, shape.seq_len)
        assert [_sds(x) for x in leaves(cache)] == r["cache"]


@pytest.mark.parametrize("cell", _cells(TIER1), ids="|".join)
def test_cell_specs_drops_and_argument_bytes_equal_jax(jax_side, cell):
    """The state's (or parameters'), batch's and cache's specs and the
    resolver's drops equal JAX's ``build_cell`` (overrides, the config's
    sharding_overrides and the FSDP flag included), and the per-rank
    argument bytes equal the shard bytes of JAX's in-shardings."""
    a, s, m = cell
    ref = jax_side["cells"]["|".join(cell)]
    fn, shapes, in_specs, _, ctx, meta = D.build_cell(a, s, m == "multi")
    assert _port_leaves(shapes, in_specs) == ref["in"]
    assert [str(d) for d in ctx.drops] == ref["drops"]
    assert D.shard_bytes(shapes, in_specs, ctx.mesh.sizes) \
        == ref["arg_bytes"]
    assert json.loads(json.dumps(meta)) == ref["meta"]


@pytest.mark.parametrize("cell,variant", VARIANTS)
def test_variant_specs_drops_and_argument_bytes_equal_jax(jax_side, cell,
                                                         variant):
    """The same for the hillclimb variants that set ``fsdp_exclude`` (a
    per-leaf FSDP flag) and the config's ``sharding_overrides``."""
    ref = jax_side["variants"][f"{cell}|{variant}"]
    arch, s, variants = HC.CELLS[cell]
    t = next(t for v, _, t in variants if v == variant)
    fn, shapes, in_specs, _, ctx, _ = D.build_cell(
        arch, s, False, cfg=t(port_configs.get_config(arch)))
    assert _port_leaves(shapes, in_specs) == ref["in"]
    assert [str(d) for d in ctx.drops] == ref["drops"]
    assert D.shard_bytes(shapes, in_specs, ctx.mesh.sizes) \
        == ref["arg_bytes"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("shape", sorted(SMALL_SHAPES))
def test_argument_bytes_equal_xla_compiled(jax_side, arch, shape):
    """XLA's compiled ``argument_size_in_bytes`` of the smoke cell on a
    (2, 2) mesh is the port's per-rank argument bytes."""
    ref = jax_side["compiled"][f"{arch}|{shape}"]
    cfg = port_configs.smoke_variant(port_configs.get_config(arch))
    _, shapes, in_specs, _, ctx, _ = D.build_cell(
        arch, shape, False, cfg=cfg, mesh=_small_mesh(),
        shape=_small_shape(shape))
    got = D.shard_bytes(shapes, in_specs, ctx.mesh.sizes)
    assert got == ref["shards"] == ref["xla"]


def test_record_keys_match_jax(jax_side, tmp_path):
    """The port's record has the JAX record's keys, the compile's seconds
    renamed to the trace's, and its memory, summary and roofline keys."""
    ref = jax_side["record"]
    arch = SMOKE_ARCHS[0]
    cfg = port_configs.smoke_variant(port_configs.get_config(arch))
    rec = D.run_cell(arch, "decode_32k", "single", str(tmp_path), cfg=cfg,
                     mesh=_small_mesh(), shape=_small_shape("decode_32k"),
                     device="cpu")
    assert rec["status"] == ref["status"] == "ok", rec.get("traceback")
    renamed = {"lower_s", "compile_s", "parse_s"}
    assert set(ref["keys"]) - renamed <= set(rec)
    assert set(rec) - set(ref["keys"]) == {
        "build_s", "trace_s", "graph_s", "device", "rank", "notes"}
    assert rec["xla_cost"] is None and rec["hlo_bytes"] is None
    assert set(ref["memory"]) <= set(rec["memory"])
    assert rec["memory"]["generated_code_size_in_bytes"] is None
    assert "not XLA's" in rec["memory"]["temp_source"]
    assert set(ref["summary"]) <= set(rec["summary"]) | {"graph"}
    assert set(ref["roofline"]) <= set(rec["roofline"])
    assert (tmp_path / f"{arch}__decode_32k__single.json").exists()


def test_skip_rule_matches_jax(jax_side, tmp_path):
    rec = D.run_cell("llama3.2-1b", "long_500k", "single", str(tmp_path))
    assert [rec["status"], rec["reason"]] == jax_side["skip"]
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def _on_fields(port: dict, jax_side: dict) -> dict:
    """A port config's ``asdict`` on the JAX config's fields (the port's
    granite fields, at defaults that add no operation, left out)."""
    return {k: _on_fields(v, jax_side[k]) if isinstance(v, dict)
            and isinstance(jax_side[k], dict) else v
            for k, v in port.items() if k in jax_side}


def test_hillclimb_cells_equal_jax(jax_side):
    """The same three cells, variant names, hypotheses and every
    transformed config, field by field."""
    jax_hill = jax_side["hill"]
    port = {name: [arch, shape, [
        [v, hyp, _on_fields(dataclasses.asdict(
            t(port_configs.get_config(arch))), jax_hill[name][2][i][2])]
        for i, (v, hyp, t) in enumerate(variants)]]
        for name, (arch, shape, variants) in HC.CELLS.items()}
    assert json.loads(json.dumps(port)) == jax_hill
    assert sum(len(v[2]) for v in port.values()) == 12


def test_cli_writes_a_record(jax_side, tmp_path):
    """The CLI at the full config on fake CPU tensors: an ok record whose
    argument bytes are JAX's for that cell."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "decode_32k", "--mesh", "single",
         "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(
        (tmp_path / "llama3.2-1b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256
    assert rec["memory"]["argument_size_in_bytes"] == \
        jax_side["cells"]["llama3.2-1b|decode_32k|single"]["arg_bytes"]
    assert rec["summary"]["flops"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["roofline"]["roofline_fraction_h100"]


# ---------------------------------------------------------------------------
# The port's own checks
# ---------------------------------------------------------------------------


def _summary(fn, mesh, cfg, kind):
    summary, temp, _ = D.rank_summary(fn, mesh, cfg, kind, device="cpu")
    return summary, temp


def test_rank_trace_is_the_step_on_a_data_only_mesh():
    """On a (data 2 x model 1) mesh the rank's trace is the step at the
    rank's batch: flops, bytes and nodes equal the whole step's exactly."""
    cfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get_config("llama3.2-1b")),
        grad_accum=2, num_layers=2)
    mesh = Mesh(("data", "model"), (2, 1), (torch.device("meta"),) * 2)
    shape = port_configs.ShapeConfig("train_4k", 64, 8, "train")
    fn, *_ , meta = D.build_cell("llama3.2-1b", "train_4k", False, cfg=cfg,
                                 mesh=mesh, shape=shape)
    assert meta["grad_accum"] == 2
    got, temp = _summary(fn, mesh, cfg, "train")
    # the whole step over the same two microbatches, traced as
    # fx_graph.step_summary traces one
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.step import init_state, make_train_step

    model, opt = build_model(cfg), make_optimizer(cfg.optimizer)
    step = make_train_step(model, opt, cosine_with_warmup(3e-4, 100, 10_000),
                           grad_accum=2)
    with FakeTensorMode() as mode:
        state = init_state(model, torch.Generator().manual_seed(0), opt)
        toks = {k: torch.zeros((4, 64), dtype=torch.int32)
                for k in ("tokens", "labels")}
    ref = fx_graph.summarize_graph(fx_graph.graph_from_fx(
        fx_graph._trace_train(step, state, toks, mode), "step"))
    assert got["flops"] == ref["flops"]
    assert got["bytes"] == ref["bytes"]
    assert got["nodes"] == ref["nodes"]
    assert temp > 0
    # one rank on the model axis: the gradients' reduction over data, and
    # the ZeRO-1 gather of each leaf whose optimizer state data splits
    info = fn.info["leaf_info"]
    assert got["collectives"]["all-reduce"]["count"] == len(info)
    assert got["collectives"]["all-gather"]["count"] == \
        sum(i["opt_zero"] for i in info) > 0
    assert set(got["collectives"]) == {"all-reduce", "all-gather"}


@pytest.mark.parametrize("arch", ("llama3.2-1b", "mamba2-2.7b"))
def test_kernel_nodes_are_the_step_launches(arch):
    """Each kernel op of the rank's step is one node, as it is one launch:
    per microbatch, each layer's mixer and norms in the forward and again
    in the remat recompute, and the final norm once."""
    cfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get_config(arch)),
        grad_accum=2, num_layers=2)
    mesh = Mesh(("data", "model"), (1, 2), (torch.device("meta"),) * 2)
    shape = port_configs.ShapeConfig("train_4k", 64, 4, "train")
    fn, *_ = D.build_cell(arch, "train_4k", False, cfg=cfg, mesh=mesh,
                          shape=shape)
    got, _ = _summary(fn, mesh, cfg, "train")
    n = cfg.num_layers
    mixers = {"flash_attention": n} if cfg.family == "dense" else \
        {"ssd_scan": n}
    norms = (2 if cfg.family == "dense" else 1) * n
    want = {k: 2 * v * 2 for k, v in mixers.items()}
    want["rmsnorm"] = (2 * norms + 1) * 2
    assert got["kernel_nodes"] == want


def _flash_calls(summary):
    return [n.meta["call"]["args"] for n in summary["graph"].nodes
            if n.meta.get("kernel") == "flash_attention"]


def test_rank_reads_one_of_the_kv_heads_it_holds():
    """llama3.2-1b on (16, 16): 32 query heads split to 2 a rank, the 8 kv
    heads dropped (8 % 16): the rank projects all 8 and its 2 queries read
    one (two layers of the full-width prefill)."""
    cfg = dataclasses.replace(port_configs.get_config("llama3.2-1b"),
                              num_layers=2)
    fn, shapes, in_specs, _, ctx, _ = D.build_cell(
        "llama3.2-1b", "prefill_32k", False, cfg=cfg)
    assert (fn.info["rank_cfg"].num_heads,
            fn.info["rank_cfg"].num_kv_heads) == (2, 8)
    got, _ = _summary(fn, ctx.mesh, cfg, "prefill")
    calls = _flash_calls(got)
    assert len(calls) == 2
    q, k = calls[0][0]["shape"], calls[0][1]["shape"]
    assert q == [2, 32768, 2, 64] and k == [2, 32768, 1, 64]
    wk = next(i for i in fn.info["leaf_info"] if i["path"].endswith("wk"))
    assert wk["shape"] == (2, 2048, 8, 64)   # every kv head projected
    assert got["kinds"]["dot"] > 0


def test_seqpar_rank_runs_its_share_of_the_queries():
    """phi4's ``seqpar``: 24 heads do not split 16 ways, so the queries
    split their sequence; the rank's last 1/16 attends to every key at its
    offset, and the block's output is all-gathered back."""
    base = port_configs.get_config("phi4-mini-3.8b")
    cfg = dataclasses.replace(
        HC.CELLS["phi4"][2][0][2](base), num_layers=2)
    fn, *_, ctx, _ = D.build_cell("phi4-mini-3.8b", "prefill_32k", False,
                                  cfg=cfg)
    assert fn.info["seq_q"] == 16
    got, _ = _summary(fn, ctx.mesh, cfg, "prefill")
    for args in _flash_calls(got):
        assert args[0]["shape"] == [2, 2048, 24, 128]
        assert args[1]["shape"] == [2, 32768, 8, 128]
    assert got["collectives"]["all-gather"]["count"] == 2
    plain = dataclasses.replace(base, num_layers=2)
    fn0, *_ = D.build_cell("phi4-mini-3.8b", "prefill_32k", False, cfg=plain)
    assert fn0.info["seq_q"] == 1
    base_sum, _ = _summary(fn0, ctx.mesh, plain, "prefill")
    flash = [n for g in (got, base_sum) for n in g["graph"].nodes
             if n.meta.get("kernel") == "flash_attention"]
    # the causal rows of the last 1/16 see 31/32 of what 1/16 of every
    # row sees on average: the rank's attention flops fall ~8.3x
    ratio = flash[-1].flops / flash[0].flops
    assert 7 < ratio < 9


def test_rank_runs_the_ffn_of_its_experts():
    """qwen3-moe on (16, 16): 128 experts split to 8 a rank, routing over
    all 128 (the router whole), the FFN over the rank's 8."""
    cfg = dataclasses.replace(port_configs.get_config("qwen3-moe-235b-a22b"),
                              num_layers=1)
    fn, *_, ctx, _ = D.build_cell("qwen3-moe-235b-a22b", "prefill_32k",
                                  False, cfg=cfg)
    info = {i["path"]: i for i in fn.info["leaf_info"]}
    assert info["blocks/moe/router"]["shape"] == (1, 4096, 128)
    assert info["blocks/moe/wg"]["shape"] == (1, 8, 4096, 1536)
    got, _ = _summary(fn, ctx.mesh, cfg, "prefill")
    experts = {n.meta["dot"]["lhs"][0] for n in got["graph"].nodes
               if n.kind == "dot" and len(n.meta["dot"]["lhs"]) == 3
               and n.meta["dot"]["rhs"][-1] == 1536}
    assert experts == {8}


def test_a_truncated_expert_tree_raises_outside_the_dry_run():
    """Only a dry-run rank runs the FFN of fewer experts than the config:
    elsewhere (a real step or serve call given a piece of the expert tree)
    the shapes disagree and the call raises, as it did before the dry run
    existed."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.sharding import (RankView, ShardingCtx,
                                             use_sharding)

    cfg = port_configs.smoke_variant(
        port_configs.get_config("qwen3-moe-235b-a22b"))
    E = cfg.moe.num_experts
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                     torch.float32)
    piece = {k: v if k == "router" else v[:E // 2] for k, v in p.items()}
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with pytest.raises(RuntimeError):
        MOE.moe_ffn(piece, x, cfg.moe, "float32")
    mesh = Mesh(("data", "model"), (1, 2), (torch.device("meta"),) * 2)
    with use_sharding(ShardingCtx(mesh=mesh, rank=RankView(model=2))):
        y, aux = MOE.moe_ffn(piece, x, cfg.moe, "float32")
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_decode_rank_writes_its_last_slot():
    """decode_32k puts the cache's sequence on ``model``: the rank holds
    2048 positions and writes the token at its last."""
    fn, shapes, in_specs, _, ctx, _ = D.build_cell("llama3.2-1b",
                                                   "decode_32k", False)
    assert fn.info["cache_len"] == 2047
    assert fn.info["kv_seq_axes"] == ("model",)
    assert fn.info["cache"]["k"].shape == (16, 8, 2048, 8, 64)


def test_one_rank_arguments_are_the_allocated_state():
    """On a 1-rank mesh the arguments are the card's allocation: the
    llama3.2-1b train state under AdamW and its (8, 2048) batch, and the
    bf16 weights with a batch-8 2048-position cache and the token."""
    mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
    cfg = port_configs.get_config("llama3.2-1b")
    _, shapes, in_specs, _, ctx, _ = D.build_cell(
        "llama3.2-1b", "train", False, mesh=mesh,
        shape=port_configs.ShapeConfig("train", 2048, 8, "train"))
    assert D.shard_bytes(shapes, in_specs, ctx.mesh.sizes) == 14_829_903_880
    _, shapes, in_specs, _, ctx, _ = D.build_cell(
        "llama3.2-1b", "decode", False, mesh=mesh,
        shape=port_configs.ShapeConfig("decode", 2048, 8, "decode"))
    assert D.shard_bytes(shapes[1], in_specs[1], ctx.mesh.sizes) \
        == 536_870_912
    assert D.shard_bytes(shapes, in_specs, ctx.mesh.sizes) \
        == 2_471_628_800 + 536_870_912 + 8 * 4
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    _, shapes, in_specs, _, ctx, _ = D.build_cell(
        "llama3.2-1b", "decode", False, cfg=int8, mesh=mesh,
        shape=port_configs.ShapeConfig("decode", 2048, 8, "decode"))
    assert D.shard_bytes(shapes[1], in_specs[1], ctx.mesh.sizes) \
        == 276_824_064


def test_a_cuda_trace_without_a_cuda_build_is_an_error(tmp_path):
    """No fallback: where PyTorch has no CUDA the card's program is not
    traced, and the record says so."""
    if torch.backends.cuda.is_built():
        pytest.skip("this PyTorch has CUDA: the trace runs")
    rec = D.run_cell("llama3.2-1b", "decode_32k", "single", str(tmp_path),
                     device="cuda")
    assert rec["status"] == "error"
    assert "no CUDA" in rec["error"]


@pytest.mark.cuda
def test_cuda_trace_kernel_nodes_are_the_launches():
    """On the card: the fake-CUDA trace of the smoke step has one kernel
    node for each launch of the real step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.train.step import init_state, make_train_step

    cfg = port_configs.smoke_variant(port_configs.get_config("llama3.2-1b"))
    mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
    shape = port_configs.ShapeConfig("train_4k", 64, 4, "train")
    fn, *_ = D.build_cell("llama3.2-1b", "train_4k", False, cfg=cfg,
                          mesh=mesh, shape=shape)
    got, _, _ = D.rank_summary(fn, mesh, cfg, "train", device="cuda")
    dev = torch.device("cuda", 0)
    model, opt = build_model(cfg), make_optimizer(cfg.optimizer)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                       opt)
    step = make_train_step(model, opt, cosine_with_warmup(3e-4, 100, 10_000))
    batch = {k: torch.zeros((4, 64), dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    counters = {"flash_attention": fa_ops.LAUNCHES,
                "rmsnorm": rms_ops.LAUNCHES,
                "flash_attention_bwd": fa_ops.BWD_LAUNCHES}
    for c in counters.values():
        c.reset()
    step(state, batch)
    torch.cuda.synchronize()
    # the bf16 gradient of flash attention is a node and a launch of the
    # backward kernels; an fp32 one is the plain VJP (neither)
    assert got["kernel_nodes"] == {k: c.count for k, c in counters.items()
                                   if c.count}


@pytest.mark.slow
def test_every_cell_on_both_meshes(jax_side, tmp_path):
    """All 80 cells through the CLI on fake CPU tensors: ok, or skipped
    exactly where the JAX dry run skips.  About two hours on a CPU host:
    a train cell's trace unrolls every layer of every microbatch (jamba's
    72 x 8 takes ~11 minutes)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=14400)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 80
    for rec in recs:
        cfg = port_configs.get_config(rec["arch"])
        ok, _ = port_configs.shape_applicable(
            cfg, port_configs.SHAPES[rec["shape"]])
        assert rec["status"] == ("ok" if ok else "skipped"), \
            (rec["arch"], rec["shape"], rec["mesh"], rec.get("error"))

"""The port's strategy graph, autotuner and timeline against the JAX
package's: ``pipeline_graph`` and ``model_pipeline_graph`` give the same
nodes, edges and comm bytes; the autotuner ranks the same candidates in the
same order with the same simulated makespans for the same estimator on
``TPU_V5E``; the estimator resolves ``compression`` and ``pp_hop`` nodes and
refuses ``moe_a2a``; the Chrome trace of a simulated schedule is the same.

These modules are copies of framework-neutral ones (or, for the
autotuner, a copy with a port-side hook), so the comparisons are exact.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import autotuner as jax_tuner  # noqa: E402
from repro.core import estimator as jax_est  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.core import strategy as jax_strategy  # noqa: E402
from repro.core import timeline as jax_timeline  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import autotuner as port_tuner  # noqa: E402
from repro_torch.core import estimator as port_est  # noqa: E402
from repro_torch.core import hardware as port_hw  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.core import strategy as port_strategy  # noqa: E402
from repro_torch.core import timeline as port_timeline  # noqa: E402

torch.set_num_threads(2)

STRATEGIES = [
    dict(dp=1, pp=4, microbatches=8, schedule="gpipe"),
    dict(dp=2, pp=2, microbatches=4, schedule="1f1b", compression="int8"),
    dict(dp=4, pp=2, microbatches=4, schedule="interleaved_1f1b",
         vstages=2, compression="topk:0.01", overlap_buckets=2),
    dict(dp=2, pp=4, microbatches=8, schedule="1f1b", overlap_buckets=3),
]


def _nodes(g):
    return [(n.uid, n.name, n.kind, n.deps, n.device, n.flops, n.in_bytes,
             n.out_bytes, n.comm_bytes, n.group_size, n.link_kind,
             json.dumps(n.meta, sort_keys=True)) for n in g.nodes]


@pytest.mark.parametrize("kw", STRATEGIES)
def test_pipeline_graph_equals_reference(kw):
    cost = dict(fwd_flops=3e9, fwd_bytes=2e7, boundary_bytes=4.0e6,
                grad_bytes=3.2e7, grad_tensors=9)
    jg = jax_strategy.pipeline_graph(16, jax_strategy.LayerCost(**cost),
                                     jax_strategy.Strategy(**kw))
    tg = port_strategy.pipeline_graph(16, port_strategy.LayerCost(**cost),
                                      port_strategy.Strategy(**kw))
    assert _nodes(tg) == _nodes(jg)
    tcomm = [port_est.dist_comm_bytes(n) for n in tg.nodes
             if n.is_collective]
    assert tcomm == [jax_est.dist_comm_bytes(n) for n in jg.nodes
                     if n.is_collective]
    assert port_strategy.Strategy(**kw).describe() == \
        jax_strategy.Strategy(**kw).describe()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b"])
def test_model_pipeline_graph_and_layer_cost_equal_reference(arch):
    jcfg = jax_configs.smoke_variant(jax_configs.get_config(arch))
    tcfg = port_configs.smoke_variant(port_configs.get_config(arch))
    for kw in STRATEGIES[:3]:
        jst = jax_strategy.Strategy(**kw)
        tst = port_strategy.Strategy(**kw)
        jg = jax_strategy.model_pipeline_graph(jcfg, jst, 2, 32)
        tg = port_strategy.model_pipeline_graph(tcfg, tst, 2, 32)
        assert _nodes(tg) == _nodes(jg)
        for tn, jn in zip(tg.nodes, jg.nodes):
            if tn.is_collective:
                assert port_est.dist_comm_bytes(tn) == \
                    jax_est.dist_comm_bytes(jn)
    for mb, tp in ((1, 1), (4, 2)):
        # the port's one extra field: no measured layer behind this cost
        tcost = dataclasses.asdict(
            port_tuner.layer_cost_from_config(tcfg, mb, 64, tp))
        assert tcost.pop("profile_key") is None
        assert tcost == dataclasses.asdict(
            jax_tuner.layer_cost_from_config(jcfg, mb, 64, tp))
    assert port_strategy.grad_allreduce_node_meta([3, 4, 5], "int8") == \
        jax_strategy.grad_allreduce_node_meta([3, 4, 5], "int8")
    if tcfg.moe is not None:
        assert port_strategy.moe_a2a_node_meta(tcfg.moe, 64, 128, 2) == \
            jax_strategy.moe_a2a_node_meta(jcfg.moe, 64, 128, 2)


def test_estimator_resolves_compression_and_pp_hop_refuses_moe_a2a():
    """The estimator resolves every annotation of an ep_a2a MoE plan: the
    int8 all-reduce, the pipeline hop, and each ``moe_a2a`` node exactly as
    the JAX estimator prices the same node of the JAX graph."""
    tcfg = port_configs.smoke_variant(port_configs.get_config(
        "qwen3-moe-235b-a22b"))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl="ep_a2a"))
    jcfg = jax_configs.smoke_variant(jax_configs.get_config(
        "qwen3-moe-235b-a22b"))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, impl="ep_a2a"))
    g = port_strategy.model_pipeline_graph(
        tcfg, port_strategy.Strategy(dp=2, pp=2, microbatches=2,
                                     compression="int8"), 2, 32)
    jg = jax_strategy.model_pipeline_graph(
        jcfg, jax_strategy.Strategy(dp=2, pp=2, microbatches=2,
                                    compression="int8"), 2, 32)
    jnodes = {n.name: n for n in jg.nodes}
    kinds = {}
    for n in g.nodes:
        if n.meta.get("moe_a2a"):
            want = jax_est.dist_comm_bytes(jnodes[n.name])
            assert port_est.dist_comm_bytes(n) == want
            # 4 experts, top-2, groups of 32 at cf 1.25 (C = 20), 64 local
            # tokens of d_model 128 in fp32
            assert want == 4 * 2 * 20 * 128 * 4
            kinds["a2a"] = True
        elif n.meta.get("pp_hop"):
            assert port_est.dist_comm_bytes(n) == 2 * 32 * tcfg.d_model * 4
            kinds["hop"] = True
        elif n.meta.get("compression") == "int8":
            elems = n.meta["grad_leaf_elems"]
            assert port_est.dist_comm_bytes(n) == sum(elems) + 4 * len(elems)
            assert port_est.dist_comm_bytes(n) < n.comm_bytes
            kinds["ar"] = True
    assert kinds == {"a2a": True, "hop": True, "ar": True}


@pytest.mark.parametrize("chips,straggler", [(8, None), (16, (0, 3.0))])
def test_autotuner_ranking_equals_reference(chips, straggler):
    jcfg = jax_configs.get_config("llama3.2-1b")
    tcfg = port_configs.get_config("llama3.2-1b")
    extra = {}
    if straggler:
        extra = {"straggler_stage": straggler[0],
                 "straggler_factor": straggler[1]}
    jt = jax_tuner.Autotuner(jcfg, chips=chips, global_batch=32, seq=512,
                             platform=jax_hw.TPU_V5E, **extra)
    tt = port_tuner.Autotuner(tcfg, chips=chips, global_batch=32, seq=512,
                              platform=port_hw.TPU_V5E, **extra)
    kw = dict(max_pp=8, microbatch_options=(1, 2, 4, 8))
    jr = jt.search(**kw)
    tr = tt.search(**kw)
    assert tt.prune_stats == jt.prune_stats
    assert [r.strategy.describe() for r in tr] == \
        [r.strategy.describe() for r in jr]
    for a, b in zip(tr, jr):
        assert a.makespan_s == pytest.approx(b.makespan_s, rel=1e-12)
        assert a.bubble_fraction == pytest.approx(b.bubble_fraction,
                                                  rel=1e-9, abs=1e-12)
    # the port's defaults: the H100 platform, and a per-layer cost hook
    assert port_tuner.Autotuner(tcfg, 8, 32, 512).platform.name == \
        "h100_sxm"
    calls = []

    def cost(mb, tp):
        calls.append((mb, tp))
        return port_tuner.layer_cost_from_config(tcfg, mb, 512, tp)

    hooked = port_tuner.Autotuner(tcfg, chips=chips, global_batch=32,
                                  seq=512, platform=port_hw.TPU_V5E,
                                  layer_cost=cost, **extra)
    hr = hooked.search(tp_options=(1,), **kw)
    assert calls and all(tp == 1 for _, tp in calls)
    assert [r.strategy.describe() for r in hr] == \
        [r.strategy.describe() for r in tr if r.strategy.tp == 1]


def test_timeline_trace_equals_reference(tmp_path):
    kw = dict(dp=2, pp=2, microbatches=4, schedule="1f1b")
    cost = dict(fwd_flops=1e9, fwd_bytes=1e7, boundary_bytes=1e6,
                grad_bytes=1e7)
    jg = jax_strategy.pipeline_graph(8, jax_strategy.LayerCost(**cost),
                                     jax_strategy.Strategy(**kw))
    tg = port_strategy.pipeline_graph(8, port_strategy.LayerCost(**cost),
                                      port_strategy.Strategy(**kw))
    je = jax_est.OpTimeEstimator(jax_hw.TPU_V5E)
    te = port_est.OpTimeEstimator(port_hw.TPU_V5E)
    jres = jax_sim.simulate(jg, je.duration, record_events=True)
    tres = port_sim.simulate(tg, te.duration, record_events=True)
    assert tres.makespan == pytest.approx(jres.makespan, rel=1e-12)
    jt = jax_timeline.to_chrome_trace(jres, str(tmp_path / "j.json"),
                                      graph=jg)
    tt = port_timeline.to_chrome_trace(tres, str(tmp_path / "t.json"),
                                       graph=tg)
    assert json.dumps(tt, sort_keys=True) == json.dumps(jt, sort_keys=True)


def test_card_profiled_layer_cost_prices_every_chunk_from_the_db():
    """``models.pipeline.profile_layer`` (here on the CPU, under the H100's
    platform key) records one layer's forward and backward and nothing
    else; an autotuner over that cost prices every compute node as its
    chunk's layer count times them, and a micro-batch nobody profiled is
    refused."""
    from repro_torch.core.database import ProfileDB
    from repro_torch.models.pipeline import model_layer_cost, profile_layer

    cfg = port_configs.smoke_variant(port_configs.get_config("llama3.2-1b"))
    db = ProfileDB()
    plat = port_hw.H100_SXM.name
    layer = {mb: profile_layer(db, plat, cfg, mb, 32, "cpu", repeats=2)
             for mb in (1, 2)}
    for out in layer.values():
        assert out["fwd_s"] > 0 and out["bwd_s"] > 0
    assert db.op_families(plat) == ["layer_bwd", "layer_fwd"]
    est = port_est.OpTimeEstimator(port_hw.H100_SXM, db)
    tuner = port_tuner.Autotuner(
        cfg, chips=4, global_batch=4, seq=32, estimator=est,
        layer_cost=lambda mb, tp: model_layer_cost(
            cfg, mb, 32, tp, db=db, platform=plat))
    res = tuner.search(tp_options=(1,), microbatch_options=(2, 4))
    assert res and est.layer_chunks > 0
    assert est.stats["db"] == est.stats["learned"] == \
        est.stats["analytic"] == 0
    # one chunk of a pp=2 graph: half the layers times the measured layer
    cost = model_layer_cost(cfg, 1, 32, db=db, platform=plat)
    g = port_strategy.pipeline_graph(
        cfg.num_layers, cost, port_strategy.Strategy(pp=2, microbatches=2))
    per = cfg.num_layers // 2
    for n in g.nodes:
        if n.kind in ("fwd", "bwd"):
            assert est.duration(n) == pytest.approx(
                per * layer[1][f"{n.kind}_s"], rel=1e-12)
    with pytest.raises(KeyError, match="profile it first"):
        model_layer_cost(cfg, 8, 32, db=db, platform=plat)

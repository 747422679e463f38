"""The port's copies of the priced serving twin against the JAX package's.

``simulate_serve`` and ``replay_schedule`` on the committed acceptance trace
(benchmarks/traces/serve_acceptance.json) with the synthetic serve grid, the
analytic fallback, the generic simulator, and the ProfileDB file format —
all must give the same numbers in both packages.  Plus the port-only pieces
around them: the H100 platform specs and what is not ported yet.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import database as jax_db  # noqa: E402
from repro.core import graph as jax_graph  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.core import simulator as jax_simulator  # noqa: E402
from repro.core.estimator import OpTimeEstimator as JaxEstimator  # noqa: E402
from repro.serve import cost as jax_cost  # noqa: E402
from repro.serve import policy as jax_policy  # noqa: E402
from repro.serve import sim as jax_sim  # noqa: E402
from repro.serve import trace as jax_trace  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import database as port_db  # noqa: E402
from repro_torch.core import graph as port_graph  # noqa: E402
from repro_torch.core import hardware as port_hw  # noqa: E402
from repro_torch.core import simulator as port_simulator  # noqa: E402
from repro_torch.core.estimator import OpTimeEstimator  # noqa: E402
from repro_torch.netprof.pricing import graph_provenance  # noqa: E402
from repro_torch.serve import cost as port_cost  # noqa: E402
from repro_torch.serve import policy as port_policy  # noqa: E402
from repro_torch.serve import sim as port_sim  # noqa: E402
from repro_torch.serve import trace as port_trace  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TRACE = os.path.join(REPO, "benchmarks", "traces", "serve_acceptance.json")
SERVE = dict(slots=4, max_len=64, block_size=8, chunk=8)


def _side(configs, db_mod, cost, policy, hw, est_cls, synthetic=True,
          platform="cpu_host"):
    cfg = configs.smoke_variant(configs.get_config("llama3.2-1b"))
    scfg = policy.ServeConfig(**SERVE)
    db = db_mod.ProfileDB()
    if synthetic:
        cost.synthetic_serve_calibration(
            db, cfg.name, platform, views=(scfg.view_len,),
            slot_grid=(1, 2, scfg.slots, 2 * scfg.slots))
    est = est_cls(hw.PLATFORMS[platform], db=db, use_learned=False)
    return cfg, scfg, db, est


def _jax_side(**kw):
    return _side(jax_configs, jax_db, jax_cost, jax_policy, jax_hw,
                 JaxEstimator, **kw)


def _port_side(**kw):
    return _side(port_configs, port_db, port_cost, port_policy, port_hw,
                 OpTimeEstimator, **kw)


def _events(result):
    return [dataclasses.astuple(e) for e in result.timeline.events]


@pytest.mark.parametrize("synthetic,platform", [
    (True, "cpu_host"),       # every node a DB hit or interpolation
    (False, "tpu_v5e"),       # empty DB: every node priced analytically
])
def test_simulate_serve_matches_jax(synthetic, platform):
    jcfg, jscfg, _, jest = _jax_side(synthetic=synthetic, platform=platform)
    tcfg, tscfg, _, test_ = _port_side(synthetic=synthetic, platform=platform)
    jtr, ttr = jax_trace.load_trace(TRACE), port_trace.load_trace(TRACE)
    assert [dataclasses.astuple(r) for r in ttr] == \
        [dataclasses.astuple(r) for r in jtr]
    j = jax_sim.simulate_serve(jtr, jcfg, jscfg, jest)
    t = port_sim.simulate_serve(ttr, tcfg, tscfg, test_)
    assert t.latency == j.latency
    assert t.records == j.records
    assert t.step_log == j.step_log
    assert t.step_durations == j.step_durations
    assert _events(t) == _events(j)
    assert [(n.name, n.kind, n.flops, n.in_bytes, n.meta)
            for n in t.graph.nodes] == \
        [(n.name, n.kind, n.flops, n.in_bytes, n.meta) for n in j.graph.nodes]
    assert test_.stats == jest.stats
    prov = graph_provenance(t.graph)
    assert prov and all(prov.values())


def test_replay_schedule_matches_jax():
    _, jscfg, _, _ = _jax_side()
    _, tscfg, _, _ = _port_side()
    jtr, ttr = jax_trace.load_trace(TRACE), port_trace.load_trace(TRACE)
    # durations of a made-up engine: uneven, so admission depends on them
    n_steps = len(jax_sim.replay_schedule(jtr, jscfg, [1e-3] * 500).step_log)
    durations = [1e-3 * (1 + (i * 7919) % 13) for i in range(n_steps)]
    j = jax_sim.replay_schedule(jtr, jscfg, durations)
    t = port_sim.replay_schedule(ttr, tscfg, durations)
    assert t.latency == j.latency
    assert t.records == j.records
    assert t.step_log == j.step_log


def test_generic_simulator_matches_jax():
    def build(mod):
        g = mod.DataflowGraph("g")
        a = g.add("a", "dot", flops=2e9, in_bytes=1e6)
        b = g.add("b", "fusion", [a.uid], in_bytes=4e6)
        c = g.add("ar", "all-reduce", [a.uid], comm_bytes=8e6, group_size=4,
                  link_kind="ici")
        g.add("d", "dot", [b.uid, c.uid], flops=1e9)
        return g

    dur = lambda n: 1e-6 * (1 + n.uid) + n.flops * 1e-15 + n.comm_bytes * 1e-12
    j = jax_simulator.simulate(build(jax_graph), dur, record_events=True)
    t = port_simulator.simulate(build(port_graph), dur, record_events=True)
    assert t.makespan == j.makespan
    assert t.device_busy == j.device_busy
    assert t.time_by_kind == j.time_by_kind
    assert [dataclasses.astuple(e) for e in t.events] == \
        [dataclasses.astuple(e) for e in j.events]


def test_profile_db_files_are_interchangeable(tmp_path):
    _, _, jdb, _ = _jax_side()
    _, _, tdb, _ = _port_side()
    jp, tp = tmp_path / "jax.json", tmp_path / "port.json"
    jdb.save(str(jp))
    tdb.save(str(tp))
    assert jp.read_bytes() == tp.read_bytes()
    assert port_db.ProfileDB.load(str(jp)).to_json() == tdb.to_json()
    assert jax_db.ProfileDB.load(str(tp)).to_json() == jdb.to_json()


@pytest.mark.parametrize("name,spec", [
    ("NVIDIA H100 80GB HBM3", "h100_sxm"),
    ("NVIDIA H100 SXM5 80GB", "h100_sxm"),
    ("NVIDIA H100 PCIe", None),     # other variants have no spec yet
    ("NVIDIA H100 NVL", None),
])
def test_h100_platform_by_device_name(name, spec):
    if spec is None:
        with pytest.raises(ValueError, match="no platform spec"):
            port_hw.platform_for_device(name)
        return
    p = port_hw.platform_for_device(name)
    assert p.name == spec and p is port_hw.PLATFORMS[spec]


def test_unknown_card_raises_instead_of_guessing():
    with pytest.raises(ValueError, match="no platform spec"):
        port_hw.platform_for_device("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError):
        port_hw.platform_for_device("NVIDIA H100")   # variant unknown


def test_h100_sxm_data_sheet_figures():
    chip = port_hw.H100_SXM.chip
    assert (chip.peak_flops, chip.hbm_bw, chip.hbm_bytes) == \
        (989e12, 3.35e12, 80 * 1000**3)
    # the JAX package's platforms are unchanged in the copy
    for name, p in jax_hw.PLATFORMS.items():
        assert dataclasses.asdict(port_hw.PLATFORMS[name]) == \
            dataclasses.asdict(p)


def test_unported_estimator_stages_raise():
    """Every estimator stage builds and every annotated collective prices:
    the learned stage (tests/test_torch_simtrain.py), the compressed
    all-reduce's int8 payload, and the expert-parallel all-to-all, whose
    duration equals the JAX estimator's on the same node."""
    from repro.core.strategy import moe_a2a_node_meta

    _, _, db, _ = _port_side()
    OpTimeEstimator(port_hw.CPU_HOST, db=db, use_learned=True)
    est = OpTimeEstimator(port_hw.CPU_HOST, db=None, use_learned=False)
    jest = JaxEstimator(jax_hw.CPU_HOST, db=None, use_learned=False)
    g = port_graph.DataflowGraph("g")
    jg = jax_graph.DataflowGraph("g")
    node = g.add("ar", "all-reduce", comm_bytes=1e6, group_size=2,
                 link_kind="ici", meta={"compression": "int8"})
    assert est.duration(node) > 0
    moe = jax_configs.MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                                group_size=32)
    meta = moe_a2a_node_meta(moe, 64, 128, itemsize=2)
    a2a = g.add("a2a", "all-to-all", comm_bytes=1e6, group_size=2,
                link_kind="ici", meta=meta)
    ja2a = jg.add("a2a", "all-to-all", comm_bytes=1e6, group_size=2,
                  link_kind="ici", meta=meta)
    assert est.duration(a2a) > 0
    assert est.duration(a2a) == jest.duration(ja2a)

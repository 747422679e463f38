"""The port's train-step twin against the JAX package's: the offline op
profiler, host calibration, the learned time model and its provenance, the
traced step's dot FLOPs against the parsed HLO's, and the paper's loop
(``launch/sim_accuracy.py``) end to end on the CPU.

Times are never compared across the packages (they are measurements); what
is compared is what the profiler records (families, argument keys, flops,
bytes), what the estimator computes from the same DB, and the graph's
arithmetic.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import database as jax_db  # noqa: E402
from repro.core import estimator as jax_est  # noqa: E402
from repro.core.graph import DataflowGraph as JaxGraph  # noqa: E402
from repro.core.hardware import CPU_HOST as JAX_CPU_HOST  # noqa: E402
from repro.core.hlo_parser import module_summary  # noqa: E402
from repro.core.profiler import OfflineProfiler as JaxProfiler  # noqa: E402
from repro.core.profiler import calibrate_host as jax_calibrate  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_concrete_batch  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import abstract_state as jax_abstract_state  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.core import estimator as port_est  # noqa: E402
from repro_torch.core.database import ProfileDB, ProfileEntry  # noqa: E402
from repro_torch.core.fx_graph import step_summary  # noqa: E402
from repro_torch.core.graph import DataflowGraph  # noqa: E402
from repro_torch.core.hardware import CPU_HOST  # noqa: E402
from repro_torch.core.newop import NewOpProfiler  # noqa: E402
from repro_torch.core.profiler import OfflineProfiler, calibrate_host  # noqa: E402
from repro_torch.launch import sim_accuracy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_with_warmup  # noqa: E402

torch.set_num_threads(2)

SIZES = dict(matmul=[16, 32], vector=[2**10, 2**12])


def _profile(prof):
    prof.profile_matmul(sizes=SIZES["matmul"], values_per_arg=2)
    prof.profile_elementwise(sizes=SIZES["vector"], values_per_arg=2)
    prof.profile_reduction(sizes=SIZES["vector"], values_per_arg=2)
    prof.profile_memory_ops(sizes=SIZES["vector"], values_per_arg=2)
    return prof.db


@pytest.fixture(scope="module")
def dbs():
    jdb = _profile(JaxProfiler(jax_db.ProfileDB(), repeats=2))
    tdb = _profile(OfflineProfiler(ProfileDB(), repeats=2, device="cpu"))
    return jdb, tdb


def _records(db, plat):
    return {fam: sorted((sorted(e.args.items()), e.flops, e.bytes)
                        for e in db.entries(plat, fam))
            for fam in db.op_families(plat)}


def test_offline_profiler_writes_what_the_jax_profiler_writes(dbs):
    jdb, tdb = dbs
    assert tdb.platforms() == jdb.platforms() == ["cpu_host"]
    assert _records(tdb, "cpu_host") == _records(jdb, "cpu_host")
    assert sorted(tdb.meta("cpu_host")) == sorted(jdb.meta("cpu_host"))
    assert tdb.meta("cpu_host")["backend"] == "cpu"
    for e in (e for fam in tdb.op_families("cpu_host")
              for e in tdb.entries("cpu_host", fam)):
        assert e.mean_s > 0 and e.n == 2


def _cross(jdb) -> ProfileDB:
    """The JAX package's DB read by the port (the file format is shared)."""
    tdb = ProfileDB()
    for plat, pdata in jdb.to_json()["platforms"].items():
        tdb.meta(plat).update(pdata["meta"])
        for op, entries in pdata["ops"].items():
            for e in entries:
                tdb.add(plat, op, ProfileEntry.from_json(e))
    return tdb


def test_calibrate_host_matches_jax_on_the_same_db(dbs):
    jdb, _ = dbs
    tdb = _cross(jdb)
    jp, tp = jax_calibrate(jdb), calibrate_host(tdb)
    assert tp.name == jp.name == "cpu_host"
    assert tp.chip.peak_flops == jp.chip.peak_flops
    assert tp.chip.hbm_bw == jp.chip.hbm_bw
    assert tp.ici.latency == jp.ici.latency
    assert tdb.meta("cpu_host") == jdb.meta("cpu_host")


def _jax_initial_weights(hidden=32, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": np.asarray(jax.random.normal(k1, (2, hidden))) * 0.5,
            "b1": np.zeros((hidden,)),
            "w2": np.asarray(jax.random.normal(k2, (hidden, 1))) * 0.5,
            "b2": np.zeros((1,))}


def _points(seed=0, n=40):
    rng = np.random.default_rng(seed)
    flops = 10 ** rng.uniform(3, 10, n)
    nbytes = 10 ** rng.uniform(3, 9, n)
    t = (2e-6 + flops / 5e10 + nbytes / 1e10) * np.exp(
        0.05 * rng.standard_normal(n))
    return list(zip(flops, nbytes, t))


QUERIES = [(1e4, 1e4), (1e6, 3e5), (2e8, 1e7), (5e9, 4e8), (0.0, 1e6)]
# both fits run 800 full-batch Adam steps in fp32 from the same weights;
# the packages' fp32 arithmetic differs in the last bits
LEARNED_RTOL = 1e-3


@pytest.mark.parametrize("seed", [0, 5])
def test_fit_time_model_from_jax_initial_weights_matches(seed):
    pts = _points(seed)
    jm = jax_est.fit_time_model(pts, seed=seed)
    tm = port_est.fit_time_model(pts, init=_jax_initial_weights(32, seed))
    for f, b in QUERIES:
        assert tm.predict(f, b) == pytest.approx(jm.predict(f, b),
                                                 rel=LEARNED_RTOL)
    assert port_est.fit_time_model(pts[:7]) is None


def test_fit_time_model_default_init_is_numpy_seeded():
    w = port_est.initial_weights(32, 3)
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(w["w1"], rng.standard_normal((2, 32)) * 0.5)
    a = port_est.fit_time_model(_points(1), seed=3)
    b = port_est.fit_time_model(_points(1), seed=3)
    assert a.predict(1e6, 1e6) == b.predict(1e6, 1e6)


def _nodes(g):
    g.add("p", "parameter")
    g.add("mm", "dot", deps=[0], flops=2e8, in_bytes=3e6, out_bytes=1e6)
    g.add("ew", "fusion:kLoop", deps=[1], flops=1e6, in_bytes=8e6,
          out_bytes=4e6)
    g.add("ew2", "elementwise", deps=[2], flops=1e6, in_bytes=8e6,
          out_bytes=4e6)
    g.add("red", "reduce", deps=[3], flops=1e6, in_bytes=4e6, out_bytes=4e3)
    g.add("hit", "dot", deps=[4], flops=2.0 * 16 * 16 * 32,
          in_bytes=4.0 * (16 * 16 + 16 * 32), out_bytes=4.0 * 16 * 32,
          meta={"db_args": {"m": 16, "k": 16, "n": 32}})
    g.add("free", "view", deps=[5])
    return g


def test_learned_estimator_prices_and_provenance_match_jax(dbs, monkeypatch):
    jdb, _ = dbs
    tdb = _cross(jdb)
    monkeypatch.setattr(port_est, "initial_weights", _jax_initial_weights)
    jest = jax_est.OpTimeEstimator(JAX_CPU_HOST, jdb)
    test = port_est.OpTimeEstimator(CPU_HOST, tdb)
    assert sorted(test.models) == sorted(jest.models)
    jg, tg = _nodes(JaxGraph()), _nodes(DataflowGraph())
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert test.duration(tn) == pytest.approx(jest.duration(jn),
                                                  rel=LEARNED_RTOL)
    assert test.stats == jest.stats
    # the reduce family has too few points for a model here: analytic
    assert (test.stats["db"], test.stats["learned"],
            test.stats["analytic"]) == (1, 3, 1)


def _summary_pair(batch, seq):
    def cfg(m):
        return dataclasses.replace(
            m.smoke_variant(m.get_config("mamba2-2.7b")), remat_policy="none",
            num_layers=2)

    jcfg = cfg(jax_configs)
    jmodel, opt = jax_build_model(jcfg), jax_adamw()
    step = jax_make_train_step(jmodel, opt, jax_cosine(1e-3, 10, 1000))
    state, _ = jax_abstract_state(jmodel, opt)     # shapes: nothing to init
    data = make_concrete_batch(jcfg, jax_configs.ShapeConfig("t", seq, batch,
                                                             "train"))
    js = module_summary(jax.jit(step).lower(state, data).compile().as_text())
    ts = step_summary(build_model(cfg(port_configs)), adamw(),
                      cosine_with_warmup(1e-3, 10, 1000), batch=batch,
                      seq=seq, device="cpu")
    return jcfg, js, ts


def test_traced_step_dot_flops_equal_the_parsed_hlo():
    b, s = 2, 32
    cfg, js, ts = _summary_pair(b, s)
    jax_dots = sum(n.flops for n in js["graph"].nodes if n.kind == "dot")
    # The one contraction XLA rewrites: the loss's per-chunk checkpoint
    # recomputes the head logits in the backward pass, and with one loss
    # chunk XLA merges that recomputation with the forward's (CSE).  The
    # port runs it, so it has one head contraction per loss chunk more.
    chunks = s // min(cfg.loss_chunk, s)
    head = chunks * 2.0 * b * min(cfg.loss_chunk, s) * cfg.d_model \
        * cfg.vocab_size
    assert ts["dot_flops"] == pytest.approx(jax_dots + head, rel=1e-6)
    # the SSD scan is one node per launch (its plain einsums run only in
    # the backward's VJP), and so is every RMSNorm
    calls = [n.meta["kernel"] for n in ts["graph"].nodes
             if n.kind == "custom-call"]
    assert calls.count("ssd_scan") == cfg.num_layers
    assert calls.count("rmsnorm") == cfg.num_layers + 1
    dots = [n for n in ts["graph"].nodes if n.kind == "dot"]
    assert all(set(n.meta["dot"]) >= {"lhs", "rhs", "lc", "rc", "lb", "rb",
                                      "dtype"} for n in dots)


def test_newop_profiler_times_real_contractions_and_kernels():
    cfg = dataclasses.replace(
        port_configs.smoke_variant(port_configs.get_config("mamba2-2.7b")),
        num_layers=1)
    ts = step_summary(build_model(cfg), adamw(),
                      cosine_with_warmup(1e-3, 10, 1000), batch=1, seq=16,
                      device="cpu")
    db = ProfileDB()
    newop = NewOpProfiler(db, "cpu_host", repeats=1, device="cpu")
    pick = [next(n for n in ts["graph"].nodes if n.kind == "dot"),
            next(n for n in ts["graph"].nodes
                 if n.meta.get("kernel") == "ssd_scan")]
    for n in pick:
        assert newop.try_profile(n) > 0
        key = {"flops": int(n.flops), "bytes": int(n.bytes_accessed)}
        assert db.lookup("cpu_host", n.kind, key) is not None
    assert newop.profiled == ["dot", "custom-call"]


def test_profile_grids_extend_the_jax_grids_to_the_step():
    g = DataflowGraph()
    g.add("p", "parameter")
    g.add("small", "dot", deps=[0], flops=2.0 * 512 ** 3,
          in_bytes=8.0 * 512 ** 2, out_bytes=4.0 * 512 ** 2)
    g.add("ew", "elementwise", deps=[1], flops=1e6, in_bytes=8e6,
          out_bytes=4e6)
    # within the JAX benchmark's grids: they stay as they are
    mm, vec = sim_accuracy.profile_grids(g, 4)
    assert mm == list(sim_accuracy.MATMUL_SIZES)
    assert vec == list(sim_accuracy.VECTOR_SIZES)
    # a contraction of 4096 x 2560 x 10240 and an elementwise op of 600 MB:
    # the sides double to the first cube with as many flops, the vectors
    # quadruple to the first binary op that moves as many bytes
    g.add("big", "dot", deps=[2], flops=2.0 * 4096 * 2560 * 10240,
          in_bytes=2.0 * (4096 * 2560 + 2560 * 10240),
          out_bytes=2.0 * 4096 * 10240)
    g.add("wide", "elementwise", deps=[3], flops=5e7, in_bytes=4e8,
          out_bytes=2e8)
    mm, vec = sim_accuracy.profile_grids(g, 4)
    assert mm == list(sim_accuracy.MATMUL_SIZES) + [4096, 8192]
    assert vec == list(sim_accuracy.VECTOR_SIZES) + [2 ** 26]
    assert 2.0 * 8192 ** 3 >= g.nodes[3].flops > 2.0 * 4096 ** 3
    big = sim_accuracy.largest_ops(g)
    assert big["dot_flops"] == big["dot_bytes"] == (
        None, g.nodes[3].flops, g.nodes[3].bytes_accessed)
    assert big["other_bytes"] == (None, 5e7, 6e8)
    assert 3.0 * 2 ** 26 * 4 >= g.nodes[4].bytes_accessed > 3.0 * 2 ** 24 * 4


def test_sim_accuracy_runs_end_to_end_on_the_cpu(monkeypatch):
    # small starting grids and few refined signatures keep the CPU run
    # short; the grids still grow to the step's sizes
    monkeypatch.setattr(sim_accuracy, "MATMUL_SIZES", (32, 64))
    monkeypatch.setattr(sim_accuracy, "VECTOR_SIZES", (2**10, 2**12))
    monkeypatch.setattr(sim_accuracy, "REFINE_TOP", 4)
    cfg = dataclasses.replace(sim_accuracy.smoke_config("mamba2-2.7b"),
                              num_layers=2)
    row = sim_accuracy.run(cfg, seq=32, batch=2, steps=5, profile_repeats=1,
                           device="cpu", log_fn=lambda _: None)
    assert row["name"] == "table2_ssm_mamba2"
    assert row["platform"] == "cpu_host"
    assert row["measured_s"] > 0
    # the median of five steps timed one by one, beside their spread; the
    # errors are against the median; no card, so no events or busy time
    assert len(row["measured_steps_s"]) == 5
    assert row["measured_s"] == np.median(row["measured_steps_s"])
    assert row["measured_min_s"] <= row["measured_s"] <= row["measured_max_s"]
    assert row["measured_min_s"] == min(row["measured_steps_s"])
    assert row["measured_max_s"] == max(row["measured_steps_s"])
    assert row["err_offline"] == pytest.approx(
        abs(row["sim_offline_s"] - row["measured_s"]) / row["measured_s"])
    assert row["busy_s"] is None and row["measured_event_s"] is None
    assert np.isfinite([row["err_offline"], row["err_refined"]]).all()
    assert row["refined_signatures"] == 4
    assert row["provenance_offline"]["learned"] > 0
    assert row["provenance_refined"]["db"] > row["provenance_offline"]["db"]
    assert row["graph_kinds"]["custom-call"] == 2 + 3   # SSD, RMSNorm
    assert row["graph_kernel_nodes"] == {"ssd_scan": 2, "rmsnorm": 3,
                                         "flash_attention": 0,
                                         "flash_attention_bwd": 0}
    # the head's contraction (64 x 256 x 2048) needs sides up to 512
    assert row["matmul_sizes"] == [32, 64, 128, 256, 512]
    assert row["vector_sizes"][:2] == [2**10, 2**12]
    # the CPU step runs the plain versions: no kernel launches
    assert row["kernel_launches_per_step"] == {"ssd_scan": 0, "rmsnorm": 0,
                                               "flash_attention": 0,
                                               "flash_attention_bwd": 0}


def test_sim_accuracy_needs_five_timed_steps():
    cfg = sim_accuracy.smoke_config("mamba2-2.7b")
    with pytest.raises(ValueError, match="at least 5"):
        sim_accuracy.run(cfg, seq=32, batch=2, steps=4, device="cpu")


def test_busy_seconds_is_the_union_of_device_intervals():
    """Overlapping and nested kernels count once, gaps not at all; named
    ranges (spans over kernels) and host events are left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, lo, hi, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=lo, end=hi))

    events = [ev("gemm", 0, 10), ev("add", 5, 15), ev("cast", 6, 7),
              ev("copy", 30, 40), ev("train_step.forward", 0, 100),
              ev("repro_torch::flash_attention.backward", 0, 100),
              ev("annotated", 0, 100, annotation=True),
              ev("aten::mm", 0, 100, device=DeviceType.CPU)]
    assert sim_accuracy.busy_seconds(events) == pytest.approx(25e-6)
    assert sim_accuracy.busy_seconds([]) == 0.0

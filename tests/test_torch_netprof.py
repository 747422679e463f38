"""The port's interconnect profiling (``repro_torch.netprof``: the sweep, its
report, the calibration CLI) and ``--netprof-db`` against the JAX
package's.

The copied parts equal the reference's: ``mesh_plans``, the payload a
point records, the synthetic α–β and contention DBs, and the
measured-vs-ring report on one DB.  ``psum_scatter`` over a mesh of
logical ranks equals ``jax.lax.psum_scatter(..., tiled=True)``.  A smoke
sweep on 4 logical CPU ranks records exactly the keys the reference's grid
enumerates, and a failing collective raises (the reference skips the
point).  The train launcher's ``netprof_estimator`` prices a graph to the
same seconds and provenance as the reference's from the same DB file, and
``python -m repro_torch.netprof.calibrate --verify`` passes on a synthetic
DB and on a CPU sweep.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import database as jax_db  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.launch import train as jax_launcher  # noqa: E402
from repro.netprof import pricing as jax_pricing  # noqa: E402
from repro.netprof import report as jax_report  # noqa: E402
from repro.netprof import sweep as jax_sweep  # noqa: E402
from repro_torch.core import database as port_db  # noqa: E402
from repro_torch.core import hardware as port_hw  # noqa: E402
from repro_torch.core import simulator as port_sim  # noqa: E402
from repro_torch.core.profiler import OfflineProfiler  # noqa: E402
from repro_torch.dist import mesh as M  # noqa: E402
from repro_torch.launch import train as port_launcher  # noqa: E402
from repro_torch.netprof import calibrate  # noqa: E402
from repro_torch.netprof import pricing as port_pricing  # noqa: E402
from repro_torch.netprof import report as port_report  # noqa: E402
from repro_torch.netprof import sweep as port_sweep  # noqa: E402
from repro_torch.netprof.model import (  # noqa: E402
    COLLECTIVES,
    fit_collective_models,
    fit_link_contention,
)

torch.set_num_threads(2)


def _jax_keys(config, ndev: int) -> set:
    """Every (kind, args) key the reference's sweep grid enumerates on
    ``ndev`` devices: its plans, axes, dtypes, payloads and kinds."""
    keys = set()
    for plan in jax_sweep.mesh_plans(ndev, config.subgroup_meshes):
        for axis in plan.sweep_axes:
            g = plan.shape[plan.names.index(axis)]
            for dt in config.dtypes:
                for b in config.payload_bytes:
                    for kind in config.collectives:
                        rec = jax_sweep.recorded_payload(
                            kind, b, g, jax_sweep._DTYPES[dt])
                        keys.add((kind, json.dumps(
                            {"per_device_bytes": rec, "devices": g,
                             "dtype": dt, "axis": plan.tag(axis)},
                            sort_keys=True)))
    return keys


def _port_keys(db, platform) -> set:
    return {(kind, json.dumps(e.args, sort_keys=True))
            for kind in COLLECTIVES for e in db.entries(platform, kind)}


# -- the copied parts -----------------------------------------------------------


def test_mesh_plans_equal_reference():
    for ndev in range(0, 33):
        for sub in (True, False):
            assert port_sweep.mesh_plans(ndev, sub) == [
                port_sweep.MeshPlan(p.shape, p.names, p.sweep_axes)
                for p in jax_sweep.mesh_plans(ndev, sub)]
    flat, sub = port_sweep.mesh_plans(4)
    assert (flat.shape, sub.shape, sub.tag("dp")) == ((4,), (2, 2), "dp@2x2")


def test_recorded_payload_equals_reference():
    for kind in COLLECTIVES:
        for b in (1, 3, 1000, 4096, 10_000, 2**22 + 1):
            for g in (1, 2, 3, 4, 8):
                for item in (1, 2, 4):
                    assert port_sweep.recorded_payload(kind, b, g, item) == \
                        jax_sweep.recorded_payload(kind, b, g, item)
                    assert port_sweep._shard_elems(b, g, item) == \
                        jax_sweep._shard_elems(b, g, item)
    assert port_sweep.SweepConfig.smoke() == port_sweep.SweepConfig(
        **vars(jax_sweep.SweepConfig.smoke()))


@pytest.mark.parametrize("which", ["alpha_beta", "contention"])
def test_synthetic_dbs_equal_reference(which):
    name = ("synthetic_calibration" if which == "alpha_beta"
            else "synthetic_contention_calibration")
    j, t = jax_db.ProfileDB(), port_db.ProfileDB()
    nj = getattr(jax_sweep, name)(j, "cpu_host")
    nt = getattr(port_sweep, name)(t, "cpu_host")
    assert nt == nj and t.to_json() == j.to_json()


@pytest.mark.parametrize("platform", ["cpu_host", "tpu_v5e"])
def test_measured_vs_ring_lines_equal_reference(platform):
    j, t = jax_db.ProfileDB(), port_db.ProfileDB()
    jax_sweep.synthetic_calibration(j, platform)
    port_sweep.synthetic_calibration(t, platform)
    jr = jax_report.measured_vs_ring(jax_report.acceptance_graph(), j,
                                     jax_hw.PLATFORMS[platform])
    tr = port_report.measured_vs_ring(port_report.acceptance_graph(), t,
                                      port_hw.PLATFORMS[platform])
    assert tr.lines() == jr.lines()
    assert tr.provenance == jr.provenance and tr.ring_fallbacks == 0
    assert tr.measured_makespan_s == pytest.approx(jr.measured_makespan_s,
                                                   rel=1e-12)


# -- psum_scatter ---------------------------------------------------------------


@pytest.mark.parametrize("shape,dim", [((8,), -1), ((3, 12), -1),
                                       ((3, 12), 1), ((8, 5), 0)])
@pytest.mark.parametrize("n", [2, 4])
def test_psum_scatter_equals_jax(shape, dim, n):
    x = np.random.default_rng(n).standard_normal((n,) + shape).astype(
        np.float32)
    want = jax.vmap(lambda v: jax.lax.psum_scatter(
        v, "i", scatter_dimension=dim % len(shape), tiled=True),
        axis_name="i")(x)
    mesh = M.make_mesh((n,), ("x",), "cpu")
    M.reset_traffic()
    got = mesh.psum_scatter({(r,): torch.tensor(x[r]) for r in range(n)},
                            "x", dim)
    for r in range(n):
        np.testing.assert_allclose(got[(r,)].numpy(), np.asarray(want[r]),
                                   rtol=1e-6, atol=1e-6)
    assert M.TRAFFIC == {"psum_scatter": n * x[0].nbytes}
    with pytest.raises(ValueError, match="does not split"):
        mesh.psum_scatter({(r,): torch.zeros(n + 1) for r in range(n)}, "x")


def test_psum_scatter_over_a_sub_axis_sums_each_group():
    mesh = M.make_mesh((2, 2), ("dp", "pp"), "cpu")
    vals = {c: torch.full((4,), float(mesh.flat(c) + 1))
            for c in mesh.coords()}
    out = mesh.psum_scatter(vals, "dp")
    # the dp groups are {(0, p), (1, p)}: flat ranks p and 2 + p
    for (d, p), t in out.items():
        assert t.tolist() == [float(p + 1 + p + 3)] * 2


# -- the sweep on logical CPU ranks ---------------------------------------------


def test_smoke_sweep_records_the_reference_grid():
    db = port_db.ProfileDB()
    cfg = port_sweep.SweepConfig(payload_bytes=(2**10, 2**13),
                                 dtypes=("float32", "bfloat16", "int8"),
                                 repeats=2)
    n = port_sweep.sweep_collectives(db, config=cfg, ranks=4, device="cpu")
    want = _jax_keys(jax_sweep.SweepConfig(
        payload_bytes=cfg.payload_bytes, dtypes=cfg.dtypes, repeats=2), 4)
    assert _port_keys(db, "cpu_host") == want and n == len(want) == 90
    meta = db.meta("cpu_host")["netprof"]
    assert meta["backend"] == "cpu" and meta["ranks"] == 4
    assert meta["device_count"] == 1 and meta["groups"] == [2, 4]
    assert meta["entries"] == n
    assert db.meta("cpu_host")["library"] == f"torch-{torch.__version__}"
    models = fit_collective_models(db, "cpu_host")
    assert sorted(models) == sorted(COLLECTIVES)
    assert all(models[k].groups == [2, 4] for k in COLLECTIVES)
    est = port_launcher.OpTimeEstimator(port_hw.CPU_HOST, db)
    from repro_torch.core.graph import OpNode

    node = OpNode(0, "ar", "all-reduce", comm_bytes=3000, group_size=2,
                  link_kind="ici")
    assert est.duration(node) > 0
    assert node.meta["time_provenance"] == port_pricing.PROV_FIT


def test_concurrent_sweep_fits_link_contention():
    db = port_db.ProfileDB()
    n = port_sweep.sweep_concurrent(db, config=port_sweep.SweepConfig.smoke(),
                                    ranks=4, device="cpu")
    assert n == 2 * len(COLLECTIVES) * 3
    assert db.meta("cpu_host")["netprof"]["contention_entries"] == n
    assert fit_link_contention(db, "cpu_host") is not None


def test_a_failing_collective_raises(monkeypatch):
    """No hidden skip: the reference drops a point whose collective fails
    (``except Exception: return None``); the port raises."""
    def broken(self, values, axis, scatter_dimension=-1):
        raise RuntimeError("reduce-scatter failed")

    monkeypatch.setattr(M.Mesh, "psum_scatter", broken)
    db = port_db.ProfileDB()
    with pytest.raises(RuntimeError, match="reduce-scatter failed"):
        port_sweep.sweep_collectives(db, config=port_sweep.SweepConfig.smoke(),
                                     ranks=4, device="cpu")
    with pytest.raises(ValueError, match="2 or more ranks"):
        port_sweep.sweep_collectives(db, ranks=1, device="cpu")


def test_offline_profiler_collectives_on_logical_ranks():
    db = port_db.ProfileDB()
    prof = OfflineProfiler(db, device="cpu", repeats=2)
    # ranks default to the visible devices: one CPU, so nothing, as the
    # reference records nothing on one device
    assert prof.profile_collectives() == 0
    n = prof.profile_collectives(sizes=[2**12, 2**16], ranks=4)
    assert n == 6
    gathers = db.entries("cpu_host", "all-gather")
    assert sorted(e.args["per_device_bytes"] for e in gathers) == \
        [2**12, 2**16]      # all-gather records its output bytes
    reduces = db.entries("cpu_host", "all-reduce")
    assert sorted(e.args["per_device_bytes"] for e in reduces) == \
        [2**10, 2**14]
    assert all(e.args["devices"] == 4 for e in gathers + reduces)


# -- --netprof-db and the calibration CLI ----------------------------------------


def _synthetic_db_file(path) -> str:
    db = jax_db.ProfileDB()
    jax_sweep.synthetic_calibration(db, "cpu_host")
    db.save(str(path))
    return str(path)


def test_netprof_estimator_prices_like_the_reference(tmp_path):
    path = _synthetic_db_file(tmp_path / "db.json")
    jlog, tlog = [], []
    jest, jplat = jax_launcher.netprof_estimator(path, log_fn=jlog.append)
    test, tplat = port_launcher.netprof_estimator(path, log_fn=tlog.append)
    assert (tplat.name, tplat.chip.peak_flops, tplat.chip.hbm_bw) == \
        (jplat.name, jplat.chip.peak_flops, jplat.chip.hbm_bw)
    assert tlog[0].startswith(jlog[0])   # the port adds the rank count
    # memoized: one estimator and one banner a launch
    assert port_launcher.netprof_estimator(path, log_fn=tlog.append)[0] \
        is test and len(tlog) == 1
    jg, tg = jax_report.acceptance_graph(), port_report.acceptance_graph()
    jr = jax_sim.simulate(jg, jest.duration)
    tr = port_sim.simulate(tg, test.duration)
    assert tr.makespan == pytest.approx(jr.makespan, rel=1e-12)
    assert port_pricing.graph_provenance(tg) == \
        jax_pricing.graph_provenance(jg)
    for jn, tn in zip(jg.nodes, tg.nodes):
        assert tn.name == jn.name
        if tn.is_collective:
            assert test.duration(tn) == pytest.approx(jest.duration(jn),
                                                      rel=1e-12)


def test_calibrate_verify(tmp_path, capsys):
    path = _synthetic_db_file(tmp_path / "db.json")
    assert calibrate.main(["--db", path, "--verify"]) == 0
    out = capsys.readouterr().out
    assert "[netprof] OK: all 26 collective nodes priced" in out
    empty = tmp_path / "empty.json"
    port_db.ProfileDB().save(str(empty))
    assert calibrate.main(["--db", str(empty), "--verify"]) == 1
    assert "no netprof calibration" in capsys.readouterr().out


def test_calibrate_sweeps_logical_cpu_ranks_then_verifies(tmp_path, capsys):
    path = str(tmp_path / "db.json")
    assert calibrate.main(["--db", path, "--device", "cpu", "--smoke",
                           "--concurrent"]) == 0
    out = capsys.readouterr().out
    assert "[netprof] recorded 45 measurements" in out
    assert "link-contention[cpu_host]" in out
    assert calibrate.main(["--db", path, "--verify"]) == 0
    assert "backend=cpu devices=1 ranks=4" in capsys.readouterr().out
    assert calibrate.main(["--db", path, "--device", "cpu", "--ranks",
                           "1"]) == 1

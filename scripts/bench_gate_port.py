"""The port's benchmark-regression gate (``scripts/check_port.sh bench``).

The counterpart of ``scripts/bench_gate.py`` over ``src/repro_torch``: the
same 54 metrics of ``benchmarks/baselines/bench_baseline.json``, recomputed
through the port, each held to the baseline within its own band.

  * the deterministic rows (copies of ``benchmarks/bench_sim_accuracy.py``'s
    ``schedule_rows``, ``serve_rows``, ``coverage_rows``, ``overlap_rows``,
    ``bench_pipeline_models.py``'s ``plan_rows`` and ``bench_comm.py``'s
    ``deterministic_rows``, imports rewritten onto ``repro_torch``): schedule
    ticks, the serve twin on the committed acceptance trace, the coverage
    audit, the overlap and contention pins, the pipeline byte twins and the
    netprof fit recovery;
  * the executor rows (``pipe_exec_loss``, ``pipe_exec_grad_rel_err``): the
    tiny 4-layer llama through the scheduled pipeline executor on a 1-rank
    mesh of ``--device``, against autograd of the unpipelined reference.
    The baseline's loss is the loss of the JAX package's ``PRNGKey(0)``
    parameters, so the gate builds them there (:func:`jax_params`, its only
    use of the JAX package) and carries them across with
    ``load_jax_params``.  On a card the step must launch the flash-attention
    and RMSNorm kernels.

    python scripts/bench_gate_port.py                  # on the card
    python scripts/bench_gate_port.py --device cpu     # the plain versions
    python scripts/bench_gate_port.py --smoke          # no executor rows,
                                                       # no JAX

Exit code 1 on a metric out of its band, or pinned in the baseline but not
produced (``--smoke`` reports the two executor rows as skipped).  A metric
the baseline lacks is reported and does not fail.  The baseline is the JAX
package's: this gate reads it and never writes it.  The report (default
``BENCH_port.json``) holds the metrics and the drift table; on failure the
table is printed aligned.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEFAULT_BASELINE = os.path.join(
    REPO, "benchmarks", "baselines", "bench_baseline.json"
)
DEFAULT_OUT = os.path.join(REPO, "BENCH_port.json")
SERVE_TRACE = os.path.join(REPO, "benchmarks", "traces",
                           "serve_acceptance.json")
# the executor rows' batch (sequence, global batch) and its microbatches
EXEC_SEQ, EXEC_BATCH, EXEC_MICROBATCHES = 16, 4, 2


# -- benchmarks/bench_sim_accuracy.py ---------------------------------------


def schedule_rows() -> list[dict]:
    """Schedule-layer accuracy: DES vs tick-table twin vs analytic form.
    Raises on a mismatch between the DES and the schedule's own ticks."""
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategy import LayerCost, Strategy, pipeline_graph
    from repro_torch.dist.schedules import make_schedule

    rows = []
    for name, S, M, v in (
        ("gpipe", 4, 8, 1),
        ("1f1b", 4, 8, 1),
        ("interleaved_1f1b", 4, 8, 2),
    ):
        sch = make_schedule(name, S, M, v)
        strategy = Strategy(pp=S, microbatches=M, schedule=name, vstages=v)
        g = pipeline_graph(
            S * v,
            LayerCost(fwd_flops=1.0, fwd_bytes=0.0, bwd_multiplier=1.0),
            strategy,
        )
        res = simulate(g, lambda n: 1.0 if n.kind in ("fwd", "bwd") else 0.0)
        ticks = sch.total_ticks()
        analytic = 2 * M * v + 2 * (S - 1)
        err_twin = abs(res.makespan - ticks) / ticks
        err_analytic = abs(res.makespan - analytic) / analytic
        bubble = res.makespan - max(
            t for d, t in res.device_busy.items() if d.startswith("stage")
        )
        if err_twin > 1e-9 or bubble != sch.bubble_ticks(0):
            raise AssertionError(
                f"schedule accuracy regression: {name} sim {res.makespan} "
                f"vs twin {ticks} (bubble {bubble} vs {sch.bubble_ticks(0)})"
            )
        rows.append(
            {
                "name": f"schedule_{name}",
                "us_per_call": res.makespan,
                "derived": (
                    f"ticks={ticks};analytic={analytic};"
                    f"err_twin={err_twin * 100:.2f}%;"
                    f"err_analytic={err_analytic * 100:.2f}%;"
                    f"bubble_ticks={bubble:.0f}"
                ),
            }
        )
    return rows


def serve_rows() -> list[dict]:
    """Serving-twin pins: the committed acceptance trace priced from the
    synthetic serve grid (deterministic: zero tolerance)."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.hardware import CPU_HOST
    from repro_torch.serve.cost import synthetic_serve_calibration
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.serve.sim import simulate_serve
    from repro_torch.serve.trace import load_trace

    cfg = smoke_variant(get_config("llama3.2-1b"))
    scfg = ServeConfig(slots=2, max_len=64, block_size=8, chunk=8)
    db = ProfileDB()
    synthetic_serve_calibration(
        db, cfg.name, "cpu_host", views=(scfg.view_len,), slot_grid=(1, 2, 4)
    )
    est = OpTimeEstimator(CPU_HOST, db=db, use_learned=False)
    trace = load_trace(SERVE_TRACE)
    res = simulate_serve(trace, cfg, scfg, est, name="serve-bench")
    lat = res.latency
    derived = f"requests={lat['requests']};tokens={lat['total_tokens']}"
    return [
        {"name": "serve_sim_steps", "value": float(len(res.step_log)),
         "tol_rel": 0.0, "tol_abs": 0.0, "derived": derived},
        {"name": "serve_sim_makespan_us", "value": lat["makespan_s"] * 1e6,
         "tol_rel": 0.0, "tol_abs": 0.0, "derived": derived},
        {"name": "serve_sim_ttft_p50_us", "value": lat["ttft_p50_s"] * 1e6,
         "tol_rel": 0.0, "tol_abs": 0.0, "derived": derived},
        {"name": "serve_sim_per_token_p99_us",
         "value": lat["per_token_p99_s"] * 1e6,
         "tol_rel": 0.0, "tol_abs": 0.0, "derived": derived},
        {"name": "serve_sim_e2e_p99_us", "value": lat["e2e_p99_s"] * 1e6,
         "tol_rel": 0.0, "tol_abs": 0.0, "derived": derived},
    ]


def coverage_rows() -> list[dict]:
    """Coverage-auditor pins: the acceptance trace's pricing queries against
    a full synthetic serve grid and a gapped one (decode slots off-grid)."""
    from repro_torch.analysis.coverage import audit_serve_coverage
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.database import ProfileDB
    from repro_torch.serve.cost import synthetic_serve_calibration
    from repro_torch.serve.policy import ServeConfig
    from repro_torch.serve.trace import load_trace

    cfg = smoke_variant(get_config("llama3.2-1b"))
    scfg = ServeConfig(slots=2, max_len=64, block_size=8, chunk=8)
    trace = load_trace(SERVE_TRACE)
    rows = []
    for tag, slot_grid in (("full", (1, 2, 4)), ("gapped", (1, 4))):
        db = ProfileDB()
        synthetic_serve_calibration(
            db, cfg.name, "cpu_host", views=(scfg.view_len,),
            slot_grid=slot_grid,
        )
        cov = audit_serve_coverage(trace, cfg.name, scfg, db)
        m = cov.report.metrics
        derived = (
            f"grid_rows={len(cov.grid)};"
            f"slot_grid={'/'.join(str(s) for s in slot_grid)}"
        )
        for metric in (
            "coverage_queries",
            "coverage_exact",
            "coverage_interpolation",
            "coverage_serve_prefill_exact_ratio",
            "coverage_serve_decode_exact_ratio",
        ):
            rows.append(
                {"name": f"serve_cov_{tag}_{metric[len('coverage_'):]}",
                 "value": float(m[metric]),
                 "tol_rel": 0.0, "tol_abs": 0.0, "derived": derived}
            )
    return rows


def overlap_rows() -> list[dict]:
    """Overlap and contention pins: the bucketed gradient all-reduce's DES
    speedup over the monolithic one, and a two-stream concurrent collective
    priced serialized and with the contention model fitted back from its
    synthetic calibration."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.autotuner import layer_cost_from_config
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.estimator import OpTimeEstimator
    from repro_torch.core.graph import DataflowGraph
    from repro_torch.core.hardware import TPU_V5E
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategy import Strategy, pipeline_graph
    from repro_torch.netprof.model import fit_link_contention
    from repro_torch.netprof.sweep import synthetic_contention_calibration

    rows = []
    cfg = get_config("llama3.2-1b")
    cost = layer_cost_from_config(cfg, 1, 256, 1)
    est = OpTimeEstimator(TPU_V5E)

    def makespan(ob: int) -> float:
        g = pipeline_graph(
            cfg.num_layers, cost,
            Strategy(dp=4, pp=2, vstages=4, schedule="interleaved_1f1b",
                     microbatches=4, compression="int8", overlap_buckets=ob),
        )
        return simulate(g, est.duration).makespan

    mono, bucketed = makespan(0), makespan(4)
    rows.append(
        {"name": "overlap_bucketed_speedup", "value": mono / bucketed,
         "tol_rel": 0.0, "tol_abs": 0.0,
         "derived": (f"mono_us={mono * 1e6:.1f};"
                     f"bucketed_us={bucketed * 1e6:.1f};buckets=4")}
    )

    c_true, t1 = 0.6, 1e-3
    db = ProfileDB()
    synthetic_contention_calibration(db, "tpu_v5e", c=c_true)
    cm = fit_link_contention(db, "tpu_v5e")
    g = DataflowGraph()
    g.add("arA", "all-reduce", device="link:dp0")
    g.add("arB", "all-reduce", device="link:dp1")
    truth = t1 * (1.0 + c_true)
    ser = simulate(g, lambda n: t1).makespan
    con = simulate(g, lambda n: t1, contention=cm).makespan
    derived = f"truth_us={truth * 1e6:.1f};c={cm.c:.3f}"
    rows += [
        {"name": "overlap_sim_err_serialized_us",
         "value": abs(ser - truth) * 1e6,
         # the serialized miss is exactly t1*c modulo fit rounding
         "tol_rel": 0.0, "tol_abs": 0.5, "derived": derived},
        {"name": "overlap_sim_err_contention_us",
         "value": abs(con - truth) * 1e6,
         "tol_rel": 0.0, "tol_abs": 0.5, "derived": derived},
    ]
    return rows


# -- benchmarks/bench_pipeline_models.py ------------------------------------


def _tiny(name: str, num_layers: int = 8, configs=None, **kw):
    """The benchmark's tiny config of ``name``; ``configs`` is the port's
    ``configs.base`` unless another package's is given (:func:`jax_params`
    passes the JAX package's)."""
    if configs is None:
        from repro_torch.configs import base as configs

    cfg = configs.smoke_variant(configs.get_config(name))
    changes = {
        "num_layers": num_layers, "d_model": 64, "num_heads": 2,
        "num_kv_heads": 2, "head_dim": 32,
        "d_ff": 128 if cfg.d_ff else 0, "vocab_size": 256,
    }
    changes.update(kw)
    return dataclasses.replace(cfg, **changes)


def plan_rows() -> list[dict]:
    """Schedule/byte-twin metrics of real-model pipeline plans; asserts the
    simulated boundary bytes equal the plan's own twin."""
    from repro_torch.core.estimator import dist_comm_bytes
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategy import model_pipeline_graph
    from repro_torch.dist.compress import compressed_psum_bytes
    from repro_torch.models import build_model
    from repro_torch.models.pipeline import make_plan, stage_param_trees

    micro_batch, seq = 2, 16
    rows = []
    cases = [
        ("dense", _tiny("llama3.2-1b"), "1f1b", 4, 8, 1),
        ("dense", _tiny("llama3.2-1b"), "interleaved_1f1b", 4, 8, 2),
        ("moe", _tiny("qwen3-moe-235b-a22b"), "gpipe", 4, 8, 1),
    ]
    for fam, cfg, sched_name, S, M, v in cases:
        plan = make_plan(cfg, S, M, schedule=sched_name, vstages=v)
        tag = f"pipe_{fam}_{sched_name}"
        g = model_pipeline_graph(cfg, plan.strategy(), micro_batch, seq)
        res = simulate(
            g, lambda n: 1.0 if n.kind in ("fwd", "bwd") else 0.0
        )
        sch = plan.make_schedule()
        assert res.makespan == sch.total_ticks(), (tag, res.makespan)
        rows.append({
            "name": f"{tag}_ticks", "value": float(res.makespan),
            "tol_rel": 0.0, "tol_abs": 0.0,
        })
        rows.append({
            "name": f"{tag}_bubble_ticks",
            "value": float(sch.bubble_ticks(0)),
            "tol_rel": 0.0, "tol_abs": 0.0,
        })
        sim_bytes = sum(
            dist_comm_bytes(n) for n in g.nodes
            if n.kind == "collective-permute"
        )
        assert sim_bytes == plan.boundary_bytes_per_step(micro_batch, seq)
        rows.append({
            "name": f"{tag}_boundary_bytes", "value": float(sim_bytes),
            "tol_rel": 0.0, "tol_abs": 0.0,
        })
        params, _ = build_model(cfg).abstract_params()
        grad_ar = sum(
            compressed_psum_bytes(tree, scheme="int8")
            for tree in stage_param_trees(plan, params)
        )
        rows.append({
            "name": f"{tag}_int8_grad_ar_bytes", "value": float(grad_ar),
            "tol_rel": 0.0, "tol_abs": 0.0,
        })
    # MoE ep_a2a dispatch payload twin
    from repro_torch.dist.ep_a2a import moe_a2a_bytes

    moe_cfg = _tiny("qwen3-moe-235b-a22b")
    rows.append({
        "name": "pipe_moe_a2a_bytes",
        "value": float(
            moe_a2a_bytes(moe_cfg.moe, micro_batch * seq, moe_cfg.d_model,
                          itemsize=4)
        ),
        "tol_rel": 0.0, "tol_abs": 0.0,
    })
    return rows


def exec_config():
    """The executor rows' model: the tiny llama at 4 layers."""
    return _tiny("llama3.2-1b", num_layers=4)


def execution_rows(params, device="cuda") -> list[dict]:
    """The tiny dense transformer through the scheduled executor (1 rank,
    interleaved 1F1B, 2 virtual stages, 2 microbatches of 2 x 16) on
    ``device``, against autograd of ``microbatched_reference`` on the same
    ``params`` (:func:`exec_config`'s tree, on ``device``).  Each row's
    ``launches`` are the kernels the executor's step launched; on a card a
    kernel that did not launch raises."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import resolve_device
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models import build_model, make_concrete_batch
    from repro_torch.models.pipeline import (
        make_plan,
        microbatched_reference,
        pipeline_loss_and_grads,
    )
    from repro_torch.tree import flatten_with_path, tree_map

    dev = resolve_device(device)
    cfg = exec_config()
    shape = ShapeConfig("bench_pipe", EXEC_SEQ, EXEC_BATCH, "train")
    model = build_model(cfg)
    batch = make_concrete_batch(cfg, shape, device=dev)
    mesh = make_mesh((1,), ("stage",), device=dev)
    plan = make_plan(cfg, 1, EXEC_MICROBATCHES, schedule="interleaved_1f1b",
                     vstages=2)
    counters = {"flash_attention": fa_ops.LAUNCHES, "rmsnorm": rms_ops.LAUNCHES}
    before = {k: c.count for k, c in counters.items()}
    loss, _metrics, grads = pipeline_loss_and_grads(plan, params, batch, mesh)
    launches = {k: c.count - before[k] for k, c in counters.items()}
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"the executor's step on {dev} did not launch "
                             f"every kernel: {launches}")
    ref = microbatched_reference(model, plan.microbatches)
    ref_params = tree_map(lambda t: t.detach().requires_grad_(), params)
    ref_loss = ref(ref_params, batch)
    paths = flatten_with_path(ref_params)
    ref_grads = dict(zip(
        (p for p, _ in paths),
        torch.autograd.grad(ref_loss, [t for _, t in paths])))
    worst = 0.0
    for kp, g in flatten_with_path(grads):
        r = ref_grads[kp]
        d = float((g - r).abs().max())
        s = float(r.abs().max()) + 1e-8
        worst = max(worst, d / s)
    derived = f"ref_loss={float(ref_loss.detach()):.9g};device={dev}"
    return [
        {
            # numerics band: BLAS/version drift allowed, divergence not
            "name": "pipe_exec_loss", "value": float(loss),
            "tol_rel": 0.02, "tol_abs": 0.0, "derived": derived,
            "launches": launches,
        },
        {
            # parity band: worst grad err must stay ~fp32 noise
            "name": "pipe_exec_grad_rel_err", "value": worst,
            "tol_rel": 0.0, "tol_abs": 5e-4, "derived": derived,
            "launches": launches,
        },
    ]


def jax_params(device="cuda") -> dict:
    """The JAX package's ``PRNGKey(0)`` parameters of :func:`exec_config`,
    whose loss the baseline pins, as tensors on ``device``.  The gate's one
    use of the JAX package, imported here only, and kept on the CPU (a
    CUDA build of JAX would otherwise take the card)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np

    if jax.default_backend() != "cpu":
        raise RuntimeError(f"the JAX package runs on the CPU here, not on "
                           f"{jax.default_backend()}")

    from repro.configs import base as jax_configs
    from repro.models import build_model as jax_build_model
    from repro_torch.models import load_jax_params

    jcfg = _tiny("llama3.2-1b", num_layers=4, configs=jax_configs)
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           device=device)


# -- benchmarks/bench_comm.py -----------------------------------------------


def modeled_tpu_rows() -> list[dict]:
    """Spec-sheet TPU v5e ICI ring table (per-device payload 64 MiB)."""
    from repro_torch.core.hardware import TPU_V5E, collective_time

    payload = 64 * 2**20
    rows = []
    for fam in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        for group in (16, 256):
            t = collective_time(fam, payload, group, TPU_V5E.ici)
            rows.append(
                {
                    "name": f"table1_tpu_{fam}_g{group}",
                    "us_per_call": t * 1e6,
                    "derived": f"eff_GBps={payload / t / 1e9:.2f}",
                }
            )
    return rows


def deterministic_rows() -> list[dict]:
    """Spec-sheet ring times (exact) and the synthetic netprof fit recovery
    (lstsq and log-log interpolation: a 1 % band for BLAS drift)."""
    from repro_torch.core.database import ProfileDB
    from repro_torch.core.hardware import COLLECTIVE_KINDS
    from repro_torch.netprof.model import fit_collective_models
    from repro_torch.netprof.sweep import synthetic_calibration

    rows = []
    for r in modeled_tpu_rows():
        rows.append(
            {
                "name": f"comm_{r['name']}",
                "value": r["us_per_call"],
                "tol_rel": 0.0,
                "tol_abs": 0.0,
            }
        )
    db = ProfileDB()
    synthetic_calibration(db, "synthetic")
    models = fit_collective_models(db, "synthetic")
    for kind in COLLECTIVE_KINDS:
        m = models[kind]
        rows.append(
            {
                # held-out payload, measured group: interpolation path
                "name": f"comm_netprof_fit_{kind}_interp_us",
                "value": m.predict(3 * 2**14, 4) * 1e6,
                "tol_rel": 0.01,
                "tol_abs": 0.0,
            }
        )
        rows.append(
            {
                # unmeasured group: α–β cross-group extrapolation path
                "name": f"comm_netprof_fit_{kind}_group16_us",
                "value": m.predict(2**18, 16) * 1e6,
                "tol_rel": 0.01,
                "tol_abs": 0.0,
            }
        )
    return rows


# -- scripts/bench_gate.py --------------------------------------------------


def _metric(r: dict) -> dict:
    return {"value": float(r["value"]),
            "tol_rel": float(r.get("tol_rel", 0.0)),
            "tol_abs": float(r.get("tol_abs", 0.0))}


def deterministic_metrics() -> dict[str, dict]:
    """The 52 deterministic metrics, in ``scripts/bench_gate.py``'s order."""
    metrics: dict[str, dict] = {}
    for r in schedule_rows():
        metrics[r["name"] + "_ticks"] = {
            "value": float(r["us_per_call"]), "tol_rel": 0.0, "tol_abs": 0.0,
        }
    for r in plan_rows() + deterministic_rows():
        metrics[r["name"]] = _metric(r)
    for r in serve_rows() + coverage_rows() + overlap_rows():
        metrics[r["name"]] = _metric(r)
    return metrics


def collect(smoke: bool, device="cuda") -> tuple[dict, list]:
    """The metrics, and the executor rows (empty under ``smoke``)."""
    metrics = deterministic_metrics()
    exec_rows = [] if smoke else execution_rows(jax_params(device), device)
    for r in exec_rows:
        metrics[r["name"]] = _metric(r)
    return metrics, exec_rows


def drift_table(
    current: dict[str, dict],
    baseline: dict[str, dict],
    allow_missing: bool = False,
) -> list[dict]:
    """One row per metric either side knows: baseline vs current vs
    tolerance.  ``status`` is ``ok`` / ``fail`` / ``missing`` (pinned but
    not produced: a failure unless ``allow_missing``) / ``skipped``
    (missing under --smoke) / ``new`` (produced but not pinned: never a
    failure).  :func:`compare` derives its verdict from this table."""
    rows: list[dict] = []
    for name, base in sorted(baseline.items()):
        row = {
            "name": name,
            "baseline": float(base["value"]),
            "current": None,
            "diff": None,
            "tol": max(
                float(base.get("tol_abs", 0.0)),
                float(base.get("tol_rel", 0.0)) * abs(float(base["value"])),
            ),
        }
        if name not in current:
            row["status"] = "skipped" if allow_missing else "missing"
        else:
            row["current"] = float(current[name]["value"])
            row["diff"] = row["current"] - row["baseline"]
            row["status"] = "ok" if abs(row["diff"]) <= row["tol"] else "fail"
        rows.append(row)
    for name in sorted(set(current) - set(baseline)):
        rows.append({
            "name": name, "baseline": None,
            "current": float(current[name]["value"]),
            "diff": None, "tol": None, "status": "new",
        })
    return rows


def render_drift(rows: list[dict]) -> str:
    """Aligned per-metric drift table (printed on gate failure)."""
    def fmt(v):
        return "-" if v is None else f"{v:.6g}"

    header = ("metric", "baseline", "current", "diff", "tol", "status")
    table = [header] + [
        (r["name"], fmt(r["baseline"]), fmt(r["current"]), fmt(r["diff"]),
         fmt(r["tol"]), r["status"])
        for r in rows
    ]
    widths = [max(len(row[i]) for row in table) for i in range(len(header))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def compare(
    current: dict[str, dict],
    baseline: dict[str, dict],
    allow_missing: bool = False,
    rows: list[dict] | None = None,
) -> list[str]:
    failures = []
    for r in (drift_table(current, baseline, allow_missing)
              if rows is None else rows):
        if r["status"] == "missing":
            failures.append(
                f"{r['name']}: pinned in baseline but not produced"
            )
        elif r["status"] == "skipped":
            print(f"[bench-gate-port] skipped (not produced in this mode): "
                  f"{r['name']}")
        elif r["status"] == "fail":
            failures.append(
                f"{r['name']}: {r['current']:.6g} vs baseline "
                f"{r['baseline']:.6g} (|diff| {abs(r['diff']):.3g} > "
                f"tol {r['tol']:.3g})"
            )
        elif r["status"] == "new":
            print(f"[bench-gate-port] NEW metric (not gated): {r['name']} = "
                  f"{r['current']:.6g}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the executor rows run: cuda (default) or cpu")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--smoke", action="store_true",
                    help="skip the executor rows (and the JAX package)")
    args = ap.parse_args(argv)
    if os.path.join(REPO, "src") not in sys.path:
        sys.path.insert(0, os.path.join(REPO, "src"))

    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the fp32 rows are held at fp32 noise: no TF32 matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with open(args.baseline) as f:
        baseline = json.load(f)["metrics"]
    metrics, exec_rows = collect(args.smoke, dev)
    rows = drift_table(metrics, baseline, allow_missing=args.smoke)
    device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu")
    report = {"metrics": metrics, "drift": rows, "device": device,
              "executor": [{k: r[k] for k in ("name", "derived", "launches")}
                           for r in exec_rows]}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"[bench-gate-port] wrote {args.out} ({len(metrics)} metrics, "
          f"device {device})")
    for r in exec_rows:
        print(f"[bench-gate-port] {r['name']} = {r['value']:.9g} "
              f"({r['derived']}; launches {r['launches']})")
    failures = compare(metrics, baseline, allow_missing=args.smoke,
                       rows=rows)
    if failures:
        print(f"[bench-gate-port] FAIL ({len(failures)} regressions):")
        for msg in failures:
            print(f"  - {msg}")
        print(render_drift(rows))
        return 1
    n_ok = sum(r["status"] == "ok" for r in rows)
    print(f"[bench-gate-port] OK: {n_ok} of the {len(baseline)} baseline "
          f"metrics in band")
    return 0


if __name__ == "__main__":
    sys.exit(main())

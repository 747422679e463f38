"""The port's bench gate (``scripts/bench_gate_port.py``, ``check_port.sh
bench``) against the JAX package's (``scripts/bench_gate.py`` over
``benchmarks/bench_*.py``), both read-only here.

  1. Every metric of ``benchmarks/baselines/bench_baseline.json``: the
     port's row equals the JAX package's row (exactly where the baseline's
     band is 0, within the band otherwise; the executor's loss within 1e-5,
     the pipeline tests' tolerance, on the JAX package's parameters), and
     lies in the baseline's band.
  2. ``models.make_concrete_batch`` equals the JAX package's bit for bit.
  3. The gate's verdict: 0 on the committed baseline, 1 on a value moved out
     of its band and on a metric the run does not produce.
  4. ``--smoke`` runs without JAX or the JAX package; ``check_port.sh bench``
     refuses a ``cuda`` run without a card.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models.build import make_concrete_batch as jax_batch  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402
from repro_torch.models import make_concrete_batch  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GATE = os.path.join(REPO, "scripts", "bench_gate_port.py")
with open(os.path.join(REPO, "benchmarks", "baselines",
                       "bench_baseline.json")) as _f:
    BASELINE = json.load(_f)["metrics"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gate = _load(GATE, "bench_gate_port")


@pytest.fixture(scope="module")
def port_metrics():
    metrics, exec_rows = gate.collect(smoke=False, device="cpu")
    assert [r["name"] for r in exec_rows] == ["pipe_exec_loss",
                                              "pipe_exec_grad_rel_err"]
    return metrics


@pytest.fixture(scope="module")
def jax_metrics():
    """The JAX package's own gate's metrics (its jitted executor rows
    included)."""
    return _load(os.path.join(REPO, "scripts", "bench_gate.py"),
                 "bench_gate").collect(smoke=False)


@pytest.mark.parametrize("name", sorted(BASELINE))
def test_port_row_equals_jax_row(port_metrics, jax_metrics, name):
    base = BASELINE[name]
    band = max(base["tol_abs"], base["tol_rel"] * abs(base["value"]))
    got, want = port_metrics[name]["value"], jax_metrics[name]["value"]
    assert (port_metrics[name]["tol_rel"], port_metrics[name]["tol_abs"]) \
        == (base["tol_rel"], base["tol_abs"])
    if band == 0.0:
        assert got == want
    else:
        assert abs(got - want) <= band
    if name == "pipe_exec_loss":
        assert got == pytest.approx(want, rel=1e-5)
    assert abs(got - base["value"]) <= band


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_make_concrete_batch_equals_jax(arch):
    shape = port_configs.ShapeConfig("batch_test", 24, 3, "train")
    want = jax_batch(jax_configs.get_config(arch),
                     jax_configs.ShapeConfig("batch_test", 24, 3, "train"),
                     seed=5)
    got = make_concrete_batch(port_configs.get_config(arch), shape, seed=5,
                              device="cpu")
    assert set(got) == set(want)
    if arch == "seamless-m4t-large-v2":
        assert got["frames"].dtype == torch.bfloat16
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape
        if g.is_floating_point():
            np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(w.astype(jax.numpy.float32)))
        else:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("change,rc", [
    (None, 0),
    ("moved", 1),
    ("pinned_not_produced", 1),
])
def test_gate_verdict(port_metrics, monkeypatch, tmp_path, capsys, change,
                      rc):
    base = json.loads(json.dumps(BASELINE))
    if change == "moved":
        base["serve_sim_steps"]["value"] += 1.0
    elif change == "pinned_not_produced":
        base["pipe_exec_other"] = dict(base["pipe_exec_loss"])
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"metrics": base}))
    monkeypatch.setattr(gate, "collect",
                        lambda smoke, device: (port_metrics, []))
    out = tmp_path / "report.json"
    assert gate.main(["--device", "cpu", "--baseline", str(path),
                      "--out", str(out)]) == rc
    status = {r["name"]: r["status"]
              for r in json.loads(out.read_text())["drift"]}
    text = capsys.readouterr().out
    if change == "moved":
        assert status["serve_sim_steps"] == "fail"
        assert "serve_sim_steps: 109 vs baseline 110" in text
    elif change == "pinned_not_produced":
        assert status["pipe_exec_other"] == "missing"
        assert "pipe_exec_other: pinned in baseline but not produced" in text
    else:
        assert set(status.values()) == {"ok"} and len(status) == 54
        assert "OK: 54 of the 54 baseline metrics in band" in text


def test_smoke_runs_without_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{GATE!r}, '--smoke', '--device', 'cpu', '--out', "
        f"{str(tmp_path / 'r.json')!r}]\n"
        "rc = 0\n"
        "try:\n"
        f"    runpy.run_path({GATE!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
        "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "OK: 52 of the 54 baseline metrics in band" in proc.stdout
    report = json.loads((tmp_path / "r.json").read_text())
    assert len(report["metrics"]) == 52 and report["executor"] == []
    assert {r["status"] for r in report["drift"]} == {"ok", "skipped"}


def test_check_port_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the cuda run is the card's")
    env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    proc = subprocess.run(["bash", os.path.join(REPO, "scripts",
                                                "check_port.sh"), "bench"],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert ("bench: DEVICE=cuda but no CUDA card is visible; run "
            "'DEVICE=cpu bash scripts/check_port.sh bench'") in proc.stderr

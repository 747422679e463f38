"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports JAX or the JAX package, its launcher runs end to
end on the CPU when asked to, and nothing falls back to the CPU silently.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(REPO, "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {repo!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its checks run only under __main__)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_every_module_leaves_jax_and_repro_out():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(src=SRC, repo=REPO)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    n, leaked = out.stdout.split(maxsplit=1)
    assert int(n) >= 30
    assert leaked.strip() == "[]"


_NEW_MODULES = {
    "repro_torch.launch.spec", "repro_torch.analysis.analyzer",
    "repro_torch.analysis.coverage", "repro_torch.analysis.graph_lints",
    "repro_torch.analysis.serve_checks",
    "repro_torch.analysis.timeline_checks",
    "repro_torch.analysis.__main__", "repro_torch.obs.diff",
    "repro_torch.obs.overlay", "repro_torch.obs.replay",
    "repro_torch.ckpt.checkpoint", "repro_torch.ft.elastic",
    "repro_torch.ft.heartbeat", "repro_torch.ft.straggler",
    "repro_torch.netprof.sweep", "repro_torch.netprof.report",
    "repro_torch.netprof.calibrate",
}

_WALK = """
import json, pkgutil, sys
sys.path.insert(0, {src!r})
import repro_torch
print(json.dumps([m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]))
"""


def test_the_walk_covers_the_analyzers_telemetry_and_spec():
    """The import walk above reaches the analyzers, the telemetry and the
    run spec: each of their modules is one it imports."""
    out = subprocess.run(
        [sys.executable, "-c", _WALK.format(src=SRC)], capture_output=True,
        text=True, timeout=300, env=_env(), cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    walked = set(json.loads(out.stdout))
    assert _NEW_MODULES <= walked, sorted(_NEW_MODULES - walked)


def test_no_source_file_names_jax_or_repro():
    bad = []
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                for line in open(path):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax", "import repro.",
                                     "from repro.", "from repro import")):
                        bad.append(f"{path}: {s}")
    assert bad == []


def test_launcher_parity_on_cpu(tmp_path):
    report = tmp_path / "parity.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--parity", "--synthetic-db", "--trace",
         "poisson", "--requests", "5", "--max-len", "64", "--chunk", "8",
         "--block-size", "8", "--tol-rel", "1e9", "--report", str(report)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "serve parity: OK" in out.stdout
    rep = json.loads(report.read_text())
    assert rep["composition_ok"] and rep["engine_steps"] == rep["twin_steps"]
    assert "measured-db" in out.stdout     # the sim priced from the DB


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.launch import serve as launcher
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    model = build_model(smoke_variant(get_config("llama3.2-1b")))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--smoke", "--simulate", "--synthetic-db"])


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, str(alone))):
        out = subprocess.run(
            [sys.executable, script], capture_output=True, text=True,
            timeout=300, env=_env(), cwd=cwd,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

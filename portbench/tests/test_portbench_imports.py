"""The import rule: nothing the harness runs loads JAX, flax or the JAX
package (top-level names compared whole), and the references import
nothing of the port either."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench.lib import device

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_top_level_names_compared_whole():
    mods = ["repro_torch", "repro_torch.serve.engine", "reproduce", "jaxfoo",
            "repro", "repro.models", "jax", "jaxlib.xla_client", "flax.nn"]
    assert device.forbidden_modules(mods) == [
        "flax.nn", "jax", "jaxlib.xla_client", "repro", "repro.models"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_references_import_no_program():
    for path in (HERE / "reference").glob("*.py"):
        got = _imports(path)
        assert not got & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, \
            (path.name, got)
        assert got <= {"__future__", "math", "torch", "portbench"}, got
    for path in (HERE / "reference").glob("*.py"):
        for mod in _imports(path) & {"portbench"}:
            assert mod == "portbench"
    src = "; ".join([
        f"import sys; sys.path[:0] = [{str(ROOT)!r}]",
        "import portbench.reference.encdec, portbench.reference.moe_lm",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')))"])
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_whole_run_loads_no_jax():
    """Every module a run can load, and a toy run of each kind on the CPU:
    no forbidden module afterwards."""
    src = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]",
        "import portbench.run, portbench.calibrate, portbench.sweep",
        "from portbench.lib import device, discover",
        "from portbench.tests import tiny",
        "for p in (discover.HERE / 'metrics').glob('*.py'):",
        "    p.stem.startswith('_') or discover.reader(p.stem)",
        "for cell in ('train', 'serve'):",
        "    ctx = tiny.context(cell, 11, seconds=1.0)",
        "    discover.kind(ctx.workload['kind']).run(ctx)",
        "print(device.forbidden_modules())"])
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3moe-serve-chat", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout == ""

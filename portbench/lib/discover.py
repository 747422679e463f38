"""Everything a run needs, found by name: a cell's file under
``portbench/workloads/``, its traffic mix's under ``portbench/traffic/``,
its configuration's under ``portbench/configs/``,
its kind's runner under ``portbench/kinds/`` and each per-layer metric's
reader under ``portbench/metrics/``.  A later cell, configuration or metric
is a file added there (and its entry in ``BENCHMARK.json``); no file that is
there needs an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                   # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _load(folder: str, name: str) -> dict:
    with open(HERE / folder / f"{_name(name)}.json") as f:
        d = json.load(f)
    if d.get("name") != name:
        raise ValueError(f"{folder}/{name}.json names {d.get('name')!r}")
    return d


def workload(name: str) -> dict:
    """A cell's file, its ``traffic`` replaced by the traffic mix's file."""
    w = _load("workloads", name)
    return dict(w, traffic=_load("traffic", w["traffic"]))


def config(name: str) -> dict:
    return _load("configs", name)


def kind(name: str):
    """The runner module of a kind of cell."""
    return importlib.import_module(f"portbench.kinds.{_name(name)}")


def reader(metric: str):
    """The ``read`` function of a per-layer metric's file."""
    path = HERE / "metrics" / f"{_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metric_names(cell: str, trace: bool, bench: dict) -> list[str]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics, or with
    ``trace`` its per-layer ones, as ``BENCHMARK.json`` lists them (an entry
    without ``workloads`` is every cell's)."""
    key = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench[key]
            if cell in m.get("workloads", [cell])]

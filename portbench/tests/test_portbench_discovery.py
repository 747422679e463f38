"""Cells, configurations, traffic mixes and metric readers are found by
name, and BENCHMARK.json names only what the harness has."""
import json

import pytest

from portbench.kinds.common import arch_config, dims
from portbench.lib import discover

BENCH = json.loads((discover.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = discover.workload(cell)
    assert w["config"] == entry["config"]
    assert w["traffic"]["name"] == entry["traffic"]
    assert w["chips"] == entry["chips"]
    assert discover.kind(w["kind"]).run
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_run_as_stated(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    c = discover.config(name)
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert entry["source"] == c["source"]
    assert entry["reduced"] == c["reduced"]
    assert all(k in c for k in c["reduced"])
    cfg = arch_config(c)
    for key, field in c["program"]["fields"].items():
        got = cfg
        for part in field.split("."):
            got = getattr(got, part)
        assert got == c[key], (key, field)
    assert dims(cfg)["d_model"] == c["hidden_size"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(discover.reader(metric))


def test_metric_names_follow_the_cells():
    train = discover.metric_names("seamless-train-2k", False, BENCH)
    assert set(train) == {"train_tokens_per_s", "peak_mem_gb", "setup_s"}
    chat = discover.metric_names("qwen3moe-serve-chat", True, BENCH)
    assert "mfu.decode" in chat and "mfu.train" not in chat


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    """A later cell is a file under workloads/ naming a traffic file."""
    for folder in ("workloads", "traffic", "configs", "metrics"):
        (tmp_path / folder).mkdir()
    (tmp_path / "traffic" / "mix.json").write_text(
        json.dumps({"name": "mix", "arrivals": {"process": "poisson",
                                                "rate": 1.0}}))
    (tmp_path / "workloads" / "new-cell.json").write_text(
        json.dumps({"name": "new-cell", "config": "c", "traffic": "mix"}))
    (tmp_path / "metrics" / "x.serve.py").write_text(
        "def read(run):\n    return 7.0\n")
    monkeypatch.setattr(discover, "HERE", tmp_path)
    assert discover.workload("new-cell")["traffic"]["name"] == "mix"
    assert discover.reader("x.serve")(None) == 7.0
    with pytest.raises(ValueError):
        discover.workload("../etc")

"""``scripts/op_lists.py``, the ATen op lists that hold a refactor of the
model layer to the same work: a recording is reproducible, it sees a
change of one op's order, and the comparison reports it."""
import dataclasses
import importlib.util
import json
from pathlib import Path

from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import layers as L

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "op_lists.py"


def _load():
    spec = importlib.util.spec_from_file_location("op_lists", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_llama():
    return dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                               num_layers=1)


def test_recording_is_reproducible_and_sees_a_reordering(monkeypatch,
                                                         tmp_path, capsys):
    ops = _load()
    cfg = _tiny_llama()
    first, again = ops.family_modes(cfg), ops.family_modes(cfg)
    assert set(first) == {"loss_grad_none", "loss_grad_dots",
                          "loss_grad_full", "prefill", "decode",
                          "prefill_chunk", "decode_batch"}
    assert first == again and all(first.values())
    assert ops.compare(first, again)

    # the same projections in another order: v, k, then q
    def qkv(p, x, cfg, positions):
        cdt = L.dtype_of(cfg.compute_dtype)
        v, k, q = (L.proj(x, p[w].to(cdt)) for w in ("wv", "wk", "wq"))
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta), v)

    monkeypatch.setattr(L, "_project_qkv", qkv)
    moved = ops.family_modes(cfg)
    assert moved["prefill"] != first["prefill"]
    assert sorted(moved["prefill"]) == sorted(first["prefill"])
    assert not ops.compare(first, moved)
    assert "NOT equal" in capsys.readouterr().out
    for name, lists in (("old", first), ("new", moved)):
        (tmp_path / f"{name}.json").write_text(json.dumps(lists))
    assert ops.main(["--compare", str(tmp_path / "old.json"),
                     str(tmp_path / "new.json")]) == 1

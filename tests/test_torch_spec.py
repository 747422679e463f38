"""The port's ``launch/spec.py`` against the JAX package's: the same fields
and defaults, the same flags, the same ``to_dict`` / ``describe`` /
``strategy()``, and the same ``run_spec`` in a report."""
import argparse
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.diagnostics import Report as JReport  # noqa: E402
from repro.launch import spec as jspec  # noqa: E402
from repro_torch.analysis.diagnostics import Report as TReport  # noqa: E402
from repro_torch.launch import spec as tspec  # noqa: E402

torch.set_num_threads(2)

_SPECS = {
    "default": {},
    "train": {"arch": "mamba2-2.7b", "seq": 2048, "batch": 4, "steps": 3,
              "grad_accum": 2, "compression": "int8"},
    "pipeline": {"pp": 2, "microbatches": 4, "pp_schedule": "gpipe",
                 "overlap_buckets": 3, "analyze": True},
    "interleaved": {"pp": 2, "vstages": 2, "pp_schedule": "interleaved_1f1b"},
    "vstages_only": {"vstages": 2},
    "serve": {"smoke": True, "slots": 8, "max_len": 2048, "chunk": 256,
              "obs": True, "trace_out": "s.json", "seed": 3},
    "dryrun": {"shape": "train_4k", "mesh": "multi", "netprof_db": "n.json",
               "overlap_comm": True},
}


def test_fields_and_defaults_match():
    def table(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert table(tspec.RunSpec) == table(jspec.RunSpec)


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_to_dict_describe_and_roundtrip_match(name):
    kw = _SPECS[name]
    j, t = jspec.RunSpec(**kw), tspec.RunSpec(**kw)
    assert t.to_dict() == j.to_dict() == kw
    assert t.describe() == j.describe()
    assert tspec.RunSpec.from_dict(dict(t.to_dict(), unknown=1)) == t


@pytest.mark.parametrize("name", sorted(_SPECS))
@pytest.mark.parametrize("dp", [1, 4])
def test_strategy_matches(name, dp):
    j = jspec.RunSpec(**_SPECS[name]).strategy(dp=dp)
    t = tspec.RunSpec(**_SPECS[name]).strategy(dp=dp)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.describe() == j.describe()


_ARGV = {
    "model": ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--seed", "7"],
    "train": ["--seq", "64", "--batch", "8", "--pp", "2", "--vstages", "2",
              "--pp-schedule", "interleaved_1f1b", "--microbatches", "4",
              "--compression", "int8", "--overlap-buckets", "2",
              "--overlap-comm", "--analyze", "--netprof-db", "db.json",
              "--grad-accum", "2", "--steps", "5"],
    "serve": ["--slots", "8", "--max-len", "64", "--block-size", "8",
              "--chunk", "8"],
    "dryrun": ["--shape", "decode", "--mesh", "both"],
    "obs": ["--obs", "--trace-out", "t.json"],
}


@pytest.mark.parametrize("groups", [
    ("model",), ("model", "train", "obs"), ("model", "serve", "obs"),
    ("dryrun",),
])
@pytest.mark.parametrize("given", [False, True])
def test_flags_parse_to_the_same_spec(groups, given):
    argv = [a for g in groups for a in _ARGV[g]] if given else []
    over = {} if given else {"seed": 11}    # from_args' overrides win
    specs = [mod.from_args(_parser(mod, groups).parse_args(argv), **over)
             for mod in (jspec, tspec)]
    assert specs[1].to_dict() == specs[0].to_dict()
    assert [a.dest for a in _parser(tspec, groups)._actions] == \
        [a.dest for a in _parser(jspec, groups)._actions]


def _parser(mod, groups):
    ap = argparse.ArgumentParser()
    mod.add_args(ap, *groups)
    return ap


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_attach_puts_the_same_run_spec_in_a_report(name):
    jr, tr = JReport("r"), TReport("r")
    jspec.attach(jr, jspec.RunSpec(**_SPECS[name]))
    tspec.attach(tr, tspec.RunSpec(**_SPECS[name]))
    assert tr.to_dict() == jr.to_dict()
    assert tr.extras["run_spec"] == _SPECS[name]
    tspec.attach(tr, None)          # no spec: nothing attached
    assert tr.extras["run_spec"] == _SPECS[name]

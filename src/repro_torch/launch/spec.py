"""RunSpec: the one serializable description of a launch.

Every launcher (``launch/train.py``, ``launch/serve.py``,
``launch/dryrun.py``) used to define its own overlapping argparse flags;
:class:`RunSpec` consolidates them.  Flags are declared once per group
(:func:`add_args`), parsed back into one frozen dataclass
(:meth:`RunSpec.from_args`), and echoed verbatim into every parity /
analyze report (``report.extras["run_spec"]`` or the report JSON's
``run_spec`` key) — a report always says exactly which launch produced it.

The spec round-trips through JSON (:meth:`to_dict` / :meth:`from_dict`),
so a saved report re-creates the launch that generated it.

A copy of the JAX package's ``launch/spec.py`` with its imports rewritten:
the same fields, defaults and flags, so ``to_dict()`` and a report's
``run_spec`` are identical (``tests/test_torch_spec.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RunSpec:
    """Shared launch parameters across train / serve / dryrun drivers."""

    # model
    arch: str = "llama3.2-1b"
    smoke: bool = False
    seq: int = 256
    batch: int = 8
    seed: int = 0
    # train strategy
    steps: int = 50
    grad_accum: int = 1
    compression: str = "none"
    pp: int = 1
    pp_schedule: str = "1f1b"
    vstages: int = 1
    microbatches: int = 0
    # overlapped execution (repro_torch.dist; both knobs are bit-exact rewrites)
    overlap_buckets: int = 0
    overlap_comm: bool = False
    # pricing / verification
    netprof_db: str = ""
    analyze: bool = False
    # serve engine shape
    slots: int = 4
    max_len: int = 128
    block_size: int = 16
    chunk: int = 32
    # dryrun cell
    shape: str = ""
    mesh: str = "single"
    # observability (repro_torch.obs; docs/observability.md)
    obs: bool = False
    trace_out: str = ""

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        """Only non-default fields — reports stay readable and stable when
        new fields grow defaults."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "RunSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def describe(self) -> str:
        d = self.to_dict()
        return "RunSpec(" + ", ".join(
            f"{k}={d[k]!r}" for k in sorted(d)
        ) + ")"

    # -- strategy bridge -----------------------------------------------------

    def strategy(self, dp: int = 1):
        """The :class:`repro_torch.core.strategy.Strategy` this launch prices."""
        from repro_torch.core.strategy import Strategy

        pipeline_on = self.pp > 1 or self.vstages > 1
        return Strategy(
            dp=dp,
            pp=self.pp if pipeline_on else 1,
            microbatches=(
                (self.microbatches or max(self.pp, 1)) if pipeline_on else 1
            ),
            schedule=self.pp_schedule if pipeline_on else "1f1b",
            vstages=self.vstages if pipeline_on else 1,
            compression=self.compression,
            overlap_buckets=self.overlap_buckets,
        )


# argparse declarations, one per flag, shared by every launcher.  Each entry:
# (flag, field, kwargs).  `store_true` fields infer the action from the
# default being False.
_GROUPS: dict[str, list[tuple[str, str, dict]]] = {
    "model": [
        ("--arch", "arch", {}),
        ("--smoke", "smoke",
         {"help": "reduced config of the same family (CPU-sized)"}),
        ("--seed", "seed", {"type": int}),
    ],
    "train": [
        ("--seq", "seq", {"type": int}),
        ("--batch", "batch", {"type": int}),
        ("--steps", "steps", {"type": int}),
        ("--grad-accum", "grad_accum", {"type": int}),
        ("--compression", "compression",
         {"choices": ["none", "int8"],
          "help": "compressed data-parallel gradients: int8 "
                  "quantize->psum->dequantize with error-feedback "
                  "residuals carried in TrainState.comp_state "
                  "(repro_torch.dist.compress; checkpoint format v2)"}),
        ("--pp", "pp",
         {"type": int,
          "help": "pipeline stages: simulate the schedule AND run the real "
                  "model through the scheduled pipeline executor on a "
                  "(data, stage) mesh (repro_torch.models.pipeline; needs "
                  "device_count %% pp == 0)"}),
        ("--pp-schedule", "pp_schedule",
         {"choices": ["gpipe", "1f1b", "interleaved_1f1b"],
          "help": "pipeline schedule (repro_torch.dist.schedules)"}),
        ("--vstages", "vstages",
         {"type": int,
          "help": "virtual stages per device (interleaved_1f1b)"}),
        ("--microbatches", "microbatches",
         {"type": int,
          "help": "pipeline microbatches for the schedule plan "
                  "(default: --pp)"}),
        ("--overlap-buckets", "overlap_buckets",
         {"type": int,
          "help": ">= 2: bucket the dp gradient all-reduce into this many "
                  "reverse-topological buckets launched as backward "
                  "retires their chunks (bit-exact; "
                  "repro_torch.dist.compress.compressed_psum buckets path), and "
                  "split the simulated gradAR nodes identically"}),
        ("--overlap-comm", "overlap_comm",
         {"help": "unroll the scheduled pipeline executor and elide "
                  "dead-tick ppermutes so boundary sends interleave with "
                  "compute (bit-exact; repro_torch.dist.pp overlap mode)"}),
        ("--netprof-db", "netprof_db",
         {"help": "calibrated interconnect ProfileDB "
                  "(scripts/calibrate_net.py): launch-time simulations "
                  "price collectives from this host's measurements instead "
                  "of the ring model — including the link-contention model "
                  "when the DB holds a concurrent sweep "
                  "(repro_torch.netprof; docs/netprof.md)"}),
        ("--analyze", "analyze",
         {"help": "statically verify the plan (repro_torch.analysis) before "
                  "executing; abort on any error-level finding "
                  "(docs/analysis.md)"}),
    ],
    "serve": [
        ("--slots", "slots", {"type": int}),
        ("--max-len", "max_len", {"type": int}),
        ("--block-size", "block_size", {"type": int}),
        ("--chunk", "chunk", {"type": int}),
    ],
    "dryrun": [
        ("--shape", "shape", {"help": "shape cell name (repro_torch.configs.SHAPES)"}),
        ("--mesh", "mesh", {"choices": ["single", "multi", "both"]}),
    ],
    "obs": [
        ("--obs", "obs",
         {"help": "record runtime telemetry (repro_torch.obs): span the real "
                  "executor under the simulator's node-uid vocabulary, "
                  "run the divergence attributor (O-code diagnostics), "
                  "and print the sim-vs-real gap attribution "
                  "(docs/observability.md)"}),
        ("--trace-out", "trace_out",
         {"help": "write the merged sim+real Chrome/Perfetto overlay "
                  "trace here (implies nothing without --obs); the "
                  "divergence report JSON lands next to it as "
                  "<stem>_report.json"}),
    ],
}

_FIELD_DEFAULTS = {
    f.name: f.default for f in dataclasses.fields(RunSpec)
}


def add_args(
    ap: argparse.ArgumentParser, *groups: str
) -> None:
    """Declare the RunSpec flags of the given groups on ``ap``.

    Defaults come from the dataclass, so the CLI and
    ``RunSpec()`` can never disagree; bool fields defaulting False become
    ``store_true`` flags.
    """
    for group in groups:
        for flag, field, kw in _GROUPS[group]:
            default = _FIELD_DEFAULTS[field]
            kw = dict(kw)
            if isinstance(default, bool):
                ap.add_argument(
                    flag, dest=field, action="store_true",
                    default=default, **kw,
                )
            else:
                kw.setdefault("default", default)
                ap.add_argument(flag, dest=field, **kw)


def from_args(args: argparse.Namespace, **overrides) -> RunSpec:
    """Collect whatever RunSpec fields the namespace carries into a spec."""
    known = {f.name for f in dataclasses.fields(RunSpec)}
    vals = {
        k: v for k, v in vars(args).items()
        if k in known and v is not None
    }
    vals.update(overrides)
    return RunSpec(**vals)


def attach(report, spec: Optional[RunSpec]) -> None:
    """Echo the spec into an analysis :class:`repro_torch.analysis.Report`."""
    if spec is not None:
        report.extras["run_spec"] = spec.to_dict()

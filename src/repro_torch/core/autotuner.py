"""Strategy autotuner: the paper's motivating MLOps use case.

"systems like PipeDream and FlexFlow can use it to rapidly find the optimal
parallelization strategy for any DNN, hardware, and hyperparameter settings
without the high overheads of online profiling."

Given a per-layer cost profile (derivable from one parsed layer graph or from
``ArchConfig`` analytically) and a chip budget, enumerate (dp x tp x pp x
microbatch x schedule) candidates, simulate each pipeline step with the DES
engine, and rank by simulated makespan.  Also supports straggler injection —
slow down one stage by a factor.

The torch port's copy of the JAX package's ``core/autotuner.py``, with two
additions: the default platform is the port's ``H100_SXM`` (the reference's
is ``TPU_V5E``), and a tuner may take its per-layer cost from the card
(``layer_cost``: e.g. ``models.pipeline.model_layer_cost`` over a ProfileDB
that ``models.pipeline.profile_layer`` filled), with the
tensor-parallel widths it enumerates narrowed to those that cost covers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.estimator import OpTimeEstimator
from repro_torch.core.graph import OpNode
from repro_torch.core.hardware import H100_SXM, PlatformSpec
from repro_torch.core.simulator import Simulator, default_device_fn
from repro_torch.core.strategy import LayerCost, Strategy, pipeline_graph


def layer_cost_from_config(
    cfg: ArchConfig, batch: int, seq: int, tp: int, dtype_bytes: int = 2
) -> LayerCost:
    """Analytic per-layer cost for one microbatch, per tp shard."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    qkv = 2.0 * batch * seq * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    attn = 4.0 * batch * seq * seq * cfg.num_heads * hd  # scores + out
    proj = 2.0 * batch * seq * cfg.num_heads * hd * d
    if cfg.moe is not None:
        e = cfg.moe
        ffn = 6.0 * batch * seq * d * e.d_ff_expert * (e.top_k + e.num_shared_experts)
    else:
        ffn = 6.0 * batch * seq * d * cfg.d_ff
    flops = (qkv + attn + proj + ffn) / tp
    act_bytes = dtype_bytes * batch * seq * d
    layer_params = (
        cfg.num_params() - 2 * cfg.vocab_size * d
    ) / max(cfg.num_layers, 1)
    # analytic tensor count per layer: qkv/o projections + two norms, plus
    # the FFN matrices (router + expert stack for MoE) — feeds the
    # per-tensor scale metadata of compressed gradient all-reduces
    if cfg.moe is not None:
        ffn_tensors = 1 + 3  # router + gate/up/down expert stacks
    else:
        ffn_tensors = 3
    return LayerCost(
        fwd_flops=flops,
        fwd_bytes=4.0 * act_bytes / tp + layer_params * dtype_bytes / tp,
        bwd_multiplier=2.0,
        boundary_bytes=act_bytes,
        grad_bytes=layer_params * dtype_bytes / tp,
        grad_tensors=4 + 2 + ffn_tensors,
    )


@dataclass
class TuneResult:
    strategy: Strategy
    makespan_s: float
    bubble_fraction: float
    comm_fraction: float


@dataclass
class Autotuner:
    cfg: ArchConfig
    chips: int
    global_batch: int
    seq: int
    platform: PlatformSpec = H100_SXM
    estimator: Optional[OpTimeEstimator] = None
    straggler_stage: Optional[int] = None
    straggler_factor: float = 1.0
    # (micro_batch, tp) -> LayerCost; None: layer_cost_from_config
    layer_cost: Optional[Callable[[int, int], LayerCost]] = None

    def __post_init__(self):
        if self.estimator is None:
            self.estimator = OpTimeEstimator(self.platform)
        # filled by candidates(): how many enumerated strategies static
        # analysis rejected before simulation, attributed by code
        self.prune_stats: dict = {
            "enumerated": 0, "pruned": 0, "by_code": {}
        }

    # -- candidate enumeration --------------------------------------------------

    def enumerate_candidates(
        self,
        max_pp: int = 16,
        microbatch_options=(1, 2, 4, 8, 16, 32),
        vstage_options=(2,),
        tp_options=(1, 2, 4, 8, 16),
    ) -> list[Strategy]:
        """Every candidate the resource constraints allow (chip factoring,
        batch divisibility).  Schedule legality — layer partitioning,
        schedule constructibility, table liveness — is NOT checked here;
        that is the static analyzer's job (:meth:`prune`), so illegal
        shapes are counted and attributed instead of silently skipped."""
        out = []
        for pp in [p for p in (1, 2, 4, 8, 16) if p <= max_pp]:
            rem = self.chips // pp
            if rem * pp != self.chips:
                continue
            for tp in tp_options:
                if tp > rem or rem % tp != 0:
                    continue
                dp = rem // tp
                if self.global_batch % dp != 0:
                    continue
                for mb in microbatch_options:
                    per_dp = self.global_batch // dp
                    if per_dp % mb != 0:
                        continue
                    scheds = [("1f1b", 1)]
                    if pp > 1:
                        scheds.insert(0, ("gpipe", 1))
                        scheds.extend(
                            ("interleaved_1f1b", v)
                            for v in vstage_options if v > 1
                        )
                    for sched, v in scheds:
                        out.append(
                            Strategy(
                                dp=dp, tp=tp, pp=pp,
                                microbatches=mb, schedule=sched, vstages=v,
                            )
                        )
        return out

    def prune(
        self, enumerated: list[Strategy]
    ) -> tuple[list[Strategy], dict]:
        """Drop statically-illegal candidates before any simulation.

        Each candidate's schedule is verified by
        ``repro_torch.analysis.schedule_checks.lint_strategy`` — schedule not
        constructible (S012, e.g. interleaved microbatches not divisible
        by stages), layers not partitionable over the virtual stages
        (S013), or a table that is structurally broken or deadlocks.
        Returns ``(kept, stats)`` with ``stats = {"enumerated", "pruned",
        "by_code"}`` attributing every rejection to its diagnostic code.
        """
        from repro_torch.analysis.schedule_checks import lint_strategy

        L = self.cfg.num_layers
        kept: list[Strategy] = []
        by_code: dict[str, int] = {}
        for st in enumerated:
            report = lint_strategy(st, L)
            if report.ok:
                kept.append(st)
            else:
                for code in report.codes():
                    by_code[code] = by_code.get(code, 0) + 1
        stats = {
            "enumerated": len(enumerated),
            "pruned": len(enumerated) - len(kept),
            "by_code": by_code,
        }
        return kept, stats

    def candidates(
        self,
        max_pp: int = 16,
        microbatch_options=(1, 2, 4, 8, 16, 32),
        vstage_options=(2,),
        tp_options=(1, 2, 4, 8, 16),
    ) -> list[Strategy]:
        kept, stats = self.prune(
            self.enumerate_candidates(max_pp, microbatch_options,
                                      vstage_options, tp_options)
        )
        self.prune_stats = stats
        return kept

    # -- simulation ---------------------------------------------------------------

    def evaluate(self, strategy: Strategy) -> TuneResult:
        micro_bs = self.global_batch // strategy.dp // strategy.microbatches
        if self.layer_cost is not None:
            cost = self.layer_cost(micro_bs, strategy.tp)
        else:
            cost = layer_cost_from_config(
                self.cfg, micro_bs, self.seq, strategy.tp
            )
        g = pipeline_graph(self.cfg.num_layers, cost, strategy)

        est = self.estimator
        assert est is not None  # __post_init__ always fills the default

        def duration(node: OpNode) -> float:
            t = est.duration(node)
            if (
                self.straggler_stage is not None
                and node.device == f"stage{self.straggler_stage}"
            ):
                t *= self.straggler_factor
            return t

        res = Simulator(duration, default_device_fn, record_events=False).run(g)
        stage_busy = [
            t for d, t in res.device_busy.items() if d.startswith("stage")
        ]
        comm = sum(
            t for d, t in res.device_busy.items() if d.startswith("link")
        )
        max_busy = max(stage_busy) if stage_busy else 0.0
        bubble = 1.0 - max_busy / res.makespan if res.makespan > 0 else 0.0
        return TuneResult(
            strategy=strategy,
            makespan_s=res.makespan,
            bubble_fraction=bubble,
            comm_fraction=comm / res.makespan if res.makespan else 0.0,
        )

    def search(self, log_fn=None, **kw) -> list[TuneResult]:
        cands = self.candidates(**kw)
        if log_fn is not None:
            stats = self.prune_stats
            attributed = ", ".join(
                f"{c}x{n}" for c, n in sorted(stats["by_code"].items())
            )
            log_fn(
                f"[autotune] static pruning rejected {stats['pruned']}/"
                f"{stats['enumerated']} candidates before simulation"
                + (f" ({attributed})" if attributed else "")
            )
        results = [self.evaluate(s) for s in cands]
        results.sort(key=lambda r: r.makespan_s)
        return results

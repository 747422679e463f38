"""Roofline-term extraction from compiled dry-run artifacts (deliverable g).

Three terms per (arch x shape x mesh), all in seconds:

    compute    = HLO_FLOPs_per_device / peak_FLOP/s_per_chip
    memory     = HLO_bytes_per_device / HBM_bw_per_chip
    collective = per-device collective payload / link_bw   (prompt formula)
                 [+ an algorithm-aware ring estimate recorded alongside]

FLOPs/bytes come from the loop-expanded HLO parse (``repro_torch.core.hlo_parser``),
because XLA's ``cost_analysis()`` counts while-loop bodies once (verified;
the raw XLA numbers are recorded for reference).  The SPMD program is
per-device, so no division by chip count is needed on the HLO side;
MODEL_FLOPS (analytic, global) is divided by the chip count.

In the port a summary also comes from a traced step
(``repro_torch.core.fx_graph.step_summary``: ``flops`` and ``bytes``, no
collective keys).  The module is the JAX package's, unchanged: as there,
``roofline_fraction`` divides by the TPU v5e peak whatever ``platform``
``build_report`` was given, and the ring estimate prices every collective on
``platform.ici`` (ROADMAP C17).  A caller on another platform computes its
own fraction at that platform's peak beside the copied one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.hardware import PlatformSpec, TPU_V5E, collective_time


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # seconds
    compute_s: float
    memory_s: float
    collective_s: float          # prompt formula: payload / link_bw
    collective_ring_s: float     # ring-model with (g-1)/g factors + latency
    dominant: str
    # flop accounting
    hlo_flops_per_device: float
    model_flops_global: float
    useful_flop_ratio: float     # MODEL_FLOPS / (HLO_FLOPs * chips)
    # raw references
    xla_flops_raw: float = 0.0
    xla_bytes_raw: float = 0.0
    collective_bytes_ici: float = 0.0
    collective_bytes_dcn: float = 0.0
    notes: str = ""

    @property
    def bound_time_s(self) -> float:
        """Lower-bound step time if compute/memory/comm overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time (1.0 = perfect)."""
        if self.bound_time_s <= 0:
            return 0.0
        useful_s = (self.model_flops_global / self.chips) / (
            TPU_V5E.chip.peak_flops
        )
        return useful_s / self.bound_time_s


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs for the whole step (global, all chips).

    train: 6 * N_active * tokens  (fwd 2x + bwd 4x)
    prefill: 2 * N_active * tokens
    decode: 2 * N_active * new_tokens (batch x 1)
    (attention score FLOPs excluded by convention — this is the standard
    6ND accounting; the gap shows up in useful_flop_ratio.)
    """
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def build_report(
    arch_cfg: ArchConfig,
    shape: ShapeConfig,
    mesh_name: str,
    chips: int,
    summary: dict,
    platform: PlatformSpec = TPU_V5E,
    xla_cost: Optional[dict] = None,
    notes: str = "",
) -> RooflineReport:
    """summary = repro_torch.core.hlo_parser.module_summary(compiled.as_text())."""
    chip = platform.chip
    flops_dev = summary["flops"]
    bytes_dev = summary["bytes"]
    compute_s = flops_dev / chip.peak_flops
    memory_s = bytes_dev / chip.hbm_bw
    ici_b = summary.get("collective_bytes_ici", 0.0)
    dcn_b = summary.get("collective_bytes_dcn", 0.0)
    collective_s = ici_b / platform.ici.bw + dcn_b / platform.dcn.bw
    ring_s = 0.0
    for kind, e in summary.get("collectives", {}).items():
        k = kind if kind != "folded" else "all-reduce"
        link = platform.ici  # folded entries default to ici; split below
        ring_s += collective_time(k, e["bytes"], max(e["max_group"], 2), link)
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch_cfg, shape)
    hlo_total = flops_dev * chips
    ratio = mf / hlo_total if hlo_total > 0 else 0.0
    return RooflineReport(
        arch=arch_cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        collective_ring_s=ring_s,
        dominant=dominant,
        hlo_flops_per_device=flops_dev,
        model_flops_global=mf,
        useful_flop_ratio=ratio,
        xla_flops_raw=float((xla_cost or {}).get("flops", 0.0)),
        xla_bytes_raw=float((xla_cost or {}).get("bytes accessed", 0.0)),
        collective_bytes_ici=ici_b,
        collective_bytes_dcn=dcn_b,
        notes=notes,
    )


def to_row(r: RooflineReport) -> dict:
    return {
        "arch": r.arch,
        "shape": r.shape,
        "mesh": r.mesh,
        "chips": r.chips,
        "compute_s": r.compute_s,
        "memory_s": r.memory_s,
        "collective_s": r.collective_s,
        "collective_ring_s": r.collective_ring_s,
        "dominant": r.dominant,
        "hlo_flops_per_device": r.hlo_flops_per_device,
        "model_flops_global": r.model_flops_global,
        "useful_flop_ratio": r.useful_flop_ratio,
        "roofline_fraction": r.roofline_fraction,
        "bound_time_s": r.bound_time_s,
        "collective_bytes_ici": r.collective_bytes_ici,
        "collective_bytes_dcn": r.collective_bytes_dcn,
        "xla_flops_raw": r.xla_flops_raw,
        "notes": r.notes,
    }

"""Hardware platform specs and collective-algorithm models.

The paper profiles per-platform (V100 + PCIe/QPI/NVLink, Table 1); the
platforms here are the JAX package's TPU v5e target, the CPU host, and the
port's target, the NVIDIA H100 SXM (data-sheet constants, selected by device
name through :func:`platform_for_device`).

Collective timing uses standard ring-algorithm byte factors on the ICI torus
and a flat DCN hop for the ``pod`` axis.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float          # FLOP/s at the matmul dtype (bf16 for TPU)
    hbm_bw: float              # bytes/s
    vmem_bytes: int = 0
    hbm_bytes: int = 0
    # fraction of peak realistically achievable on large GEMMs (used by the
    # estimator's analytic fallback; measured platforms override via the DB)
    gemm_efficiency: float = 0.85
    vector_efficiency: float = 0.8


@dataclass(frozen=True)
class LinkSpec:
    name: str
    bw: float                  # bytes/s per link per direction
    latency: float = 1e-6      # per-hop


@dataclass(frozen=True)
class PlatformSpec:
    name: str
    chip: ChipSpec
    ici: LinkSpec
    dcn: LinkSpec

    def link_for(self, kind: str) -> LinkSpec:
        return self.dcn if kind == "dcn" else self.ici


# TPU v5e constants: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s/link ICI.  DCN modeled at 25 GB/s per host (conservative).
TPU_V5E = PlatformSpec(
    name="tpu_v5e",
    chip=ChipSpec(
        name="tpu_v5e",
        peak_flops=197e12,
        hbm_bw=819e9,
        vmem_bytes=128 * 1024 * 1024,
        hbm_bytes=16 * 1024**3,
    ),
    ici=LinkSpec("ici", 50e9, latency=1e-6),
    dcn=LinkSpec("dcn", 25e9, latency=10e-6),
)

# Placeholder CPU host: calibrated in-place by repro_torch.core.profiler (the
# numbers below are only used before calibration).
CPU_HOST = PlatformSpec(
    name="cpu_host",
    chip=ChipSpec(
        name="cpu_host",
        peak_flops=5e10,
        hbm_bw=1e10,
        gemm_efficiency=1.0,
        vector_efficiency=1.0,
    ),
    ici=LinkSpec("shm", 5e9, latency=5e-6),
    dcn=LinkSpec("shm", 5e9, latency=5e-6),
)

# NVIDIA H100 SXM, the port's target (the counterpart of TPU_V5E).  Figures
# are NVIDIA's data-sheet numbers for dense bf16 tensor-core math and HBM;
# the link is NVLink (900 GB/s, 450 GB/s each way).  DCN is modelled as the
# TPU one is.
H100_SXM = PlatformSpec(
    name="h100_sxm",
    chip=ChipSpec(
        name="h100_sxm",
        peak_flops=989e12,
        hbm_bw=3.35e12,
        vmem_bytes=227 * 1024,        # shared memory one block can use
        hbm_bytes=80 * 1000**3,
    ),
    ici=LinkSpec("nvlink", 450e9, latency=1e-6),
    dcn=LinkSpec("dcn", 25e9, latency=10e-6),
)

PLATFORMS = {p.name: p for p in (TPU_V5E, CPU_HOST, H100_SXM)}


def platform_for_device(device_name: str) -> PlatformSpec:
    """The spec of a CUDA card from ``torch.cuda.get_device_name()``.

    Only the SXM part ("NVIDIA H100 80GB HBM3") has a spec.  Any other card,
    the PCIe and NVL H100s included, raises instead of being priced as the
    SXM part: the variants differ by 30% in peak rate and 2x in memory rate.
    """
    if ("H100" in device_name and "PCIe" not in device_name
            and "NVL" not in device_name
            and ("SXM" in device_name or "HBM3" in device_name)):
        return H100_SXM
    raise ValueError(f"no platform spec for CUDA device {device_name!r}")


# ---------------------------------------------------------------------------
# Collective algorithm models (ring)
# ---------------------------------------------------------------------------
# The collective op families: graph-node kinds priced on a link stream,
# ProfileDB families the netprof sweep writes, and the families gated OUT of
# the estimator's compute-time MLP (their cost is group-structured, not a
# (flops, bytes) law — see repro_torch.netprof).
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# bytes_on_wire(bytes_per_device, group_size) for each collective kind.
# All-reduce = reduce-scatter + all-gather on a ring: 2 * (g-1)/g * B.
# All-gather / reduce-scatter: (g-1)/g * (full bytes).
# All-to-all: each device sends (g-1)/g of its buffer, spread over links.
# collective-permute: one hop.


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    if group <= 1:
        return 0.0
    g = float(group)
    if kind == "all-reduce":
        return 2.0 * (g - 1.0) / g * nbytes
    if kind in ("all-gather", "reduce-scatter"):
        return (g - 1.0) / g * nbytes
    if kind == "all-to-all":
        return (g - 1.0) / g * nbytes
    if kind == "collective-permute":
        return nbytes
    return nbytes


def collective_time(
    kind: str, nbytes: float, group: int, link: LinkSpec
) -> float:
    """Ring-model time for one collective on one link class.

    nbytes = the per-device payload (input bytes for reduce-scatter /
    all-reduce / all-to-all; output bytes for all-gather).
    """
    if group <= 1:
        return 0.0
    w = wire_bytes(kind, nbytes, group)
    steps = group - 1 if kind != "collective-permute" else 1
    return w / link.bw + steps * link.latency

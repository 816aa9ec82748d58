"""Roofline analysis from dry-run artifacts (``repro.analysis.roofline``),
on one NVIDIA H100 SXM a rank.

Three terms per (arch x shape x mesh) cell, all in seconds a step:

  compute    = FLOPs_per_rank / peak_FLOPs              (989 TFLOP/s dense bf16)
  memory     = bytes_per_rank / HBM_bw                  (3.35 TB/s)
  collective = collective_bytes_per_rank / link_bw      (450 GB/s NVLink, a direction)

The per-rank quantities come from the cost counter (``analysis/cost.py``)
over one rank's share of the traced step. MODEL_FLOPS uses 6*N*D for
training (2*N*D inference), N_active for MoE. The terms are predictions of
a bound, not measurements.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One accelerator's peak rates. The default is NVIDIA's H100 SXM data
    sheet: dense bf16 tensor-core rate, HBM3 rate, NVLink 4 rate in one
    direction (900 GB/s both ways), HBM capacity."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12  # bf16 FLOP/s per card, dense
    hbm_bw: float = 3.35e12  # bytes/s per card
    link_bw: float = 450e9  # bytes/s per card, one direction
    hbm_bytes: float = 80e9  # capacity per card


H100 = HardwareSpec()


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_total: float  # the counter's FLOPs over every rank (the reference's key)
    useful_ratio: float
    bottleneck: str
    step_s: float  # max of the three (no-overlap bound)
    roofline_fraction: float  # compute_s / step_s: how compute-bound we are

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(n_active_params: int, tokens: int, *, training: bool) -> float:
    return (6.0 if training else 2.0) * n_active_params * tokens


def compute_terms(
    *,
    flops_per_chip: float,
    bytes_per_chip: float,
    collective_bytes_per_chip: float,
    chips: int,
    model_flops_total: float,
    hw: HardwareSpec = H100,
) -> RooflineTerms:
    compute_s = flops_per_chip / hw.peak_flops
    memory_s = bytes_per_chip / hw.hbm_bw
    collective_s = collective_bytes_per_chip / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    total = flops_per_chip * chips
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_flops=model_flops_total,
        hlo_flops_total=total,
        useful_ratio=model_flops_total / total if total else 0.0,
        bottleneck=bottleneck,
        step_s=step_s,
        roofline_fraction=compute_s / step_s if step_s else 0.0,
    )

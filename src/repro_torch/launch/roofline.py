"""Roofline terms of a step on the NVIDIA H100 (counterpart of
:mod:`repro.launch.roofline`):

    compute    = FLOPs / 989 TFLOP/s          (dense bf16)
    memory     = HBM bytes / 3.35 TB/s
    collective = wire bytes / (18 links x 25 GB/s)

The peaks are NVIDIA's H100 SXM data sheet's (dense rates, no sparsity,
at the card's full 700 W power limit): 989 TFLOP/s in bf16, 3.35 TB/s of
HBM3, and NVLink 4 at 900 GB/s a card, both directions of its 18 links,
so 25 GB/s each way a link.  The terms are per card; a card set below
700 W runs slower under load, so a run's measured times come with the
card's name and power limit beside them.

The reference derives its inputs from XLA: ``cost_analysis`` of the
compiled SPMD program and ``collective_bytes(hlo_text)``, a parse of the
partitioned HLO's collectives.  The port runs eagerly, with no compiled
program and no HLO, so that parse has no counterpart.  Its inputs are
measured over one step instead (:func:`from_measured`): the FLOPs by
``torch.utils.flop_counter.FlopCounterMode`` (:func:`count_flops`), the
collective bytes by ``distributed.sharding.COLLECTIVES``, which sums each
kind's bytes with the reference's wire factors (an all-reduce twice), and
the HBM bytes by the caller's count of what the step must move.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed import sharding as SH

PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12     # bytes/s per card
LINK_BW = 25e9       # bytes/s one way of one NVLink 4 link
LINKS = 18           # NVLink 4 links per H100 SXM


@dataclasses.dataclass
class Roofline:
    """All inputs are per device (per card)."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    coll_breakdown: dict | None = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (LINKS * LINK_BW)

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def collective_bytes_of(counts: dict) -> dict:
    """Bytes by kind from a difference of ``sharding.COLLECTIVES``."""
    return {k: counts[f"{k}_bytes"] for k in SH.KINDS if f"{k}_bytes" in counts}


def from_measured(flops: float, hbm_bytes: float, coll_bytes: float, chips: int,
                  coll_breakdown: dict | None = None) -> Roofline:
    """The roofline of one step from what was measured over it (module
    docstring), per device."""
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    coll_bytes=float(coll_bytes), chips=chips, coll_breakdown=coll_breakdown)


def count_flops(fn) -> tuple[object, float]:
    """``(fn(), FLOPs)``: the floating-point operations of the PyTorch
    operators ``fn`` ran, by ``FlopCounterMode`` (a hand-written kernel
    launched outside PyTorch's operators is not seen: its caller adds its
    operations)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, float(counter.get_total_flops())


def model_flops(cfg, shape_info, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (training) or 2·N·D (decode/prefill forward),
    with N = active params for MoE."""
    n = cfg.active_param_count()
    b, s = shape_info["batch"], shape_info["seq"]
    if kind == "train":
        return 6.0 * n * b * s
    if kind == "prefill":
        return 2.0 * n * b * s
    return 2.0 * n * b  # decode: one token per sequence

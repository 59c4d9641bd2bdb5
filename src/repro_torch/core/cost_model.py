"""Analytic spill-volume and merge-level models (paper §3.5, §4.3) — the
pure-Python part of :mod:`repro.core.cost_model`, copied so the port
imports nothing of the reference.

All quantities are in rows (the paper's unit).  The calibrated layer of
the reference (``cost_surface``, per-row times keyed by device) has no
CUDA constants yet and is not part of the port.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class CostBreakdown:
    run_generation_spill: float = 0.0
    merge_spill: float = 0.0
    merge_steps: list[float] = dataclasses.field(default_factory=list)
    initial_runs: float = 0.0
    initial_run_size: float = 0.0
    merge_levels: int = 0

    @property
    def total_spill(self) -> float:
        return self.run_generation_spill + self.merge_spill

    @property
    def io_volume(self) -> float:  # write + read, the unit of Fig 23/24
        return 2.0 * self.total_spill


def ceil_log(x: float, F: int) -> int:
    """ceil(log_F(x)) robust to x being an exact power of F in floats."""
    if x <= 1:
        return 0
    return max(1, math.ceil(round(math.log(x, F), 9)))


def expected_unique(n: float, o: float) -> float:
    """E[#distinct keys among n draws from o equally-likely keys]."""
    if o <= 0:
        return 0.0
    return o * (1.0 - (1.0 - 1.0 / o) ** n)


def early_agg_run_gen(I: float, O: float, M: float, *, replacement_selection=False):
    """§3.5: with memory full of unique keys, each input row is absorbed
    with probability M/O.  Predicted spill: M + (1 − M/O)·I  (Fig 7)."""
    if O <= M:
        return 0.0, 0.0, 0.0  # spill, runs, run size
    spill = M + (1.0 - M / O) * I
    run_size = 2.0 * M if replacement_selection else M
    return spill, max(1.0, spill / run_size), run_size


def _partial_phase_steps(n: float, F: int) -> list[int]:
    """Fan-ins of the minimal merge steps reducing n runs to F (paper Ex 4:
    500 → 100 with F=100 takes one fan-in-5 step then four fan-in-100)."""
    n = int(math.ceil(n))
    if n <= F:
        return []
    red = n - F
    k = math.ceil(red / (F - 1))
    first = red - (k - 1) * (F - 1) + 1  # fan-in of the first (smallest) step
    return [first] + [F] * (k - 1)


def simulate_insort(
    I: float,
    O: float,
    M: float,
    F: int,
    *,
    early_aggregation: bool = True,
    wide_merge: bool = True,
    in_run_dedup: bool = True,
    replacement_selection: bool = False,
) -> CostBreakdown:
    """Level-by-level spill accounting for sort-based aggregation.

    Switch matrix (matching the executable variants):
      early_aggregation=False, in_run_dedup=False, wide_merge=False
          → traditional sort + in-stream aggregation (Fig 2 top)
      early_aggregation=False, in_run_dedup=True, wide_merge=False
          → duplicate removal within runs [3] (Fig 2 bottom)
      early_aggregation=True,  wide_merge=True
          → the paper's operator (§3 + §4)
    """
    cb = CostBreakdown()
    if early_aggregation:
        spill, n_runs, run_size = early_agg_run_gen(
            I, O, M, replacement_selection=replacement_selection
        )
        if spill == 0.0:
            return cb  # in-memory (Fig 6)
    elif in_run_dedup:
        run_size = expected_unique(M, O)
        n_runs = math.ceil(I / M)
        spill = n_runs * run_size
    else:
        run_size = M
        n_runs = math.ceil(I / M)
        spill = I
    cb.run_generation_spill = spill
    cb.initial_runs = n_runs
    cb.initial_run_size = run_size

    dedup = early_aggregation or in_run_dedup
    n, s = n_runs, run_size

    if wide_merge:
        # §4.3: traditional levels only while runs are smaller than O/F,
        # then one wide merge (its output streams out; no spill).
        pre = 0
        if O > M:
            pre = max(0, ceil_log(O / s, F) - 1)
        for _ in range(pre):
            if n <= 1:
                break
            n_new = math.ceil(n / F)
            s = min(s * F, O)
            if n_new >= 1 and n > 1:
                cb.merge_spill += n_new * s
                cb.merge_steps.append(n_new * s)
                cb.merge_levels += 1
            n = n_new
        if n > 1:
            cb.merge_levels += 1  # the wide merge itself (no spill)
        return cb

    # traditional merging: full levels while far from F, then minimal steps
    while n > F:
        if math.ceil(n / F) >= F:
            n_new = math.ceil(n / F)
            s_new = min(s * F, O) if dedup else s * F
            cb.merge_spill += n_new * s_new
            cb.merge_steps.append(n_new * s_new)
            cb.merge_levels += 1
            n, s = n_new, s_new
        else:
            for fan in _partial_phase_steps(n, F):
                out = min(fan * s, O) if dedup else fan * s
                cb.merge_spill += out
                cb.merge_steps.append(out)
            cb.merge_levels += 1
            n = F
            break
    cb.merge_levels += 1  # final merge (streams out, no spill)
    return cb


def simulate_hash(
    I: float, O: float, M: float, F: int, *, hybrid: bool = True
) -> CostBreakdown:
    """Hash aggregation with recursive partitioning (Examples 3/4, Fig 24).

    L = ceil(log_F(O/M)) partitioning levels; each level rewrites the
    then-remaining rows once; hybrid hashing absorbs M/O of the input
    before the first write.  Output buffers during partitioning are too
    small for meaningful early aggregation (§4.1), so no other reduction.
    """
    cb = CostBreakdown()
    if O <= M:
        return cb
    levels = ceil_log(O / M, F)
    cb.merge_levels = levels
    remaining = I * (1.0 - M / O) if hybrid else I
    for _ in range(levels):
        cb.merge_spill += remaining
        cb.merge_steps.append(remaining)
        # partitions only shrink once their output fits memory (final level)
    cb.run_generation_spill = 0.0
    return cb


def merge_levels_insort(O: float, M: float, F: int) -> int:
    """§4.3: output-driven merge depth ceil(log_F(O/M)) (0 if O ≤ M)."""
    if O <= M:
        return 0
    return ceil_log(O / M, F)

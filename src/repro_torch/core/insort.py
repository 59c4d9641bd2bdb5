"""The paper's full operator — early aggregation during run generation
(§3) + wide merging (§4) — counterpart of :mod:`repro.core.insort`.

Merge planning follows §4.3: traditional merge levels only while a merge
step's input is smaller than the output O, then one wide merge:
``pre_levels = max(0, ceil(log_F(O / M)) - 1)``.
"""
from __future__ import annotations

from repro_torch.core.cost_model import ceil_log
from repro_torch.core.types import AggState, ExecConfig, SpillStats


def plan_pre_merge_levels(output_estimate: int, cfg: ExecConfig, num_runs: int) -> int:
    """§4.3 policy: number of traditional merge levels before the wide merge."""
    M, F = cfg.memory_rows, cfg.fanin
    levels = 0 if output_estimate <= M else max(0, ceil_log(output_estimate / M, F) - 1)
    max_useful = ceil_log(num_runs, F) if num_runs > 1 else 0
    return min(levels, max_useful)


def insort_aggregate(keys, payload=None, cfg: ExecConfig | None = None, *,
                     output_estimate: int | None = None, backend: str = "auto",
                     widths=None, pipeline: str = "device",
                     device="cuda") -> tuple[AggState, SpillStats]:
    """Group/aggregate an unsorted stream under a memory budget of M rows;
    returns (sorted aggregate state, exact spill accounting).

    Only the device pipeline is ported (replacement selection, pre-merge
    levels, wide merge); the reference's switches to its baselines
    (``early_aggregation``, ``use_wide_merge``, ``run_policy``) and the
    host loop wait in ROADMAP."""
    if pipeline not in ("host", "device"):
        raise ValueError(f"unknown pipeline {pipeline!r}; expected host|device")
    if pipeline == "host":
        raise NotImplementedError(
            "pipeline='host' (the host-loop reference path) is not ported yet; "
            "see ROADMAP Queue 1, 'host-loop reference path'"
        )
    from repro_torch.core import pipeline as pipeline_mod

    return pipeline_mod.insort_aggregate_device(
        keys, payload, cfg or ExecConfig(), policy="rs", backend=backend, widths=widths,
        output_estimate=output_estimate, device=device,
    )

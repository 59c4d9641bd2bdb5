"""The paper's full operator — early aggregation during run generation
(§3) + wide merging (§4) — and its sort-based baselines (counterpart of
:mod:`repro.core.insort`).

Merge planning follows §4.3: traditional merge levels only while a merge
step's input is smaller than the output O, then one wide merge:
``pre_levels = max(0, ceil(log_F(O / M)) - 1)``.  O comes from an
estimate when given; a wrong estimate shifts work between merge styles
and never changes the answer.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import dispatch
from repro_torch.core import merge as merge_mod
from repro_torch.core import run_generation as rg
from repro_torch.core import sorted_ops
from repro_torch.core.cost_model import ceil_log
from repro_torch.core.types import (
    AggState,
    ExecConfig,
    SpillStats,
    canon_keys,
    canon_payload,
    keys_to_torch,
    resolve_device,
)


def plan_pre_merge_levels(output_estimate: int, cfg: ExecConfig, num_runs: int) -> int:
    """§4.3 policy: number of traditional merge levels before the wide merge."""
    M, F = cfg.memory_rows, cfg.fanin
    levels = 0 if output_estimate <= M else max(0, ceil_log(output_estimate / M, F) - 1)
    max_useful = ceil_log(num_runs, F) if num_runs > 1 else 0
    return min(levels, max_useful)


def insort_aggregate(keys, payload=None, cfg: ExecConfig | None = None, *,
                     output_estimate: int | None = None, early_aggregation: bool = True,
                     use_wide_merge: bool = True, run_policy: str = "rs",
                     backend: str = "auto", widths=None, pipeline: str = "device",
                     mesh=None, mesh_axis: str | None = None,
                     device="cuda") -> tuple[AggState, SpillStats]:
    """Group/aggregate an unsorted input under a memory budget of M rows;
    returns (sorted aggregate state, exact spill accounting).

    The flags switch the paper's two techniques off to recover the
    baselines of Fig 2: ``early_aggregation=False`` writes runs with the
    duplicates of each run combined (in-run dedup), ``use_wide_merge=False``
    merges with traditional F-way levels only.  ``run_policy="rs"`` is
    replacement selection; any other value with early aggregation is the
    read-sort-write ``early_agg`` policy.

    ``pipeline="device"`` (the default here) runs the device pipeline of
    :mod:`repro_torch.core.pipeline`; ``"host"`` the reference loop with
    the paper's per-level accounting.  Plans the device pipeline cannot
    express (``use_wide_merge=False``) always take the host loop.

    ``mesh`` shards the device pipeline over the ranks of a
    :class:`repro_torch.distributed.sharding.Mesh` (every rank passes its
    own rows; per-rank run generation, then the key-range exchange); it
    needs ``pipeline="device"`` with the wide merge."""
    cfg = cfg or ExecConfig()
    if pipeline not in ("host", "device"):
        raise ValueError(f"unknown pipeline {pipeline!r}; expected host|device")
    if mesh is not None and not (pipeline == "device" and use_wide_merge):
        raise ValueError("mesh-sharded aggregation requires pipeline='device' with the wide "
                         "merge enabled (the host loop is single-device)")
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    if pipeline == "device" and use_wide_merge:
        from repro_torch.core import pipeline as pipeline_mod

        if early_aggregation:
            policy = "rs" if run_policy == "rs" else "early_agg"
        else:
            policy = "inrun_dedup"
        return pipeline_mod.insort_aggregate_device(
            keys, payload, cfg, policy=policy, backend=backend, widths=widths,
            output_estimate=output_estimate, mesh=mesh, mesh_axis=mesh_axis, device=dev,
        )
    keys = canon_keys(keys)
    if early_aggregation and run_policy == "rs":
        # replacement selection via the ordered index (§3.3): runs up to 2M
        runs, table, stats = rg.generate_runs_rs(keys, payload, cfg, backend=backend,
                                                 widths=widths, device=dev)
    else:
        policy = "early_agg" if early_aggregation else "inrun_dedup"
        runs, table, stats = rg.generate_runs(keys, payload, cfg, policy=policy,
                                              backend=backend, widths=widths, device=dev)
    if table is not None:  # in memory (Fig 6): nothing spilled
        return table, stats
    if output_estimate is None:
        # assume strong reduction, the case the paper optimizes; the answer
        # never depends on it
        output_estimate = cfg.memory_rows * cfg.fanin
    if not use_wide_merge:
        out = merge_mod.final_merge_traditional(runs, cfg, aggregate=True, stats=stats,
                                                backend=backend)
        return out, stats
    pre = plan_pre_merge_levels(output_estimate, cfg, len(runs))
    for _ in range(pre):
        if len(runs) <= 1:
            break
        runs = merge_mod.traditional_merge(
            runs, cfg, aggregate_during_merge=True, stats=stats, backend=backend,
            stop_at=max(1, math.ceil(len(runs) / cfg.fanin)))
    if len(runs) == 1:  # one aggregated run already: stream it out
        return runs[0].state, stats
    return merge_mod.wide_merge(runs, cfg, stats=stats, backend=backend), stats


def sort_then_stream_aggregate(keys, payload=None, cfg: ExecConfig | None = None, *,
                               backend: str = "auto",
                               device="cuda") -> tuple[AggState, SpillStats]:
    """Baseline of Fig 2 (top): a full external merge sort of the raw
    input, then aggregation of the sorted stream.  Spill grows with the
    input at every merge level, the paper's worst case."""
    cfg = cfg or ExecConfig()
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    keys = canon_keys(keys)
    if keys.shape[0] <= cfg.memory_rows:  # an in-memory sort: no spill
        payload = canon_payload(payload)
        pt = None if payload is None else torch.from_numpy(payload).to(dev)
        return sorted_ops.sorted_groupby(keys_to_torch(keys, dev), pt, key_dtype=keys.dtype,
                                         backend=backend), SpillStats()
    runs, _, stats = rg.generate_runs(keys, payload, cfg, policy="traditional",
                                      backend=backend, device=dev)
    out = merge_mod.final_merge_traditional(runs, cfg, aggregate=False, stats=stats,
                                            backend=backend)
    return out, stats

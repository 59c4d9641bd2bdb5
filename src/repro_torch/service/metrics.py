"""Host-side metrics facade for the aggregation service (a copy of the
pure-Python :mod:`repro.service.metrics`, so the port imports nothing of
the reference).

Everything here is a plain Python counter updated from numbers the host
already knows (chunk row counts) or reads back anyway at snapshot
boundaries (the one :meth:`~repro_torch.core.types.DeviceSpillStats.finalize`
readback).  Nothing in this module touches the device: the metrics add no
readback to the ingest path.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import SpillStats


def _quantile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank quantile over an already sorted list (0 when empty)."""
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, int(q * len(sorted_values)))
    return sorted_values[idx]


@dataclasses.dataclass
class ServiceMetrics:
    """Running counters of one service/session lifetime.

    ``duplicate_rate`` is the observed fraction of ingested rows that
    collapsed into an existing group as of the last snapshot
    (``1 - groups/rows``) — the signal the hash-vs-sort literature uses
    to pick a policy, surfaced here so an operator can re-provision a
    long-lived session.  With eviction active it is computed over the
    cumulative ingest and is therefore an upper bound (retired groups
    no longer count toward ``groups``).
    """

    rows_ingested: int = 0
    chunks_ingested: int = 0
    snapshots_taken: int = 0
    rows_retired: int = 0
    groups_last_snapshot: int = 0
    duplicate_rate: float = 0.0
    max_index_occupancy: int = 0
    runs_generated: int = 0
    rows_spilled: int = 0
    # adaptive-policy telemetry (zero / empty for fixed-policy sessions):
    # the governor's switch events, the O(stream/k) scalar readbacks it
    # paid, and the arm the next ingest will run under
    policy_switches: int = 0
    readbacks_paid: int = 0
    current_policy: str = ""
    policy_events: list[dict] = dataclasses.field(default_factory=list)
    snapshot_latencies_s: list[float] = dataclasses.field(
        default_factory=list)

    # -- update hooks ----------------------------------------------------

    def observe_ingest(self, rows: int) -> None:
        """Record one ingested chunk (host-known row count, no sync)."""
        self.rows_ingested += int(rows)
        self.chunks_ingested += 1

    def observe_snapshot(self, stats: SpillStats, *, groups: int,
                         seconds: float) -> None:
        """Fold one snapshot's (already read back) stats in."""
        self.snapshots_taken += 1
        self.groups_last_snapshot = int(groups)
        self.rows_retired = int(stats.rows_retired)
        self.max_index_occupancy = max(
            self.max_index_occupancy, int(stats.max_index_occupancy))
        self.runs_generated = int(stats.runs_generated)
        self.rows_spilled = int(stats.rows_spilled_run_generation)
        if self.rows_ingested:
            self.duplicate_rate = max(
                0.0, 1.0 - groups / self.rows_ingested)
        self.snapshot_latencies_s.append(float(seconds))

    def observe_policy(self, events: list[dict], *, readbacks: int,
                       current: str) -> None:
        """Fold in the engine's policy-governor telemetry (host-known —
        the events were recorded when the governor's readbacks already
        happened, so this adds no device traffic)."""
        self.policy_events = list(events)
        self.policy_switches = len(self.policy_events)
        self.readbacks_paid = int(readbacks)
        self.current_policy = str(current)

    # -- derived views ---------------------------------------------------

    def snapshot_latency_s(self, q: float) -> float:
        """Latency quantile (e.g. ``q=0.5`` / ``q=0.99``) over every
        snapshot taken so far."""
        return _quantile(sorted(self.snapshot_latencies_s), q)

    def summary(self) -> dict:
        """One flat dict for logs / JSON reports."""
        return {
            "rows_ingested": self.rows_ingested,
            "chunks_ingested": self.chunks_ingested,
            "snapshots_taken": self.snapshots_taken,
            "rows_retired": self.rows_retired,
            "groups_last_snapshot": self.groups_last_snapshot,
            "duplicate_rate": round(self.duplicate_rate, 4),
            "max_index_occupancy": self.max_index_occupancy,
            "runs_generated": self.runs_generated,
            "rows_spilled": self.rows_spilled,
            "policy_switches": self.policy_switches,
            "readbacks_paid": self.readbacks_paid,
            "current_policy": self.current_policy,
            "snapshot_p50_s": self.snapshot_latency_s(0.5),
            "snapshot_p99_s": self.snapshot_latency_s(0.99),
        }

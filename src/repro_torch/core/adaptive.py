"""Mid-flight policy governor for the streamed aggregation pipeline (the
port's copy of the pure-Python :mod:`repro.core.adaptive`).

The paper's claim that the in-sort operator "always performs at least
as well" holds for *volume*; which run-generation policy wins in
*seconds* is machine- and skew-dependent (the hash-vs-sort empirical
study in PAPERS.md).  Instead of trusting a pre-execution estimate, the
streamed pipeline observes the ground truth as it runs — rows absorbed,
duplicate rows and run-slot occupancy live in the engine's state — and
this governor re-decides the policy between chunks using the calibrated
cost model (:mod:`repro_torch.core.cost_model`).  A wrong initial
guess then costs one observation window, not the whole query.

Mechanics: every ``interval`` chunks the governor takes ONE observation
(counted in ``SpillStats.readbacks_paid`` as the reference counts its
scalar readback: O(stream / interval)).  The governor
computes the duplicate rate over the window since its last decision,
asks :func:`repro_torch.core.cost_model.choose_policy` which arm is cheapest
at that rate, and switches when the predicted advantage clears a
hysteresis band (switching flushes the resident window as one sorted
run, so flapping has a real cost — the band keeps the governor from
paying it on noise).

Every decision is recorded in ``PolicyGovernor.events`` with the path
taken (``"start" | "hold" | "hysteresis" | "small_window" | "switch"``)
so tests can assert each decision path was actually exercised.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cost_model
from repro_torch.core.types import ExecConfig

#: arms the governor switches between.  ``inrun_dedup`` is deliberately
#: not an arm: it pays the per-batch sort AND the dedup without keeping
#: a persistent window, so it can't win either regime (traditional wins
#: unique-heavy input, early_agg wins duplicate-heavy input).
ARMS = ("early_agg", "rs", "traditional")


@dataclasses.dataclass(frozen=True)
class Observation:
    """One readback of the engine's device-side observation block
    (cumulative since stream start)."""

    rows_absorbed: int
    dup_rows: int
    rows_spilled: int
    table_rows: int
    run_slots_used: int

    @property
    def duplicate_rate(self) -> float:
        if self.rows_absorbed <= 0:
            return 0.0
        return self.dup_rows / self.rows_absorbed


@dataclasses.dataclass
class GovernorConfig:
    """Knobs for :class:`PolicyGovernor`.

    ``interval_chunks``: decide every k-th absorbed chunk (the k in the
    O(stream/k) readback contract).  ``hysteresis``: relative per-row
    cost advantage the challenger must show before a switch is paid.
    ``min_window_rows``: below this many rows since the last decision
    the duplicate-rate estimate is noise — hold.  ``start``: force the
    opening arm (None → ask the cost model).  ``arms``: the candidate
    set.  ``merge_levels``: spill amortization depth fed to the cost
    model (defaults to one pre-merge level).  ``constants`` injects a
    constants entry; otherwise ``backend``, a torch device type, picks the
    committed entry (``"cuda"`` for a card, ``"cpu"`` for any other
    device)."""

    interval_chunks: int = 4
    hysteresis: float = 0.10
    min_window_rows: int = 256
    start: str | None = None
    arms: tuple = ARMS
    merge_levels: int = 1
    constants: dict | None = None
    backend: str | None = None

    def __post_init__(self):
        if self.interval_chunks < 1:
            raise ValueError(
                f"interval_chunks must be >= 1, got {self.interval_chunks}"
            )
        bad = [a for a in self.arms if a not in ARMS]
        if bad:
            raise ValueError(f"unknown governor arms {bad}; choose from {ARMS}")
        if self.start is not None and self.start not in self.arms:
            raise ValueError(
                f"start arm {self.start!r} not in arms {self.arms}"
            )


class PolicyGovernor:
    """Decides which run-generation policy the next chunks should use.

    Stateless w.r.t. the device — it only ever sees the cumulative
    :class:`Observation` the pipeline reads back — and deterministic
    given the calibrated constants, which is what makes every decision
    path unit-testable with injected constants."""

    def __init__(self, cfg: ExecConfig, config: GovernorConfig | dict | None = None):
        if config is None:
            config = GovernorConfig()
        elif isinstance(config, dict):
            config = GovernorConfig(**config)
        self.cfg = cfg
        self.config = config
        self.events: list[dict] = []
        self._constants = (
            config.constants
            if config.constants is not None
            else cost_model.load_cost_constants(config.backend)
        )
        self._prev: Observation | None = None

    @property
    def interval(self) -> int:
        return self.config.interval_chunks

    def _choose(self, dup_rate: float) -> str:
        return cost_model.choose_policy(
            dup_rate,
            arms=self.config.arms,
            constants=self._constants,
            merge_levels=self.config.merge_levels,
        )

    def _cost(self, arm: str, dup_rate: float) -> float:
        return cost_model.policy_cost_per_row(
            arm,
            dup_rate,
            constants=self._constants,
            merge_levels=self.config.merge_levels,
        )

    def start_arm(self, output_estimate: int | None = None) -> str:
        """The opening arm, before any observation exists.  With an
        output estimate the prior duplicate rate is derived the same way
        the planner does it; otherwise an agnostic 0.5 prior."""
        if self.config.start is not None:
            arm = self.config.start
            prior = None
        else:
            prior = 0.5
            if output_estimate and output_estimate > 0:
                # O unique keys across ~O·F input rows is the planner's
                # memory-pressure prior; without N we only know O, so
                # treat the estimate as "output fits the merge fan-in".
                n_guess = output_estimate * self.cfg.fanin
                prior = min(1.0, max(0.0, 1.0 - output_estimate / n_guess))
            arm = self._choose(prior)
        self.events.append(
            {"path": "start", "arm": arm, "prior_dup_rate": prior}
        )
        return arm

    def decide(self, obs: Observation, current: str) -> str:
        """The arm the NEXT chunks should run under, given the latest
        cumulative observation.  Appends one event per call."""
        prev = self._prev
        self._prev = obs
        window_rows = obs.rows_absorbed - (prev.rows_absorbed if prev else 0)
        window_dups = obs.dup_rows - (prev.dup_rows if prev else 0)
        if window_rows < self.config.min_window_rows:
            self.events.append(
                {"path": "small_window", "arm": current,
                 "window_rows": window_rows}
            )
            return current
        d = min(1.0, max(0.0, window_dups / window_rows))
        best = self._choose(d)
        if best == current:
            self.events.append(
                {"path": "hold", "arm": current, "window_dup_rate": d}
            )
            return current
        cur_cost = self._cost(current, d)
        best_cost = self._cost(best, d)
        advantage = (cur_cost - best_cost) / cur_cost if cur_cost > 0 else 0.0
        if advantage < self.config.hysteresis:
            self.events.append(
                {"path": "hysteresis", "arm": current, "challenger": best,
                 "window_dup_rate": d, "advantage": advantage}
            )
            return current
        self.events.append(
            {"path": "switch", "arm": best, "from": current,
             "window_dup_rate": d, "advantage": advantage}
        )
        return best

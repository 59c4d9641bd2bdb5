"""Analytic spill-volume and merge-level models (paper §3.5, §4.3,
Examples 3–5, Figs 7, 23, 24) and their calibrated layer — a copy of the
pure-Python :mod:`repro.core.cost_model`, so the port imports nothing of
the reference.

All quantities are in rows (the paper's unit).  The calibrated layer
(per-row times from ``core/_cost_constants.py``, the port's own copy of
the reference's committed table) turns them into seconds for the plan's
``cost_model`` entry.  The table is keyed by the torch device type; it
holds a ``"cpu"`` entry only, which every device falls back to, so the
times it gives for a card are the CPU's.
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


def merge_levels_traditional(I: float, M: float, F: int) -> int:
    """Input-driven merge depth of a traditional external sort."""
    runs = math.ceil(I / M)
    if runs <= 1:
        return 0
    return ceil_log(runs, F)


# ---------------------------------------------------------------------------
# calibrated layer: measured per-row constants + fitted crossover surface
# ---------------------------------------------------------------------------
#
# Everything above is the paper's *volume* arithmetic (rows spilled,
# merge levels) — machine-independent by construction.  The layer below
# attaches measured per-row times from ``core/_cost_constants.py``
# so the planner can compare policies in seconds on one machine, which
# is what the hash-vs-sort empirical study says cannot be hand-set.  The
# table is keyed by the torch device type (``"cpu"``, ``"cuda"``); a
# device without an entry falls back to the committed ``"cpu"`` one.

COST_SCHEMA_VERSION = 1
COST_FIELDS = (
    "absorb_row_ns",
    "absorb_dup_row_ns",
    "sort_row_ns",
    "merge_row_ns",
    "hash_probe_row_ns",
    "spill_write_row_ns",
)
#: per-policy absorb fields are measured at two duplicate-rate anchors
#: (unique input ≈ d=0, heavy-duplicate input ≈ d=1) and interpolated.
ABSORB_FIELDS = ("absorb_row_ns", "absorb_dup_row_ns")
ABSORB_POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")

#: policies whose absorb step sorts each incoming batch from scratch —
#: these get the zero-sort-term credit when the input is already ordered.
SORTING_POLICIES = ("traditional", "inrun_dedup")


class StaleConstantsError(ValueError):
    """``core/_cost_constants.py`` does not match the generator schema."""


def validate_constants(table: dict, *, source: str = "core/_cost_constants.py"):
    """Check a ``COST_CONSTANTS``-shaped table against the generator
    schema; raises :class:`StaleConstantsError` naming every problem."""
    problems = []
    if not isinstance(table, dict) or not table:
        problems.append("top level must be a non-empty dict of backend entries")
        table = {}
    for backend, entry in table.items():
        where = f"{source}[{backend!r}]"
        if not isinstance(entry, dict):
            problems.append(f"{where}: entry must be a dict")
            continue
        ver = entry.get("schema_version")
        if ver != COST_SCHEMA_VERSION:
            problems.append(
                f"{where}: schema_version={ver!r}, generator writes "
                f"{COST_SCHEMA_VERSION}"
            )
        for field in COST_FIELDS:
            if field not in entry:
                problems.append(f"{where}: missing field {field!r}")
            elif field in ABSORB_FIELDS:
                sub = entry[field]
                missing = [p for p in ABSORB_POLICIES if p not in sub] \
                    if isinstance(sub, dict) else list(ABSORB_POLICIES)
                if missing:
                    problems.append(
                        f"{where}: {field} missing policies {missing}"
                    )
                else:
                    bad = [p for p in ABSORB_POLICIES
                           if not (float(sub[p]) > 0.0)]
                    if bad:
                        problems.append(
                            f"{where}: {field} non-positive for {bad}"
                        )
            elif not (float(entry[field]) >= 0.0):
                problems.append(f"{where}: {field} must be >= 0")
    if problems:
        raise StaleConstantsError(
            "stale/invalid cost constants:\n  "
            + "\n  ".join(problems)
        )


def load_cost_constants(backend: str | None = None) -> dict:
    """The calibrated constants entry for the torch device type ``backend``
    (the committed ``cpu`` entry for a device without one)."""
    from repro_torch.core import _cost_constants as cc

    validate_constants(cc.COST_CONSTANTS)
    table = cc.COST_CONSTANTS
    if backend in table:
        return table[backend]
    return table["cpu"]


def _spill_fraction(policy: str, dup_rate: float) -> float:
    """Fraction of absorbed rows the run-generation phase spills.  The
    traditional sort spills every row; the deduplicating policies spill
    only the rows their window fails to absorb (§3.5 first-order: the
    duplicate fraction is absorbed)."""
    d = min(1.0, max(0.0, dup_rate))
    if policy == "traditional":
        return 1.0
    return 1.0 - d


def policy_cost_per_row(
    policy: str,
    dup_rate: float,
    *,
    constants: dict | None = None,
    backend: str | None = None,
    merge_levels: int = 1,
    input_sorted: bool = False,
) -> float:
    """Calibrated per-input-row cost (ns) of running the pipeline under
    ``policy`` at the given duplicate rate.

    ``cost(d) = absorb + spill_frac(d) · (spill_write + merge · levels)``

    ``input_sorted=True`` credits an upstream-established key order with
    a zero sort term: the batch-sorting policies' absorb cost drops by
    the measured ``sort_row_ns`` (an upstream ``aggregate`` emits
    key-sorted relations, so re-sorting them is pure waste).
    """
    c = constants if constants is not None else load_cost_constants(backend)
    d = min(1.0, max(0.0, dup_rate))
    a0 = float(c["absorb_row_ns"][policy])
    a1 = float(c["absorb_dup_row_ns"][policy])
    absorb = a0 + d * (a1 - a0)
    if input_sorted and policy in SORTING_POLICIES:
        absorb = max(0.0, absorb - float(c["sort_row_ns"]))
    per_spilled = float(c["spill_write_row_ns"]) + float(c["merge_row_ns"]) * max(
        0, merge_levels
    )
    return absorb + _spill_fraction(policy, dup_rate) * per_spilled


def choose_policy(
    dup_rate: float,
    *,
    arms=("traditional", "early_agg", "rs"),
    constants: dict | None = None,
    backend: str | None = None,
    merge_levels: int = 1,
    input_sorted: bool = False,
) -> str:
    """argmin over ``arms`` of :func:`policy_cost_per_row`."""
    c = constants if constants is not None else load_cost_constants(backend)
    return min(
        arms,
        key=lambda p: policy_cost_per_row(
            p, dup_rate, constants=c, merge_levels=merge_levels,
            input_sorted=input_sorted,
        ),
    )


def crossover_dup_rate(
    a: str = "traditional",
    b: str = "early_agg",
    *,
    constants: dict | None = None,
    backend: str | None = None,
    merge_levels: int = 1,
    input_sorted: bool = False,
) -> float:
    """The duplicate rate at which policy ``b`` starts beating policy
    ``a`` (clamped to [0, 1]).  With the default pair this is the fitted
    machine-specific hash-vs-sort-style crossover surface: below it the
    cheap-absorb policy wins, above it the deduplicating window pays for
    itself."""
    c = constants if constants is not None else load_cost_constants(backend)

    def cost(p, d):
        return policy_cost_per_row(
            p, d, constants=c, merge_levels=merge_levels,
            input_sorted=input_sorted,
        )

    # cost_p(d) is linear in d, so solve cost_a(d) == cost_b(d) exactly.
    a0, a1 = cost(a, 0.0), cost(a, 1.0)
    b0, b1 = cost(b, 0.0), cost(b, 1.0)
    denom = (a1 - a0) - (b1 - b0)
    if denom == 0.0:
        return 0.0 if b0 <= a0 else 1.0
    d = (b0 - a0) / denom
    return min(1.0, max(0.0, d))


def estimate_seconds(
    policy: str,
    n_rows: float,
    dup_rate: float,
    *,
    constants: dict | None = None,
    backend: str | None = None,
    merge_levels: int = 1,
    input_sorted: bool = False,
) -> float:
    """End-to-end predicted wall time for ``n_rows`` under ``policy``."""
    return (
        policy_cost_per_row(
            policy, dup_rate, constants=constants, backend=backend,
            merge_levels=merge_levels, input_sorted=input_sorted,
        )
        * n_rows
        * 1e-9
    )


def cost_surface(
    n_rows: float,
    output_estimate: float,
    *,
    backend: str | None = None,
    merge_levels: int = 1,
    input_sorted: bool = False,
) -> dict:
    """The fitted decision surface, as surfaced in ``AggResult.plan``."""
    c = load_cost_constants(backend)
    d_est = 0.0
    if n_rows > 0 and output_estimate > 0:
        d_est = min(1.0, max(0.0, 1.0 - output_estimate / n_rows))
    kw = dict(constants=c, merge_levels=merge_levels, input_sorted=input_sorted)
    return {
        "calibrated_backend": c["meta"].get("backend", "cpu")
        if isinstance(c.get("meta"), dict) else "cpu",
        "schema_version": c["schema_version"],
        "input_sorted": input_sorted,
        "estimated_dup_rate": d_est,
        "crossover_dup_rate": crossover_dup_rate(**kw),
        "policy_cost_ns_per_row": {
            p: policy_cost_per_row(p, d_est, **kw)
            for p in ("traditional", "early_agg", "rs")
        },
        "chosen_policy": choose_policy(d_est, **kw),
    }


def join_cost_surface(
    n_left: float,
    n_right: float,
    *,
    inputs_sorted: bool = True,
    backend: str | None = None,
) -> dict:
    """Calibrated cost picture of a two-sided join, as surfaced in
    ``JoinResult.plan["cost_model"]``.

    The merge join itself is one rank-alignment probe over already-sorted
    inputs; what varies is the **order-enforcement** term: a join whose
    inputs arrive sorted (``inputs_sorted=True`` — every upstream
    ``aggregate`` emits key-sorted relations) pays a ZERO sort
    term (``sort_rows == 0``), while re-sorting both sides first pays
    ``sort_row_ns`` per input row.  ``sort_ns_avoided`` makes the credit
    explicit — it is the order-enforcement cost the composed pipeline
    never pays.
    The hash-join baseline (build + probe at ``hash_probe_row_ns``) is
    included for the optimizer-style comparison.
    """
    c = load_cost_constants(backend)
    sort_ns = float(c["sort_row_ns"])
    merge_ns = float(c["merge_row_ns"])
    hash_ns = float(c["hash_probe_row_ns"])
    n = float(n_left) + float(n_right)
    sort_rows = 0.0 if inputs_sorted else n
    probe_ns = merge_ns * float(n_left)
    return {
        "inputs_sorted": inputs_sorted,
        "sort_rows": sort_rows,
        "sort_ns": sort_ns * sort_rows,
        "sort_ns_avoided": sort_ns * n if inputs_sorted else 0.0,
        "probe_ns": probe_ns,
        "merge_join_ns": sort_ns * sort_rows + probe_ns,
        "hash_join_ns": hash_ns * n,
    }


def fig24_curves(
    I: float = 100e6, M: float = 100e3, F: int = 10, points: int = 25
):
    """Revised algorithm comparison (Fig 24): I/O volume vs reduction factor.

    Returns (reduction_factors, io_sort_early3, io_hash_hybrid, io_insort).
    Row ≡ byte here (the paper plots MB with these same parameters).
    """
    out = ([], [], [], [])
    for i in range(points):
        red = 10 ** (3.0 * i / (points - 1))  # 1 … 1000
        O = I / red
        a = simulate_insort(
            I, O, M, F, early_aggregation=False, in_run_dedup=True, wide_merge=False
        ).io_volume
        b = simulate_hash(I, O, M, F, hybrid=True).io_volume
        c = simulate_insort(I, O, M, F, early_aggregation=True, wide_merge=True).io_volume
        out[0].append(red)
        out[1].append(a)
        out[2].append(b)
        out[3].append(c)
    return out

"""Schema front door of the port (counterpart of :mod:`repro.core.schema`):
composite keys (:class:`KeySpec`), declarative aggregates
(:class:`AggSpec`), the one-shot :func:`aggregate` entry point, and the
operators that consume its key order: :meth:`AggResult.merge_join`
(→ :class:`JoinResult`), :meth:`AggResult.rollup`,
:meth:`JoinResult.rollup`, the module-level :func:`rollup` and
:func:`pipeline`.

``KeySpec.pack``/``unpack``/``shift_of``/``prefix`` are NumPy code copied
from the reference, so the port imports nothing of it.  One-shot input
runs every algorithm of the reference (the in-sort operator on the device
pipeline or the host loop, the hash, F1-hash, sort-then-stream and
in-memory baselines); streamed input and the mesh wait in ROADMAP.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model, dispatch, sorted_ops
from repro_torch.core import merge_join as mj_mod
from repro_torch.core.types import (
    INT64_MIN,
    AggState,
    ExecConfig,
    SpillStats,
    host_ints,
    key_dtype_for_bits,
    keys_to_numpy,
    resolve_device,
    zero_key,
)

_EMPTY_NP = {
    np.dtype(np.uint32): np.uint32(0xFFFFFFFF),
    np.dtype(np.uint64): np.uint64(0xFFFFFFFFFFFFFFFF),
}


# ---------------------------------------------------------------------------
# KeySpec — composite sort keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KeyColumn:
    """One named integer key column occupying ``bits`` bits of the packed
    key.  Values must lie in ``[0, 2**bits)``."""

    name: str
    bits: int

    def __post_init__(self):
        if not self.name:
            raise ValueError("key column needs a name")
        if not 1 <= self.bits <= 64:
            raise ValueError(f"column {self.name!r}: bits must be in [1, 64]")

    @property
    def max_value(self) -> int:
        return (1 << self.bits) - 1


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """An ordered list of key columns, major (most significant) first.

    ``KeySpec.of(year=23, month=4, day=5)`` packs ``(year << 9) |
    (month << 5) | day`` into a uint32; totals over 32 bits widen to
    uint64 (the paper's composite keys stop competing for 32 bits).  The
    packed EMPTY sentinel (all ones) is reserved: the all-max column
    combination is rejected by :meth:`pack`.
    """

    columns: tuple[KeyColumn, ...]

    def __post_init__(self):
        if not self.columns:
            raise ValueError("KeySpec needs at least one column")
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate key column names: {names}")
        if self.total_bits > 64:
            raise ValueError(
                f"composite key needs {self.total_bits} bits; the engine "
                "supports at most 64"
            )

    # -- construction ----------------------------------------------------
    @classmethod
    def of(cls, **bits_by_name: int) -> "KeySpec":
        """``KeySpec.of(year=23, month=4, day=5)`` — order is significance
        order, major first (Python keeps kwargs ordered)."""
        return cls(tuple(KeyColumn(n, b) for n, b in bits_by_name.items()))

    # -- properties ------------------------------------------------------
    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def total_bits(self) -> int:
        return sum(c.bits for c in self.columns)

    @property
    def key_dtype(self) -> np.dtype:
        return key_dtype_for_bits(self.total_bits)

    @property
    def empty(self) -> np.unsignedinteger:
        return _EMPTY_NP[self.key_dtype]

    def shift_of(self, name: str) -> int:
        """Bit position of a column's least-significant bit in the packed key."""
        shift = 0
        for c in reversed(self.columns):
            if c.name == name:
                return shift
            shift += c.bits
        raise KeyError(f"no key column {name!r} in {self.names}")

    def prefix(self, n: int) -> "KeySpec":
        """The KeySpec of the first (most significant) ``n`` columns."""
        if not 1 <= n <= len(self.columns):
            raise ValueError(f"prefix length {n} not in [1, {len(self.columns)}]")
        return KeySpec(self.columns[:n])

    # -- packing ---------------------------------------------------------
    def _as_columns(self, columns) -> list[np.ndarray]:
        if isinstance(columns, Mapping):
            missing = [n for n in self.names if n not in columns]
            if missing:
                raise KeyError(f"missing key columns: {missing}")
            cols = [columns[n] for n in self.names]
        else:
            cols = list(columns)
            if len(cols) != len(self.columns):
                raise ValueError(
                    f"expected {len(self.columns)} key columns, got {len(cols)}"
                )
        return [np.asarray(c) for c in cols]

    def pack(self, columns, *, validate: bool = True) -> np.ndarray:
        """Pack named columns (mapping or significance-ordered sequence)
        into one sort-key vector of :attr:`key_dtype`.

        Packing happens host-side in NumPy — uint64 needs no JAX x64
        flag here.  ``validate=True`` checks every column against its bit
        budget and rejects the reserved EMPTY bit pattern.
        """
        cols = self._as_columns(columns)
        out = np.zeros(cols[0].shape, dtype=np.uint64)
        for spec, col in zip(self.columns, cols):
            col = col.astype(np.uint64)
            if validate and col.size and int(col.max()) > spec.max_value:
                raise ValueError(
                    f"column {spec.name!r} exceeds its {spec.bits}-bit budget "
                    f"(max value {int(col.max())} > {spec.max_value})"
                )
            out = (out << np.uint64(spec.bits)) | col
        packed = out.astype(self.key_dtype)
        if validate and packed.size and bool((packed == self.empty).any()):
            raise ValueError(
                "the all-ones column combination packs to the reserved EMPTY "
                "sentinel; reduce a column's max value or widen a column"
            )
        return packed

    def unpack(self, keys) -> dict[str, np.ndarray]:
        """Packed keys → named columns (EMPTY rows map to all-max columns)."""
        keys = np.asarray(keys).astype(np.uint64)
        out: dict[str, np.ndarray] = {}
        shift = 0
        for c in reversed(self.columns):
            mask = np.uint64((1 << c.bits) - 1)
            out[c.name] = ((keys >> np.uint64(shift)) & mask).astype(
                np.uint32 if c.bits <= 32 else np.uint64
            )
            shift += c.bits
        return {n: out[n] for n in self.names}


# ---------------------------------------------------------------------------
# AggSpec — declarative aggregates
# ---------------------------------------------------------------------------

_FINALIZERS = {"avg": ("sum", "count")}
_STORED = ("count", "sum", "min", "max")
_KNOWN = set(_STORED) | set(_FINALIZERS)


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """The requested aggregates: any of count/sum/min/max plus ``avg``
    (sum/count).  The accumulator carries only the planes they need."""

    names: tuple[str, ...]

    def __init__(self, *names: str):
        if len(names) == 1 and isinstance(names[0], (tuple, list)):
            names = tuple(names[0])
        if not names:
            names = ("count",)
        unknown = [n for n in names if n not in _KNOWN]
        if unknown:
            raise ValueError(f"unknown aggregates {unknown}; known: {sorted(_KNOWN)}")
        object.__setattr__(self, "names", tuple(dict.fromkeys(names)))

    @property
    def stored(self) -> tuple[str, ...]:
        need = set()
        for n in self.names:
            need.update(_FINALIZERS.get(n, (n,)))
        return tuple(n for n in _STORED if n in need or n == "count")

    def plane_widths(self, payload_width: int) -> tuple[int, int, int]:
        stored = self.stored
        return tuple(payload_width if p in stored else 0 for p in ("sum", "min", "max"))

    def needs_payload(self) -> bool:
        return any(self.plane_widths(1))

    def finalize(self, state: AggState) -> dict[str, torch.Tensor]:
        """Accumulator → the requested aggregate columns (tensors)."""
        out = sorted_ops.finalize(state, self.names)
        del out["key"]
        return out


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggResult:
    """Sorted result relation of :func:`aggregate`: ``state`` is the raw
    accumulator on the device (keys ascending, EMPTY-padded tail)."""

    state: AggState
    stats: SpillStats
    by: KeySpec
    aggs: AggSpec
    plan: dict[str, Any]

    def occupancy(self) -> int:
        return host_ints(self.state.occupancy())[0]

    def relation(self) -> dict[str, np.ndarray]:
        """Named key columns + aggregate columns as NumPy arrays, padding
        removed, rows sorted by the composite key (major column first).
        Masks with the state's sentinel: a rollup level may carry a
        KeySpec of at most 32 bits over a uint64 state."""
        keys, mask = _host_keys(self.state)
        out = {n: c[mask] for n, c in self.by.unpack(keys).items()}
        for name, col in self.aggs.finalize(self.state).items():
            out[name] = _np(col)[mask]
        return out

    @property
    def sorted_by(self) -> dict[str, Any]:
        """The order this relation carries: ascending by the packed key,
        i.e. lexicographically by every ``by`` column, major first.
        :meth:`merge_join` and :meth:`rollup` consume it instead of
        sorting again."""
        return _sorted_by(self.by)

    def merge_join(self, other: "AggResult", *, how: str = "inner", backend: str = "auto",
                   mesh=None, mesh_axis: str | None = None) -> "JoinResult":
        """Merge join with another aggregated relation, consuming both
        sides' key order: a probe and a compaction gather, no sort.

        ``how``: ``"inner"`` (aligned per-side packets plus the group-join
        product columns), ``"semi"`` (this side's groups with a match) or
        ``"anti"`` (those without).  Both sides must pack their keys the
        same way (same key dtype and column bit layout) and lie on one
        device.  On a CUDA state ``backend="auto"`` is ``"cuda"``: the
        probe kernel launches or the call raises."""
        if mesh is not None or mesh_axis is not None:
            raise NotImplementedError(
                "the mesh-sharded merge join is not ported yet (ROADMAP Queue 1 item 11, "
                "distributed aggregation)")
        _check_join_compat(self.by, other.by)
        if self.state.device != other.state.device:
            raise ValueError(
                f"join of relations on {self.state.device} and {other.state.device}")
        backend = dispatch.resolve_backend_name(backend, self.state.device)
        plan: dict[str, Any] = {
            "operator": "merge_join",
            "how": how,
            "backend": backend,
            "inputs_sorted": True,
            "sorted_by": [self.sorted_by, other.sorted_by],
            "left_plan": self.plan,
            "right_plan": other.plan,
        }
        left, right = mj_mod.merge_join(self.state, other.state, how=how, backend=backend)
        products = _join_products_state(left, right) if how == "inner" else None
        dev_type = self.state.device.type
        plan["cost_model"] = cost_model.join_cost_surface(
            self.state.capacity, other.state.capacity, inputs_sorted=True, backend=dev_type)
        plan["cost_model_resort_baseline"] = cost_model.join_cost_surface(
            self.state.capacity, other.state.capacity, inputs_sorted=False, backend=dev_type)
        return JoinResult(
            left=left, right=right, products=products, by=self.by, left_aggs=self.aggs,
            right_aggs=other.aggs, stats=SpillStats.reduce_shards([self.stats, other.stats]),
            plan=plan, how=how,
        )

    def rollup(self, levels: Sequence[int] | None = None, *,
               backend: str = "auto") -> dict[tuple[str, ...], "AggResult"]:
        """Coarser prefix levels peeled from this already-sorted result
        (§2.2's rollup from one sort): no input re-read, no sort, no
        spill.  Returns ``{prefix column names: AggResult}`` like the
        module-level :func:`rollup`."""
        backend = dispatch.resolve_backend_name(backend, self.state.device)
        out: dict[tuple[str, ...], AggResult] = {}
        for names, st, spec in _iter_prefix_levels(self.state, self.by, levels, backend):
            plan = dict(self.plan)
            plan["rollup"] = {"level": names, "sorts": 0, "from_order": self.sorted_by}
            out[names] = AggResult(state=st, stats=self.stats, by=spec, aggs=self.aggs,
                                   plan=plan)
        return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _host_keys(state: AggState) -> tuple[np.ndarray, np.ndarray]:
    """The state's keys as uint32/uint64 host keys, and the valid-row mask
    by the state's own sentinel."""
    keys = keys_to_numpy(state.keys, state.key_dtype)
    return keys, keys != _EMPTY_NP[keys.dtype]


def _sorted_by(by: KeySpec) -> dict[str, Any]:
    return {
        "columns": by.names,
        "prefix_len": len(by.columns),
        "key_dtype": str(np.dtype(by.key_dtype)),
    }


def _check_join_compat(left_by: KeySpec, right_by: KeySpec) -> None:
    """Joining two relations requires one shared packed key space: the same
    key dtype and the same column bit layout; anything else raises."""
    if left_by.key_dtype != right_by.key_dtype:
        raise TypeError(
            f"join key dtype mismatch: left packs to {np.dtype(left_by.key_dtype)} "
            f"({left_by.total_bits} bits, columns {left_by.names}), right to "
            f"{np.dtype(right_by.key_dtype)} ({right_by.total_bits} bits, columns "
            f"{right_by.names}) — repack both sides with one KeySpec bit layout"
        )
    lb = tuple(c.bits for c in left_by.columns)
    rb = tuple(c.bits for c in right_by.columns)
    if lb != rb:
        raise TypeError(
            f"join key layout mismatch: left columns {left_by.names} pack as bits {lb}, "
            f"right columns {right_by.names} as {rb} — equal packed keys would not mean "
            "equal column values"
        )


def _join_products_state(left: AggState, right: AggState) -> AggState:
    """The group-join product columns (§2.5) as a state sharing the join's
    key vector, sum plane = [join_count, Σ_L·|R| (V_L columns), |L|·Σ_R
    (V_R columns)].  Sums over join pairs add across fine keys, so a
    rollup combines them exactly along with the per-side packets."""
    prods = mj_mod.group_join_products(left, right)
    plane = torch.cat([prods["join_count"][:, None], prods["sum_left_x_count_right"],
                       prods["count_left_x_sum_right"]], dim=1)
    none = torch.zeros((left.capacity, 0), dtype=torch.float32, device=left.device)
    return AggState(keys=left.keys, count=left.count, sum=plane, min=none, max=none,
                    key_dtype=left.key_dtype)


@dataclasses.dataclass
class JoinResult:
    """Result of :meth:`AggResult.merge_join`: ``left`` and ``right`` are the
    per-side aggregate packets aligned on one sorted key vector (``right``
    is None for semi/anti joins); ``products`` carries the §2.5 group-join
    product columns as sum planes (inner joins only).  The result is itself
    key-sorted, so :meth:`rollup` peels prefix levels from it with
    segmented combines and no sort."""

    left: AggState
    right: AggState | None
    products: AggState | None
    by: KeySpec
    left_aggs: AggSpec
    right_aggs: AggSpec
    stats: SpillStats
    plan: dict[str, Any]
    how: str = "inner"

    @property
    def state(self) -> AggState:
        return self.left

    def occupancy(self) -> int:
        return host_ints(self.left.occupancy())[0]

    @property
    def sorted_by(self) -> dict[str, Any]:
        """The join output keeps the inputs' key order."""
        return _sorted_by(self.by)

    def relation(self) -> dict[str, np.ndarray]:
        """Key columns + per-side aggregate columns (``*_left`` /
        ``*_right``) + the group-join product columns (inner joins),
        padding removed, rows in key order."""
        keys, mask = _host_keys(self.left)
        out = {n: c[mask] for n, c in self.by.unpack(keys).items()}
        for name, col in self.left_aggs.finalize(self.left).items():
            out[f"{name}_left"] = _np(col)[mask]
        if self.right is not None:
            for name, col in self.right_aggs.finalize(self.right).items():
                out[f"{name}_right"] = _np(col)[mask]
        if self.products is not None:
            wl = self.left.sum.shape[1]
            plane = _np(self.products.sum)[mask]
            out["join_count"] = plane[:, 0]
            out["sum_left_x_count_right"] = plane[:, 1: 1 + wl]
            out["count_left_x_sum_right"] = plane[:, 1 + wl:]
        return out

    def rollup(self, levels: Sequence[int] | None = None, *,
               backend: str = "auto") -> dict[tuple[str, ...], "JoinResult"]:
        """Prefix-level rollup of the join (aggregate → merge join →
        rollup, from the sources' sorts alone).  Every constituent state
        shares one key vector, so each peel applies the same segmented
        combine to every side and the alignment holds; the product planes
        are sums over join pairs and roll up exactly."""
        backend = dispatch.resolve_backend_name(backend, self.left.device)
        parts = [s for s in (self.left, self.right, self.products) if s is not None]
        peels = [_iter_prefix_levels(s, self.by, levels, backend) for s in parts]
        out: dict[tuple[str, ...], JoinResult] = {}
        for tier in zip(*peels):
            names, st_l, spec = tier[0]
            st_r = tier[1][1] if self.right is not None else None
            st_p = tier[-1][1] if self.products is not None else None
            plan = dict(self.plan)
            plan["rollup"] = {"level": names, "sorts": 0, "from_order": self.sorted_by}
            out[names] = JoinResult(
                left=st_l, right=st_r, products=st_p, by=spec, left_aggs=self.left_aggs,
                right_aggs=self.right_aggs, stats=self.stats, plan=plan, how=self.how,
            )
        return out


def pipeline(steps):
    """Run an order-preserving operator pipeline: one sort per source
    relation, none between operators.

    ``steps`` is a list; the first entry is the source — an
    :class:`AggResult` or ``("aggregate", kwargs)`` — and each later entry
    is ``("merge_join", {"right": <AggResult | ("aggregate", kwargs)>,
    ...})`` or ``("rollup", {"levels": ...})``.  The result's
    ``plan["pipeline"]`` records the stages, the source sorts paid and the
    zero re-sorts the composition guarantees."""
    if not steps:
        raise ValueError("pipeline needs at least a source step")
    sources = 0

    def _source(spec):
        nonlocal sources
        if isinstance(spec, AggResult):
            sources += 1
            return spec
        if isinstance(spec, tuple) and len(spec) == 2 and spec[0] == "aggregate":
            sources += 1
            return aggregate(**spec[1])
        raise TypeError(
            f"pipeline source must be an AggResult or ('aggregate', kwargs), got {spec!r}")

    stages = ["aggregate"]
    cur = _source(steps[0])
    for step in steps[1:]:
        if not (isinstance(step, tuple) and len(step) == 2):
            raise TypeError(f"pipeline step must be (op, kwargs), got {step!r}")
        op, kw = step
        kw = dict(kw)
        if op == "merge_join":
            right = _source(kw.pop("right"))
            cur = cur.merge_join(right, **kw)
            stages.append(f"merge_join[{cur.how}]")
        elif op == "rollup":
            if isinstance(cur, dict):
                raise TypeError("cannot compose past a rollup fan-out")
            cur = cur.rollup(**kw)
            stages.append("rollup")
        else:
            raise ValueError(f"unknown pipeline op {op!r}: merge_join|rollup")
    block = {"stages": stages, "source_sorts": sources, "re_sorts": 0}
    for r in (cur.values() if isinstance(cur, dict) else (cur,)):
        r.plan = dict(r.plan)
        r.plan["pipeline"] = block
    return cur


def _shift_right(keys: torch.Tensor, bits: int, key_dtype) -> torch.Tensor:
    """Drop the ``bits`` low bits of packed keys, in the keys' own domain.
    A uint64 key is held with its top bit flipped, and a 64-bit KeySpec
    sets that bit on valid keys: unmap, shift logically (``>>`` on int64
    would carry the sign in), then map back into the uint64 domain."""
    if np.dtype(key_dtype) == np.uint32:
        return keys >> bits
    raw = keys ^ INT64_MIN
    return ((raw >> bits) & ((1 << (64 - bits)) - 1)) ^ INT64_MIN


def _iter_prefix_levels(state: AggState, by: KeySpec, levels, backend: str):
    """Peel minor key columns off a key-sorted state, yielding
    ``(prefix_names, state, prefix_spec)`` finest level first.  Dropping
    the least-significant column is a right shift, monotone on the packed
    key, so every coarser level is one segmented combine of the finer
    one: no sort, no spill (§2.2).  A level keeps the engine state's key
    domain whatever its KeySpec's width; the grand total is one group
    under the domain's zero."""
    n_cols = len(by.columns)
    if levels is None:
        levels = list(range(n_cols, -1, -1))
    requested = sorted({int(lvl) for lvl in levels}, reverse=True)
    if not requested or requested[0] > n_cols or requested[-1] < 0:
        raise ValueError(f"rollup levels {requested} out of range [0, {n_cols}]")
    spec = by
    cur = n_cols
    for lvl in requested:
        while cur > lvl:
            if cur == 1:
                spec = KeySpec((KeyColumn("__all__", 1),))
                shifted = torch.full_like(state.keys, zero_key(state.key_dtype))
            else:
                dropped = spec.columns[-1]
                spec = KeySpec(spec.columns[:-1])
                shifted = _shift_right(state.keys, dropped.bits, state.key_dtype)
            keys2 = torch.where(state.valid(), shifted, state.empty)
            state = sorted_ops.segmented_combine(
                AggState(keys2, state.count, state.sum, state.min, state.max,
                         state.key_dtype),
                backend=backend,
            )
            cur -= 1
        yield by.names[:lvl], state, spec


def _resolve_order_by(order_by, by: KeySpec) -> bool:
    """order_by must be a prefix of the key columns (satisfiable from the
    one sort); returns whether sorted output is required."""
    if order_by is None or order_by is False:
        return False
    if order_by is True:
        return True
    names = (order_by,) if isinstance(order_by, str) else tuple(order_by)
    if names != by.names[: len(names)]:
        raise ValueError(
            f"order_by {names} is not a prefix of the key columns {by.names}; "
            "one sort cannot satisfy it — reorder the KeySpec"
        )
    return True


def _plan(n_rows: int, cfg: ExecConfig, output_estimate: int | None, *,
          input_sorted: bool = False, device_type: str = "cpu") -> dict:
    """Optimizer-style comparison (paper Figs 23/24): the predicted spill
    volumes of the in-sort operator and the hash baseline, and the
    calibrated cost surface of the run-generation policies.  The surface
    is looked up by device type; with no ``"cuda"`` constants committed,
    a card's plan carries the CPU's (``calibrated_backend`` says which).
    ``input_sorted`` credits a key order an upstream ``aggregate``
    established: the sort term of the predicted cost is zero."""
    O = output_estimate or cfg.memory_rows * cfg.fanin
    insort_cb = cost_model.simulate_insort(
        n_rows, O, cfg.memory_rows, cfg.fanin,
        early_aggregation=True, wide_merge=True, replacement_selection=True,
    )
    hash_cb = cost_model.simulate_hash(n_rows, O, cfg.memory_rows, cfg.fanin, hybrid=True)
    levels = max(1, cost_model.merge_levels_insort(O, cfg.memory_rows, cfg.fanin))
    return {
        "input_rows": n_rows,
        "output_estimate": O,
        "in_memory": n_rows <= cfg.memory_rows,
        "input_sorted": input_sorted,
        "predicted_spill_insort": insort_cb.total_spill,
        "predicted_spill_hash": hash_cb.total_spill,
        "cost_model": cost_model.cost_surface(n_rows, O, backend=device_type,
                                              merge_levels=levels, input_sorted=input_sorted),
    }


def aggregate(columns, *, by: KeySpec, values=None,
              aggs: AggSpec | Sequence[str] | str = ("count",), order_by=None,
              algorithm: str = "auto", backend: str = "auto", cfg: ExecConfig | None = None,
              output_estimate: int | None = None, input_sorted: bool = False,
              pipeline: str = "device", device="cuda") -> AggResult:
    """Duplicate removal / grouping / aggregation behind one front door.

    ``columns``: mapping of key-column name → integer vector (or a
    significance-ordered sequence), packed per ``by``; ``values`` the
    optional (N, V) float payload; ``aggs`` the requested aggregates.
    ``order_by`` (True, or a prefix of ``by``'s columns) asks for a
    key-sorted result: free for the sort-based algorithms, one more sort
    for the hash baselines.  ``algorithm``: ``"auto"`` (the in-sort
    operator, the paper's only choice), ``"insort"``, ``"hash"``,
    ``"f1_hash"``, ``"sort_then_stream"`` or ``"inmemory"``.
    ``input_sorted`` asserts the input arrives in key order; the plan's
    cost surface then credits a zero sort term.  ``device`` defaults to
    ``"cuda"`` and raises where there is no card; ``device="cpu"`` runs
    the plain versions."""
    from repro_torch.core.operators import ALGORITHMS, group_by  # imports this module

    cfg = cfg or ExecConfig()
    if not isinstance(aggs, AggSpec):
        aggs = AggSpec(aggs) if isinstance(aggs, str) else AggSpec(*aggs)
    if isinstance(columns, Iterator):
        raise NotImplementedError(
            "streamed input is not ported yet (ROADMAP Queue 1 item 9, streaming and adaptive)")
    if algorithm == "adaptive":
        raise ValueError(
            "algorithm='adaptive' adapts mid-stream: it needs streamed input (not ported "
            "yet, ROADMAP Queue 1 item 9); one-shot input is planned up front with "
            "algorithm='auto'")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of {ALGORITHMS}")
    dev = resolve_device(device)
    packed = by.pack(columns)
    want_sorted = _resolve_order_by(order_by, by)
    if values is not None:
        values = np.asarray(values, dtype=np.float32)
        if values.ndim == 1:
            values = values[:, None]
        widths = aggs.plane_widths(values.shape[1])
        if not any(widths):
            values, widths = None, (0, 0, 0)
    else:
        widths = (0, 0, 0)
        if aggs.needs_payload():
            raise ValueError(f"aggregates {aggs.names} need a payload; pass values=...")
    plan = _plan(len(packed), cfg, output_estimate, input_sorted=input_sorted,
                 device_type=dev.type)
    backend = dispatch.resolve_backend_name(backend, dev)
    plan["backend"] = backend
    plan["algorithm"] = "insort" if algorithm == "auto" else algorithm
    plan["pipeline"] = pipeline if algorithm in ("auto", "insort") else "host"
    plan["device"] = str(dev)
    state, stats = group_by(packed, values, cfg, algorithm=algorithm,
                            output_estimate=output_estimate, backend=backend, widths=widths,
                            pipeline=pipeline, device=dev)
    if want_sorted and algorithm in ("hash", "f1_hash"):
        # hash order → key order: the sort the paper's operator never pays (Fig 19)
        state = sorted_ops.sort_state(state, backend=backend)
    return AggResult(state=state, stats=stats, by=by, aggs=aggs, plan=plan)


# ---------------------------------------------------------------------------
# generic rollup: any prefix hierarchy, all levels from one sort
# ---------------------------------------------------------------------------


def rollup(columns, *, by: KeySpec, values=None,
           aggs: AggSpec | Sequence[str] | str = ("count", "sum"),
           levels: Sequence[int] | None = None, algorithm: str = "auto",
           backend: str = "auto", cfg: ExecConfig | None = None,
           output_estimate: int | None = None, pipeline: str = "device",
           device="cuda") -> tuple[dict[tuple[str, ...], AggResult], SpillStats]:
    """``GROUP BY ROLLUP(...)`` over any key hierarchy from one sort (§2.2).

    Aggregates at the full key, then peels minor columns off the sorted
    output with segmented combines (see :meth:`AggResult.rollup`).
    ``levels`` selects prefix lengths (default: every prefix plus the
    grand total, reported as ``()``).  Returns ({prefix column names:
    AggResult}, stats of the one sort)."""
    fine = aggregate(
        columns, by=by, values=values, aggs=aggs, algorithm=algorithm, backend=backend,
        cfg=cfg, output_estimate=output_estimate, pipeline=pipeline, order_by=True,
        device=device,
    )
    backend = dispatch.resolve_backend_name(backend, fine.state.device)
    out = {names: AggResult(state=st, stats=fine.stats, by=spec, aggs=fine.aggs,
                            plan=fine.plan)
           for names, st, spec in _iter_prefix_levels(fine.state, by, levels, backend)}
    return out, fine.stats

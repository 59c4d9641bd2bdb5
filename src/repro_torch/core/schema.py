"""Schema front door of the port (counterpart of :mod:`repro.core.schema`):
composite keys (:class:`KeySpec`), declarative aggregates
(:class:`AggSpec`) and the one-shot :func:`aggregate` entry point.

``KeySpec.pack``/``unpack`` are NumPy code copied from the reference, so
the port imports nothing of it.  Only one-shot input with the in-sort
algorithm on the device pipeline is ported; streamed input, the hash
baselines, joins, rollup and the mesh wait in ROADMAP.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model, dispatch, sorted_ops
from repro_torch.core import insort as insort_mod
from repro_torch.core.types import (
    AggState,
    ExecConfig,
    SpillStats,
    key_dtype_for_bits,
    keys_to_numpy,
    resolve_device,
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

    def relation(self) -> dict[str, np.ndarray]:
        """Named key columns + aggregate columns as NumPy arrays, padding
        removed, rows sorted by the composite key (major column first)."""
        keys = keys_to_numpy(self.state.keys, self.state.key_dtype)
        mask = keys != _EMPTY_NP[keys.dtype]
        out = {n: c[mask] for n, c in self.by.unpack(keys).items()}
        for name, col in self.aggs.finalize(self.state).items():
            out[name] = col.detach().cpu().numpy()[mask]
        return out

    @property
    def sorted_by(self) -> dict[str, Any]:
        """The order this relation carries: ascending by the packed key,
        i.e. lexicographically by every ``by`` column, major first."""
        return {
            "columns": self.by.names,
            "prefix_len": len(self.by.columns),
            "key_dtype": str(np.dtype(self.by.key_dtype)),
        }


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


def _plan(n_rows: int, cfg: ExecConfig, output_estimate: int | None) -> dict:
    """Predicted spill volumes of the in-sort operator and the hash
    baseline (paper Fig 23/24).  The reference's calibrated ``cost_model``
    entry has no CUDA constants yet and is left out."""
    O = output_estimate or cfg.memory_rows * cfg.fanin
    insort_cb = cost_model.simulate_insort(
        n_rows, O, cfg.memory_rows, cfg.fanin,
        early_aggregation=True, wide_merge=True, replacement_selection=True,
    )
    hash_cb = cost_model.simulate_hash(n_rows, O, cfg.memory_rows, cfg.fanin, hybrid=True)
    return {
        "input_rows": n_rows,
        "output_estimate": O,
        "in_memory": n_rows <= cfg.memory_rows,
        "predicted_spill_insort": insort_cb.total_spill,
        "predicted_spill_hash": hash_cb.total_spill,
    }


def aggregate(columns, *, by: KeySpec, values=None,
              aggs: AggSpec | Sequence[str] | str = ("count",), order_by=None,
              algorithm: str = "auto", backend: str = "auto", cfg: ExecConfig | None = None,
              output_estimate: int | None = None, pipeline: str = "device",
              device="cuda") -> AggResult:
    """Duplicate removal / grouping / aggregation behind one front door.

    ``columns``: mapping of key-column name → integer vector (or a
    significance-ordered sequence), packed per ``by``; ``values`` the
    optional (N, V) float payload; ``aggs`` the requested aggregates.
    ``algorithm`` is ``"auto"`` or ``"insort"`` (the same operator).
    ``device`` defaults to ``"cuda"`` and raises where there is no card;
    ``device="cpu"`` runs the plain versions."""
    cfg = cfg or ExecConfig()
    if not isinstance(aggs, AggSpec):
        aggs = AggSpec(aggs) if isinstance(aggs, str) else AggSpec(*aggs)
    if isinstance(columns, Iterator):
        raise NotImplementedError(
            "streamed input is not ported yet (ROADMAP Queue 1, streaming and adaptive)")
    if algorithm not in ("auto", "insort"):
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet (ROADMAP Queue 1, other one-shot "
            "algorithms); use 'auto' or 'insort'"
        )
    dev = resolve_device(device)
    packed = by.pack(columns)
    _resolve_order_by(order_by, by)  # the in-sort result is always key-sorted
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
    plan = _plan(len(packed), cfg, output_estimate)
    plan["backend"] = dispatch.resolve_backend_name(backend, dev)
    plan["algorithm"] = "insort"
    plan["pipeline"] = pipeline
    plan["device"] = str(dev)
    state, stats = insort_mod.insort_aggregate(
        packed, values, cfg, output_estimate=output_estimate, backend=plan["backend"],
        widths=widths, pipeline=pipeline, device=dev,
    )
    return AggResult(state=state, stats=stats, by=by, aggs=aggs, plan=plan)

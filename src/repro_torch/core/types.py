"""Row/aggregate-state types of the PyTorch port (counterpart of
:mod:`repro.core.types`).

Keys are **int64 tensors** inside the port, whatever the user's key
width.  The port keeps the reference's two key domains and records which
one a state belongs to in :attr:`AggState.key_dtype` (``uint32`` or
``uint64``, a NumPy dtype that never enters a kernel):

* ``uint32`` keys widen to int64 unchanged; EMPTY is ``0xFFFFFFFF``.
* ``uint64`` keys map to int64 by flipping the top bit, which keeps the
  order; EMPTY (all ones) becomes ``INT64_MAX`` and the unsigned zero
  becomes ``INT64_MIN`` (:func:`zero_key`).

EMPTY is the top of each domain, so it still sorts to the end.  Keys
convert back to the reference's ``uint32``/``uint64`` at the edges
(:func:`keys_to_numpy`, :func:`state_to_numpy`, ``AggResult.relation``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

KEY_DTYPES = (np.dtype(np.uint32), np.dtype(np.uint64))
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
_TOP_BIT = np.uint64(1 << 63)

FIELDS = ("keys", "count", "sum", "min", "max")

# device→host readbacks made by the engine (``host_ints``); the pipeline's
# eviction loop pays one per trip, the wide merge one, finalize one
SYNCS = {"host_syncs": 0}


def host_ints(*scalars: torch.Tensor) -> list[int]:
    """Read device scalars back in one transfer, counted in ``SYNCS``."""
    SYNCS["host_syncs"] += 1
    return torch.stack([s.to(torch.int64).reshape(()) for s in scalars]).tolist()


def host_list(vector: torch.Tensor) -> list[int]:
    """Read a device vector back in one transfer, counted in ``SYNCS``."""
    SYNCS["host_syncs"] += 1
    return vector.to(torch.int64).tolist()


def device_ints(values, device) -> torch.Tensor:
    """Host ints as an int64 tensor on ``device``.  On a card the copy
    leaves from pinned memory without waiting for the card: a copy from
    pageable memory synchronizes the stream, a host sync ``SYNCS`` would not
    count."""
    t = torch.tensor(values, dtype=torch.int64)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available here; pass device='cpu' to run the port's "
            "plain versions on the CPU"
        )
    return dev


def _key_dtype(key_dtype) -> np.dtype:
    dt = np.dtype(key_dtype)
    if dt not in KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {dt}; expected one of {KEY_DTYPES}")
    return dt


def empty_key(key_dtype) -> int:
    """The int64 value of the EMPTY sentinel in a key domain."""
    return 0xFFFFFFFF if _key_dtype(key_dtype) == np.uint32 else INT64_MAX


def max_key(key_dtype) -> np.unsignedinteger:
    """The largest valid key of a domain, in the user's unsigned dtype (one
    below EMPTY, the reserved all-ones pattern)."""
    kd = _key_dtype(key_dtype)
    return kd.type(np.iinfo(kd).max - 1)


def zero_key(key_dtype) -> int:
    """The int64 value of the domain's unsigned zero — the replacement-
    selection frontier before anything was evicted."""
    return 0 if _key_dtype(key_dtype) == np.uint32 else INT64_MIN


def key_dtype_for_bits(bits: int) -> np.dtype:
    if bits <= 32:
        return np.dtype(np.uint32)
    if bits <= 64:
        return np.dtype(np.uint64)
    raise ValueError(f"composite keys are limited to 64 bits, got {bits}")


def canon_keys(keys) -> np.ndarray:
    """Host keys in the reference's domains: uint64 stays, everything else
    becomes uint32."""
    keys = np.asarray(keys)
    return keys if keys.dtype == np.uint64 else keys.astype(np.uint32)


def canon_payload(payload) -> np.ndarray | None:
    """A host payload as float32 (N, V) (a vector is one column)."""
    if payload is None:
        return None
    payload = np.asarray(payload, dtype=np.float32)
    return payload[:, None] if payload.ndim == 1 else payload


def keys_to_torch(keys, device) -> torch.Tensor:
    """uint32/uint64 host keys → the port's int64 key tensor."""
    keys = canon_keys(keys)
    if keys.dtype == np.uint64:
        mapped = (keys ^ _TOP_BIT).view(np.int64)
    else:
        mapped = keys.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(mapped)).to(device)


def keys_to_numpy(keys: torch.Tensor, key_dtype) -> np.ndarray:
    """The port's int64 key tensor → uint32/uint64 host keys."""
    k = keys.detach().cpu().numpy().astype(np.int64, copy=False)
    if _key_dtype(key_dtype) == np.uint64:
        return k.view(np.uint64) ^ _TOP_BIT
    return k.astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class AggState:
    """Struct-of-tensors aggregate accumulator.

    ``keys``   (N,)    int64, EMPTY of :attr:`key_dtype` marks invalid rows.
    ``count``  (N,)    int32 group cardinalities.
    ``sum``    (N, Vs) float32 running sums.
    ``min``    (N, Vm) float32 running minima (+inf for invalid).
    ``max``    (N, Vx) float32 running maxima (-inf for invalid).
    ``key_dtype``      the key domain (NumPy ``uint32``/``uint64``).

    A stacked run store uses the same type with a leading slot dimension
    (keys ``(R, C)``, planes ``(R, C, V)``).
    """

    keys: torch.Tensor
    count: torch.Tensor
    sum: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    key_dtype: np.dtype

    def map(self, fn) -> "AggState":
        """Apply ``fn`` to every tensor field."""
        return AggState(fn(self.keys), fn(self.count), fn(self.sum),
                        fn(self.min), fn(self.max), self.key_dtype)

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    @property
    def width(self) -> int:
        return max(self.widths)

    @property
    def widths(self) -> tuple[int, int, int]:
        return (self.sum.shape[-1], self.min.shape[-1], self.max.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def empty(self) -> int:
        return empty_key(self.key_dtype)

    def valid(self) -> torch.Tensor:
        return self.keys != self.empty

    def occupancy(self) -> torch.Tensor:
        """Valid rows, as a device scalar (no host sync)."""
        return self.valid().sum(dtype=torch.int64)


def empty_state(capacity: int, width: int, *, key_dtype, widths=None,
                device) -> AggState:
    ws, wm, wx = widths if widths is not None else (width, width, width)
    kd = _key_dtype(key_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return AggState(
        keys=torch.full((capacity,), empty_key(kd), dtype=torch.int64, device=device),
        count=torch.zeros((capacity,), dtype=torch.int32, device=device),
        sum=torch.zeros((capacity, ws), **f32),
        min=torch.full((capacity, wm), float("inf"), **f32),
        max=torch.full((capacity, wx), float("-inf"), **f32),
        key_dtype=kd,
    )


def empty_like(state: AggState, capacity: int) -> AggState:
    return empty_state(capacity, state.width, key_dtype=state.key_dtype,
                       widths=state.widths, device=state.device)


def rows_to_state(keys: torch.Tensor, payload: torch.Tensor | None, *,
                  key_dtype, widths=None) -> AggState:
    """Lift raw rows (int64 keys, optional (N, V) float payload) into
    aggregate states (count=1, sum=min=max=v; neutral for EMPTY rows)."""
    n = keys.shape[0]
    dev = keys.device
    if payload is None:
        payload = torch.zeros((n, 0), dtype=torch.float32, device=dev)
    if payload.dim() == 1:
        payload = payload[:, None]
    payload = payload.to(torch.float32)
    v = payload.shape[1]
    ws, wm, wx = widths if widths is not None else (v, v, v)
    for w in (ws, wm, wx):
        if w not in (0, v):
            raise ValueError(f"plane width {w} must be 0 or the payload width {v}")
    valid = keys != empty_key(key_dtype)
    vcol = valid[:, None]
    none = torch.zeros((n, 0), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    return AggState(
        keys=keys,
        count=valid.to(torch.int32),
        sum=torch.where(vcol, payload, 0.0) if ws else none,
        min=torch.where(vcol, payload, inf) if wm else none,
        max=torch.where(vcol, payload, -inf) if wx else none,
        key_dtype=_key_dtype(key_dtype),
    )


def concat_states(a: AggState, b: AggState) -> AggState:
    return AggState(*(torch.cat([getattr(a, f), getattr(b, f)], 0) for f in FIELDS),
                    key_dtype=a.key_dtype)


def take(state: AggState, idx: torch.Tensor) -> AggState:
    """Row-gather a state (applies sort permutations)."""
    idx = idx.to(torch.int64)
    return state.map(lambda x: x.index_select(0, idx))


def slice_rows(state: AggState, start: int, size: int) -> AggState:
    return state.map(lambda x: x[start:start + size])


def state_from_numpy(arrays: Mapping[str, Any], *, device) -> AggState:
    """The reference's ``AggState`` as NumPy arrays (``keys`` uint32 or
    uint64, ``count``, ``sum``/``min``/``max`` planes) → the port's."""
    keys = canon_keys(arrays["keys"])

    def f32(name):
        return torch.from_numpy(np.asarray(arrays[name], np.float32).copy()).to(device)

    return AggState(
        keys=keys_to_torch(keys, device),
        count=torch.from_numpy(np.asarray(arrays["count"], np.int32).copy()).to(device),
        sum=f32("sum"), min=f32("min"), max=f32("max"),
        key_dtype=keys.dtype,
    )


def state_to_numpy(state: AggState) -> dict[str, np.ndarray]:
    """The port's state → NumPy arrays in the reference's layout and key
    dtype (inverse of :func:`state_from_numpy`)."""
    out = {"keys": keys_to_numpy(state.keys, state.key_dtype)}
    for f in FIELDS[1:]:
        out[f] = getattr(state, f).detach().cpu().numpy()
    return out


@dataclasses.dataclass
class StreamEngineState:
    """The carry of the run-generation loop (counterpart of
    :class:`repro.core.types.StreamEngineState`).

    ``table``/``table2`` are early aggregation's index or replacement
    selection's open and next-run partitions, ``frontier`` the eviction
    frontier (a device scalar), ``store`` the stacked run buffer (leading
    dims ``(R, C)``).  Everything else lives on the host: the eviction loop
    reads the table occupancies back on every trip anyway, and every
    counter follows from those readbacks.

    ``lens``/``cursor``/``ridx``/``spilled`` are the run bookkeeping.
    ``absorbed`` and ``dups`` are the observation block the adaptive
    streaming mode steers on: valid input rows consumed, and duplicate-key
    encounters (rows that combined into an existing group, or adjacent
    equal keys of a sorted batch under ``traditional``).  ``resident`` is
    the tables' occupancy after the last step, which the steps read back
    anyway; it gives the absorbing steps their occupancy before a batch, the
    governor its table rows and the drain its write positions without
    another readback.  ``resident2`` is ``table2``'s share of it."""

    table: AggState
    table2: AggState
    frontier: torch.Tensor
    store: AggState
    lens: list[int]
    cursor: int
    ridx: int
    spilled: int
    absorbed: int = 0
    dups: int = 0
    resident: int = 0
    resident2: int = 0

    @property
    def run_slots(self) -> int:
        return len(self.lens)

    @property
    def slot_rows(self) -> int:
        return self.store.keys.shape[-1]

    @property
    def key_dtype(self) -> np.dtype:
        return self.store.key_dtype


@dataclasses.dataclass
class StagedChunk:
    """One chunk of a stream on its way to the engine (counterpart of
    :class:`repro.core.pipeline.StagedChunk`): the unit of double
    buffering.  ``keys`` (int64) and ``payload`` ((rows, V) float32) are
    EMPTY-padded to whole staging units; on a card they were copied on a
    side stream, and ``event`` marks the copy's end (None on the CPU).
    ``rows`` counts the valid input rows, ``rows_padded`` the rows of the
    chunk's pow2-bucketed batch geometry, by which the run slots are
    sized.  ``local_rows`` counts the valid rows of ``keys``: ``rows`` on
    one device, this rank's share on a mesh, where ``keys``/``payload`` are
    the rank's slice."""

    keys: torch.Tensor
    payload: torch.Tensor
    rows: int
    rows_padded: int
    local_rows: int
    event: Any = None


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """External-algorithm knobs (the paper's experiment parameters).

    memory_rows  M — the fixed "memory allocation" in rows.
    page_rows    P — unit of temporary-storage I/O in rows.
    fanin        F — merge fan-in.
    batch_rows   B — input consumption granularity.
    """

    memory_rows: int = 1 << 12
    page_rows: int = 1 << 8
    fanin: int = 8
    batch_rows: int = 1 << 10

    def __post_init__(self):
        if not (self.page_rows <= self.memory_rows and self.batch_rows <= self.memory_rows
                and self.fanin >= 2):
            raise ValueError(f"inconsistent ExecConfig {self}")


@dataclasses.dataclass
class SpillStats:
    """Exact temporary-storage accounting (rows, the paper's unit); the
    same fields as :class:`repro.core.types.SpillStats`, so parity is a
    dict compare."""

    rows_spilled_run_generation: int = 0
    rows_spilled_merge: int = 0
    runs_generated: int = 0
    merge_steps: int = 0
    merge_levels: int = 0
    pages_read: int = 0
    rows_emitted: int = 0
    index_overflowed: bool = False
    max_index_occupancy: int = 0
    rows_exchanged: int = 0
    rows_retired: int = 0
    duplicate_rate: float = 0.0
    policy_switches: int = 0
    readbacks_paid: int = 0
    exchange_quota: int = 0
    exchange_max_fill: int = 0
    exchange_retries: int = 0

    @property
    def total_spill_rows(self) -> int:
        return self.rows_spilled_run_generation + self.rows_spilled_merge

    @classmethod
    def reduce_shards(cls, shards: "list[SpillStats]") -> "SpillStats":
        """Combine the accounting of several inputs (a join's two sides):
        counters add, depth and peak occupancy take the max, flags OR."""
        if not shards:
            raise ValueError("reduce_shards needs at least one SpillStats")
        maxed = {"merge_levels", "max_index_occupancy", "duplicate_rate",
                 "exchange_quota", "exchange_max_fill"}
        out = {}
        for f in dataclasses.fields(cls):
            vals = [getattr(s, f.name) for s in shards]
            if f.name == "index_overflowed":
                out[f.name] = any(vals)
            else:
                out[f.name] = max(vals) if f.name in maxed else sum(vals)
        return cls(**out)

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["total_spill_rows"] = self.total_spill_rows
        return d


class MergeOverflowError(RuntimeError):
    """The wide merge dropped rows: its index outgrew its capacity or the
    output overran its buffer.  The streaming finalize and snapshot catch
    this type to retry once at the next pow2 output capacity."""


class ExchangeOverflowError(RuntimeError):
    """The cross-shard exchange's per-peer send quota was too small for a
    send segment: rows would have stayed behind on the sending shard.
    Carries the ``quota`` the exchange ran at, the fullest segment's
    ``max_fill`` and the sent state's ``capacity`` (the lossless ceiling,
    0 where unknown) so that a retry can size itself.  Raised by the mesh
    paths' ``DeviceSpillStats.finalize`` and the mesh merge join."""

    def __init__(self, message: str, *, quota: int, max_fill: int, capacity: int = 0):
        super().__init__(message)
        self.quota = quota
        self.max_fill = max_fill
        self.capacity = capacity


@dataclasses.dataclass(frozen=True)
class DeviceSpillStats:
    """:class:`SpillStats` before the readback: each field is a device
    scalar tensor or a host int.  :meth:`finalize` reads them back once and
    raises where rows were (or would have been) lost."""

    rows_spilled_run_generation: Any
    rows_spilled_merge: Any
    runs_generated: Any
    merge_steps: Any
    merge_levels: Any
    pages_read: Any
    rows_emitted: Any
    index_overflowed: Any
    max_index_occupancy: Any
    run_buffer_overflowed: Any
    merge_dropped_rows: Any
    rows_retired: Any = 0
    # the mesh exchange's block: rows this rank put on the wire, the
    # retryable quota-overflow flag, the quota, the fullest segment and the
    # sent state's rows (the retry's ceiling; not in SpillStats)
    rows_exchanged: Any = 0
    exchange_dropped: Any = False
    exchange_quota: Any = 0
    exchange_max_fill: Any = 0
    exchange_capacity: Any = 0

    @classmethod
    def zeros(cls) -> "DeviceSpillStats":
        return cls(0, 0, 0, 0, 0, 0, 0, False, 0, False, False)

    _SUMMED = ("rows_spilled_run_generation", "rows_spilled_merge", "runs_generated",
               "merge_steps", "pages_read", "rows_emitted", "rows_retired", "rows_exchanged")

    def cross_shard(self, mesh) -> "DeviceSpillStats":
        """The ranks' accounting reduced to the global view (the
        reference's ``psum``/``pmax`` in ``shard_map``): row and step
        counters summed, merge depth, peak index occupancy, quota and
        fullest segment maxed, the loud-failure flags OR'ed (as int64
        MAX: gloo has no bool reduction), so that one rank's overflow
        raises on every rank at :meth:`finalize`.  Two collectives, no
        readback; every rank must call it."""
        from repro_torch.distributed import sharding  # sharding imports this module

        names = [f.name for f in dataclasses.fields(self)]
        dev = mesh.device
        vec = torch.stack([torch.as_tensor(getattr(self, n), device=dev).to(torch.int64)
                           .reshape(()) for n in names])
        summed = sharding.all_reduce(mesh, vec, "sum")
        maxed = sharding.all_reduce(mesh, vec, "max")
        flags = ("index_overflowed", "run_buffer_overflowed", "merge_dropped_rows",
                 "exchange_dropped")
        out = {}
        for i, n in enumerate(names):
            v = summed[i] if n in self._SUMMED else maxed[i]
            out[n] = v > 0 if n in flags else v
        return DeviceSpillStats(**out)

    def finalize(self, *, entry_point: str = "finalize") -> SpillStats:
        vals = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        tensors = [k for k, v in vals.items() if isinstance(v, torch.Tensor)]
        if tensors:  # the one readback
            vals.update(zip(tensors, host_ints(*(vals[k] for k in tensors))))
        if vals["run_buffer_overflowed"]:
            raise RuntimeError(
                f"device run buffer overflowed its preallocated run slots during "
                f"{entry_point}; results would be missing rows (this is a bug in "
                "the slot bound — please report input sizes and ExecConfig)"
            )
        if vals["exchange_dropped"]:
            raise ExchangeOverflowError(
                f"the cross-shard exchange during {entry_point} overflowed its per-peer send "
                f"quota ({int(vals['exchange_max_fill'])} rows in the fullest segment vs "
                f"quota {int(vals['exchange_quota'])}); rows would have been left behind — "
                "pass a larger exchange_quota (host entry points retry once at the next "
                "pow2 automatically)",
                quota=int(vals["exchange_quota"]), max_fill=int(vals["exchange_max_fill"]),
                capacity=int(vals["exchange_capacity"]))
        if vals["merge_dropped_rows"]:
            if entry_point == "snapshot":
                hint = ("raise output_rows (the snapshot output capacity) or pass a "
                        "larger output_estimate (more pre-merge levels)")
            else:
                hint = ("pass a larger output_estimate (more pre-merge levels) or "
                        "raise index_rows")
            raise MergeOverflowError(
                f"the wide merge during {entry_point} dropped rows: either its "
                f"index overflowed its capacity (max resident "
                f"{int(vals['max_index_occupancy'])} rows) or the output overran "
                f"its buffer — {hint}"
            )
        return SpillStats(
            rows_spilled_run_generation=int(vals["rows_spilled_run_generation"]),
            rows_spilled_merge=int(vals["rows_spilled_merge"]),
            runs_generated=int(vals["runs_generated"]),
            merge_steps=int(vals["merge_steps"]),
            merge_levels=int(vals["merge_levels"]),
            pages_read=int(vals["pages_read"]),
            rows_emitted=int(vals["rows_emitted"]),
            index_overflowed=bool(vals["index_overflowed"]),
            max_index_occupancy=int(vals["max_index_occupancy"]),
            rows_retired=int(vals["rows_retired"]),
            rows_exchanged=int(vals["rows_exchanged"]),
            exchange_quota=int(vals["exchange_quota"]),
            exchange_max_fill=int(vals["exchange_max_fill"]),
        )

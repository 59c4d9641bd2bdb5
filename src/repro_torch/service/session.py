"""Schema-level sessions: composite keys, declarative aggregates, TTL
(counterpart of :mod:`repro.service.session`).

:class:`AggregationSession` is the :func:`repro_torch.aggregate` rendering
of the service: batches are column mappings packed through a
:class:`~repro_torch.core.schema.KeySpec`, snapshots come back as
:class:`~repro_torch.core.schema.AggResult`, and expiry is keyed on the
**watermark column**, the major (most significant) column of the composite
key.  Because the KeySpec packs major-first, "watermark below the cutoff"
is one contiguous packed-key range ``[0, cutoff << shift)``: TTL expiry is
the engine's sorted-prefix retirement, with no per-row predicate.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import dispatch
from repro_torch.core import schema as schema_mod
from repro_torch.core.schema import AggResult, AggSpec, KeySpec
from repro_torch.core.types import ExecConfig, SpillStats, empty_state, resolve_device
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.service import AggregationService


class AggregationSession:
    """A long-lived grouped-aggregation session over column batches.

    ::

        sess = repro_torch.serve_aggregate(
            by=KeySpec.of(minute=22, user=10), values="amount",
            aggs=("count", "sum"), watermark="minute")
        for batch in source:
            sess.ingest(batch)
            if query_due:
                res = sess.snapshot()    # merge-on-read AggResult
        sess.expire_below(minute=now - ttl)   # retire closed sessions
        final = sess.close()

    ``watermark`` names the major key column that :meth:`expire_below`
    cuts on; it must be the first KeySpec column, so that expiry is one
    packed-key range.  The payload width is fixed by the first ingested
    batch (the engine's plane widths are fixed).  ``device`` defaults to
    ``"cuda"``.  ``mesh=`` runs one engine a rank (see
    :class:`AggregationService`): every rank ingests the same batches and
    makes every call, and a snapshot or the close is a mesh
    :class:`AggResult` holding the rank's key range (its ``relation()``
    gathers the shards)."""

    def __init__(
        self,
        *,
        by: KeySpec,
        values: str | None = None,
        aggs=("count",),
        watermark: str | None = None,
        cfg: ExecConfig | None = None,
        policy: str = "rs",
        backend: str = "auto",
        index_rows: int | None = None,
        output_estimate: int | None = None,
        output_rows: int | None = None,
        mesh=None,
        mesh_axis: str | None = None,
        overlap: bool = True,
        governor=None,
        device="cuda",
    ):
        if not isinstance(aggs, AggSpec):
            aggs = AggSpec(aggs) if isinstance(aggs, str) else AggSpec(*aggs)
        if values is not None and not isinstance(values, str):
            raise TypeError(
                "session batches are column mappings: values must name a column (a str), "
                f"got {type(values).__name__}")
        if values is None and aggs.needs_payload():
            raise ValueError(f"aggregates {aggs.names} need a payload; pass "
                             "values=<column name>")
        if watermark is not None and watermark != by.names[0]:
            raise ValueError(
                f"watermark column {watermark!r} must be the major (first) key column "
                f"{by.names[0]!r}: the KeySpec packs major-first, so only the major column "
                "maps TTL expiry onto one contiguous packed-key range")
        self.by = by
        self.aggs = aggs
        self.values = values
        self.watermark = watermark
        self.cfg = cfg or ExecConfig()
        self.device = resolve_device(device)
        self._engine_kw = dict(
            policy=policy, backend=backend, index_rows=index_rows,
            output_estimate=output_estimate, output_rows=output_rows, overlap=overlap,
            governor=governor, mesh=mesh, mesh_axis=mesh_axis, device=self.device,
        )
        self._svc: AggregationService | None = None
        self._closed = False

    # -- plumbing --------------------------------------------------------

    def _prep(self, batch) -> tuple[np.ndarray, np.ndarray | None]:
        packed = self.by.pack(batch)
        if self.values is None:
            return packed, None
        if self.values not in batch:
            raise KeyError(f"values column {self.values!r} missing from batch")
        vals = np.asarray(batch[self.values], dtype=np.float32)
        if vals.ndim == 1:
            vals = vals[:, None]
        if len(vals) != len(packed):
            raise ValueError(f"values column {self.values!r} has {len(vals)} rows, key "
                             f"columns have {len(packed)}")
        return packed, vals

    def _ensure_service(self, payload_width: int) -> AggregationService:
        if self._svc is None:
            self._svc = AggregationService(
                self.cfg, key_dtype=self.by.key_dtype, width=payload_width,
                widths=self.aggs.plane_widths(payload_width), **self._engine_kw)
        return self._svc

    def _result(self, state, stats: SpillStats) -> AggResult:
        plan = schema_mod._plan(self.metrics.rows_ingested, self.cfg,
                                self._engine_kw["output_estimate"],
                                device_type=self.device.type)
        plan.update(
            algorithm="insort", pipeline="device", streamed=True, service=True,
            backend=(self._svc.backend if self._svc is not None
                     else dispatch.resolve_backend_name(self._engine_kw["backend"],
                                                        self.device)),
            snapshots=self.metrics.snapshots_taken, device=str(self.device),
        )
        return AggResult(state=state, stats=stats, by=self.by, aggs=self.aggs, plan=plan,
                         mesh=self._engine_kw["mesh"] if state.capacity else None)

    def _empty_result(self) -> AggResult:
        """The valid empty relation: the declared key columns and planes, no
        rows."""
        state = empty_state(0, 0, key_dtype=self.by.key_dtype,
                            widths=self.aggs.plane_widths(0), device=self.device)
        return self._result(state, SpillStats())

    @property
    def metrics(self) -> ServiceMetrics:
        return self._svc.metrics if self._svc is not None else ServiceMetrics()

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self):
        if self._closed:
            raise RuntimeError("AggregationSession is closed")

    # -- the session protocol --------------------------------------------

    def ingest(self, batch) -> None:
        """Absorb one column-batch mapping (the key columns named by the
        KeySpec, and the values column when requested)."""
        self._check_open()
        packed, vals = self._prep(batch)
        if not len(packed):
            return
        svc = self._ensure_service(0 if vals is None else vals.shape[1])
        svc.ingest(packed, vals)

    def snapshot(self) -> AggResult:
        """Merge-on-read snapshot as a sorted :class:`AggResult`; ingest
        continues afterwards.  A session that never ingested (or whose rows
        were all retired) answers a valid empty relation, not an error."""
        self._check_open()
        if self._svc is None:  # nothing ever ingested
            return self._empty_result()
        state, stats = self._svc.snapshot()
        return self._result(state, stats)

    def expire_below(self, cutoff=None, **by_name) -> int:
        """Retire every group whose watermark column is ``< cutoff`` (TTL
        expiry).  The cutoff comes positionally or by column name
        (``sess.expire_below(minute=120)``).  Returns the cumulative
        retired-row count; later snapshots report it as
        ``stats.rows_retired``."""
        self._check_open()
        if self.watermark is None:
            raise RuntimeError("session has no watermark column; construct with "
                               "watermark=<major key column> to enable TTL expiry")
        if by_name:
            if cutoff is not None or set(by_name) != {self.watermark}:
                raise ValueError(f"pass ONE cutoff for the watermark column "
                                 f"{self.watermark!r}, got cutoff={cutoff!r}, {by_name}")
            cutoff = by_name[self.watermark]
        if cutoff is None:
            raise ValueError("expire_below needs a cutoff")
        col = self.by.columns[0]
        cutoff = int(cutoff)
        if not 0 <= cutoff <= col.max_value + 1:
            raise ValueError(f"cutoff {cutoff} out of range for {col.bits}-bit column "
                             f"{col.name!r}")
        if self._svc is None:
            return 0
        return self._svc.retire_below(cutoff << self.by.shift_of(self.watermark))

    def close(self) -> AggResult:
        """Destructive final drain; the session accepts no further ingest.
        An empty session closes to the empty relation a snapshot reports."""
        self._check_open()
        self._closed = True
        if self._svc is None:
            return self._empty_result()
        state, stats = self._svc.close()
        return self._result(state, stats)


def serve_aggregate(**kwargs) -> AggregationSession:
    """Open a long-lived aggregation session — the serving twin of
    :func:`repro_torch.aggregate` (the same ``by=``/``values=``/``aggs=``
    arguments, ``watermark=`` for TTL expiry, and the streaming engine's
    knobs).  See :class:`AggregationSession`."""
    return AggregationSession(**kwargs)

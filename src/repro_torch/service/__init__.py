"""Aggregation as a service: long-lived ingest sessions over the streamed
engine on the device (counterpart of :mod:`repro.service`).

The paper's deployment story (F1 Query) is an operator inside a serving
system: rows arrive continuously, queries read the running aggregate
mid-flight, and old windows expire.  This package is that layer — a
persistent :class:`~repro_torch.core.pipeline.StreamingAggregator` behind
a service protocol:

* :class:`AggregationService` — engine-level: packed keys in, double-
  buffered ingest, merge-on-read snapshots (the drain writes into a copy
  of the run store and the wide merge into a fresh buffer; the live engine
  is byte for byte untouched and ingest continues), watermark eviction,
  and a host metrics facade.
* :class:`AggregationSession` / :func:`serve_aggregate` — schema-level:
  composite :class:`~repro_torch.core.schema.KeySpec` keys, declarative
  :class:`~repro_torch.core.schema.AggSpec` aggregates, snapshots as
  :class:`~repro_torch.core.schema.AggResult`, and TTL expiry keyed on the
  major (watermark) key column.
* :class:`ServiceMetrics` — rows ingested, snapshot latency quantiles,
  occupancy and duplicate rate, kept on the host from counts the engine
  already produces.
"""
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.service import AggregationService
from repro_torch.service.session import AggregationSession, serve_aggregate

__all__ = ["AggregationService", "AggregationSession", "ServiceMetrics", "serve_aggregate"]

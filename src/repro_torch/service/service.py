"""Engine-level aggregation service: persistent ingest + merge-on-read
(counterpart of :mod:`repro.service.service`).

:class:`AggregationService` owns one long-lived
:class:`~repro_torch.core.pipeline.StreamingAggregator` and turns its
staged absorb protocol into a serving loop:

* :meth:`ingest` — double-buffered by default: the chunk is staged (on a
  card, copied on a side stream from pinned memory) and the *previous*
  chunk's absorb is dispatched, so the copy overlaps the absorb as in
  :func:`~repro_torch.core.pipeline.aggregate_device_stream`.
* :meth:`snapshot` — merge-on-read: the drain writes into a copy of the run
  store and the wide merge into a fresh output buffer, so every tensor of
  the live engine is byte for byte untouched and ingest continues.
* :meth:`retire_below` — watermark eviction: resident rows with keys below
  a threshold are retired from the run store and tables, counted into
  ``SpillStats.rows_retired`` (surfaced by every later snapshot).
* :meth:`close` — the destructive finalize of the plain streaming
  protocol, ending the session.

The reference's ingest reads nothing back.  The port's does: the engine
steps read the table occupancies back (``rs`` on every trip of its
eviction loop, counted in ``types.SYNCS``).  What the port keeps is that
:meth:`snapshot_device` adds no readback of its own where the merge has no
pre-merge level (the run lengths are the host's), and that its answer
stays on the device.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.pipeline import StreamingAggregator
from repro_torch.core.types import AggState, DeviceSpillStats, ExecConfig, SpillStats
from repro_torch.service.metrics import ServiceMetrics


class AggregationService:
    """A persistent aggregation engine on the device behind a serving
    protocol: ingest packed-key micro-batches, answer snapshot queries
    mid-flight, retire expired key ranges, finalize on close.

    Constructor arguments are :class:`~repro_torch.core.pipeline.
    StreamingAggregator`'s (``device`` defaults to ``"cuda"``; ``mesh=``
    keeps one engine a rank: every rank ingests the same micro-batches and
    keeps its slice, and snapshots and the close exchange by key range, so
    that each rank answers its key range — every rank must make every
    call).
    ``overlap=False`` disables the ingest double buffer (each chunk is
    absorbed with its staging)."""

    def __init__(
        self,
        cfg: ExecConfig | None = None,
        *,
        policy: str = "rs",
        key_dtype=np.uint32,
        width: int = 0,
        widths: tuple[int, int, int] | None = None,
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
        self._agg = StreamingAggregator(
            cfg, policy=policy, key_dtype=key_dtype, width=width, widths=widths,
            backend=backend, index_rows=index_rows, output_estimate=output_estimate,
            output_rows=output_rows, mesh=mesh, mesh_axis=mesh_axis, governor=governor,
            device=device,
        )
        self.overlap = bool(overlap)
        self.metrics = ServiceMetrics()
        self._pending = None  # staged-but-not-absorbed chunk (overlap)
        self._closed = False

    # -- introspection ---------------------------------------------------

    @property
    def cfg(self) -> ExecConfig:
        return self._agg.cfg

    @property
    def policy(self) -> str:
        return self._agg.policy

    @property
    def current_policy(self) -> str:
        """The run-generation policy the next ingest will use — under
        ``policy="adaptive"`` the governor's current arm."""
        return self._agg.arm

    @property
    def key_dtype(self) -> np.dtype:
        return self._agg.key_dtype

    @property
    def device(self):
        return self._agg.device

    @property
    def backend(self) -> str:
        return self._agg.backend

    @property
    def rows_ingested(self) -> int:
        return self.metrics.rows_ingested

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self):
        if self._closed:
            raise RuntimeError("AggregationService is closed")

    # -- ingest ----------------------------------------------------------

    def ingest(self, keys, payload=None) -> None:
        """Absorb one micro-batch (host NumPy keys + optional payload).  The
        chunk is staged and, with ``overlap``, the previous chunk's absorb
        runs behind its copy."""
        self._check_open()
        staged = self._agg.stage(keys, payload)
        if staged is None:
            return
        if self.overlap:
            pending, self._pending = self._pending, staged
            if pending is not None:
                self._agg.absorb_staged(pending)
        else:
            self._agg.absorb_staged(staged)
        self.metrics.observe_ingest(staged.rows)

    def flush(self) -> None:
        """Absorb the chunk still held by the double buffer (the query,
        evict and close boundaries call this, so that answers cover every
        ingested row)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._agg.absorb_staged(pending)

    def wait(self) -> None:
        """Block until the card has finished the work queued so far (the end
        of a timed window; never needed for correctness)."""
        self._agg.wait()

    # -- merge-on-read ---------------------------------------------------

    def snapshot_device(self) -> tuple[AggState, DeviceSpillStats]:
        """:meth:`snapshot` without the stats' readback and the latency
        metric: the answer stays on the device."""
        self._check_open()
        self.flush()
        return self._agg.snapshot_device()

    def snapshot(self) -> tuple[AggState, SpillStats]:
        """Answer the current aggregate without consuming the engine.

        Returns ``(state, stats)`` like a finalize — keys sorted, EMPTY
        tail, ``stats.rows_retired`` carrying the eviction account — but the
        live engine is untouched and ingest continues.  The time from the
        call to the card's finishing the answer is the snapshot latency."""
        self._check_open()
        self.flush()
        t0 = time.perf_counter()
        # the aggregator's snapshot retries once at the next pow2 output
        # capacity if the wide merge overflows (with a warning)
        state, stats = self._agg.snapshot()
        self.wait()
        seconds = time.perf_counter() - t0
        groups = int(state.occupancy())
        if self._agg.mesh is not None:  # the ranks' groups, as the reference's global state
            from repro_torch.distributed import sharding

            (groups,) = sharding.host_all_reduce(self._agg.mesh, [groups], "sum")
        self.metrics.observe_snapshot(stats, groups=groups, seconds=seconds)
        self.metrics.observe_policy(self._agg.policy_events, readbacks=self._agg.readbacks_paid,
                                    current=self._agg.arm)
        return state, stats

    # -- eviction --------------------------------------------------------

    def retire_below(self, threshold) -> int:
        """Retire every resident row with key ``< threshold`` (watermark
        TTL).  One readback; returns the cumulative retired-row count, which
        every later snapshot also reports as ``stats.rows_retired``."""
        self._check_open()
        self.flush()
        total = self._agg.evict_below(threshold)
        self.metrics.rows_retired = total
        return total

    # -- teardown --------------------------------------------------------

    def close(self) -> tuple[AggState, SpillStats]:
        """Final destructive drain (the plain streaming ``finalize``); the
        service accepts no further ingest."""
        self._check_open()
        self.flush()
        self._closed = True
        out = self._agg.finalize()
        self.metrics.observe_policy(self._agg.policy_events, readbacks=self._agg.readbacks_paid,
                                    current=self._agg.arm)
        return out

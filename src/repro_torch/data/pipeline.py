"""Column-batch stream adapters for the streamed front door (counterpart
of the adapters of :mod:`repro.data.pipeline`, host NumPy only).

``iter_column_batches`` cuts a table into batch mappings and
``rebatch_columns`` re-chunks a producer's batches; pass either generator
as ``columns`` to :func:`repro_torch.aggregate`, which then absorbs the
input batch by batch, so the device holds at most a batch of input at a
time."""
from __future__ import annotations

import numpy as np


def iter_column_batches(columns, rows: int):
    """Split a column mapping into ``rows``-row batch mappings."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    cols = {k: np.asarray(v) for k, v in columns.items()}
    if not cols:
        return
    n = len(next(iter(cols.values())))
    for k, v in cols.items():
        if len(v) != n:
            raise ValueError(f"column {k!r} has {len(v)} rows, expected {n}")
    for s in range(0, n, rows):
        yield {k: v[s:s + rows] for k, v in cols.items()}


def rebatch_columns(batches, rows: int):
    """Re-chunk an iterable of column-batch mappings to ``rows``-row
    batches; producers emit whatever granularity is natural (log shards,
    row groups), the engine wants batches big enough to amortize its
    launches.  The final partial batch comes as it is."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    buf: dict[str, list[np.ndarray]] = {}
    have = 0
    for batch in batches:
        batch = {k: np.asarray(v) for k, v in batch.items()}
        if not batch:
            continue
        n = len(next(iter(batch.values())))
        if n == 0:
            continue
        if buf and set(batch) != set(buf):
            raise ValueError(f"batch columns {sorted(batch)} != stream columns {sorted(buf)}")
        for k, v in batch.items():
            buf.setdefault(k, []).append(v)
        have += n
        while have >= rows:
            cat = {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in buf.items()}
            yield {k: v[:rows] for k, v in cat.items()}
            buf = {k: [v[rows:]] for k, v in cat.items()}
            have -= rows
    if have:
        yield {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in buf.items()}

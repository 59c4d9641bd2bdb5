"""In-stream aggregation of key-sorted input, the paper's baseline #1
(counterpart of :mod:`repro.core.instream`).

"Each tuple read will have either the same by-list as the previous
tuple, or it will be an entirely new by-list": one pass over fixed-size
chunks with the open group carried from chunk to chunk, so the state held
is one chunk and one row whatever the input size.  Each chunk goes through
the backend's segmented combine; the emission cursor stays on the device,
so the loop pays no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch, sorted_ops
from repro_torch.core.types import (
    FIELDS,
    AggState,
    canon_keys,
    canon_payload,
    concat_states,
    empty_like,
    keys_to_torch,
    resolve_device,
    rows_to_state,
)


def instream_aggregate(sorted_keys, payload=None, *, chunk: int = 1024,
                       out_capacity: int | None = None, widths=None, backend: str = "auto",
                       device="cuda") -> tuple[AggState, torch.Tensor]:
    """Aggregate a key-sorted stream (host ``uint32``/``uint64`` keys, an
    optional (N, V) float payload).  Returns (output state of
    ``out_capacity`` rows, default N; the group count as a device
    scalar).  Groups past ``out_capacity`` drop, as the reference's
    emission does."""
    keys = canon_keys(sorted_keys)
    payload = canon_payload(payload)
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    n = keys.shape[0]
    if out_capacity is None:
        out_capacity = n
    pt = None if payload is None else torch.from_numpy(payload).to(dev)
    state = rows_to_state(keys_to_torch(keys, dev), pt, key_dtype=keys.dtype, widths=widths)
    pad = (-n) % chunk
    if pad:
        state = concat_states(state, empty_like(state, pad))
    # one extra trash row takes the writes of rows that are not emitted
    out = empty_like(state, out_capacity + 1)
    open_grp = empty_like(state, 1)
    cur = torch.zeros((), dtype=torch.int64, device=dev)
    ar = torch.arange(chunk + 1, device=dev)
    for c in range(state.capacity // chunk):
        ch = state.map(lambda x: x[c * chunk:(c + 1) * chunk])
        # the open group, then the chunk: key-sorted (an EMPTY open group
        # never joins one), combined and compacted
        merged = sorted_ops.segmented_combine(concat_states(open_grp, ch), backend=backend)
        occ = merged.occupancy()
        e = (occ - 1).clamp(min=0)  # every group but the last is closed: emit
        dst = torch.where(ar < e, cur + ar, out_capacity).clamp(max=out_capacity)
        for f in FIELDS:
            getattr(out, f).index_copy_(0, dst, getattr(merged, f))
        cur = cur + e
        # carry the last, still open group
        open_grp = _keep_if(merged.map(lambda x: x.index_select(0, e.reshape(1))), occ > 0)
    # flush the final open group
    occ = open_grp.occupancy()
    dst = torch.where(occ > 0, cur, out_capacity).clamp(max=out_capacity).reshape(1)
    for f in FIELDS:
        getattr(out, f).index_copy_(0, dst, getattr(open_grp, f))
    return out.map(lambda x: x[:out_capacity]), cur + occ


def _keep_if(row: AggState, keep: torch.Tensor) -> AggState:
    """``row`` where the device bool ``keep`` holds, else an EMPTY row."""
    empty = empty_like(row, row.capacity)
    return AggState(*(torch.where(keep.reshape((1,) * getattr(row, f).dim()),
                                  getattr(row, f), getattr(empty, f)) for f in FIELDS),
                    key_dtype=row.key_dtype)

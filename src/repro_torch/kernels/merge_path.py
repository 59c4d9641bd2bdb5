"""Merge-absorb of two key-sorted states: the CUDA kernel of
``csrc/merge_path.cu`` and its plain version.

Counterpart of :mod:`repro.kernels.merge_path`'s ``merge_path_tiles`` with
the compaction of ``ops.merge_absorb_sorted``: every output row finds its
merge-path split (A wins ties, duplicates allowed on either side), then
the segmented combine compacts the merged rows to capacity ``|a|+|b|``.
The merge-join probe (``merge_path_probe_tiles``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.ordered_index import (  # noqa: F401
    merge_absorb_torch as merge_absorb_plain,
)
from repro_torch.core.types import AggState
from repro_torch.kernels import _build
from repro_torch.kernels.segmented_reduce import scratch_for

_P, _I, _LL = _build.P, _build.I, _build.LL
_ARGS = [_P] * 5 + [_LL] + [_P] * 5 + [_LL, _I, _I, _I, _LL] + [_P] * 12


def _alloc(like: AggState, n: int) -> AggState:
    """Uninitialised rows shaped like ``like``'s (the kernel writes all)."""
    def new(x):
        return torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)

    return like.map(new)


def merge_absorb_cuda(a: AggState, b: AggState, *, assume_unique: bool = False) -> AggState:
    """Launch the merge-absorb kernel on two key-sorted CUDA states.
    ``assume_unique`` is accepted for interface parity: the combine that
    follows the merge is exact whether or not the inputs hold duplicates."""
    del assume_unique
    _build.check_state(a, "a")
    _build.check_state(b, "b")
    if a.device != b.device or a.key_dtype != b.key_dtype or a.widths != b.widths:
        raise ValueError(
            f"merge of incompatible states: {a.device}/{a.key_dtype}/{a.widths} vs "
            f"{b.device}/{b.key_dtype}/{b.widths}"
        )
    na, nb = a.capacity, b.capacity
    f = _build.fn("merge_path", "repro_merge_absorb", _ARGS)
    merged = _alloc(a, na + nb)
    out = _alloc(a, na + nb)
    scratch = scratch_for("merge_path", "repro_merge_absorb_scratch_bytes", na + nb, a)
    ws, wm, wx = a.widths

    def ptrs(s):
        return [s.keys.data_ptr(), s.count.data_ptr(), s.sum.data_ptr(),
                s.min.data_ptr(), s.max.data_ptr()]

    err = f(*ptrs(a), na, *ptrs(b), nb, ws, wm, wx, a.empty, *ptrs(merged), *ptrs(out),
            scratch.data_ptr(), _build.stream_of(a.keys))
    _build.raise_on(err, "merge_absorb")
    return out

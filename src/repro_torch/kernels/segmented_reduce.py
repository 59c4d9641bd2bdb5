"""Segmented combine of a key-sorted state, compacted to the front: the
CUDA kernel of ``csrc/segmented_combine.cu`` and its plain version.

Counterpart of :mod:`repro.kernels.segmented_reduce` plus the compaction
of ``ops._compact``: the merge-absorb's fused pass with no B side (tiles
of 2,048 rows, a block scan and a decoupled look-back across tiles, the
groups written compacted), then a fill of the rows past the last group.
"""
from __future__ import annotations

import torch

from repro_torch.core.ordered_index import (  # noqa: F401
    segmented_combine_torch as segmented_combine_plain,
)
from repro_torch.core.types import AggState
from repro_torch.kernels import _build

_ARGS = [_build.P, _build.LL, _build.LL, _build.P, _build.P, _build.I, _build.P,
         _build.I, _build.P, _build.I] + [_build.P] * 7


def scratch_for(name: str, symbol: str, n: int, state: AggState) -> torch.Tensor:
    """Device scratch of a fused merge-absorb pass over ``n`` rows (its
    tiles' status words and counter), sized by ``symbol``."""
    f = _build.fn(name, symbol, [_build.LL, _build.I], _build.LL)
    nbytes = f(n, 1 + sum(state.widths))
    return torch.empty((nbytes,), dtype=torch.uint8, device=state.device)


def segmented_combine_cuda(state: AggState) -> AggState:
    """Launch the segmented-combine kernel on a key-sorted CUDA state."""
    _build.check_state(state, "state")
    n = state.capacity
    f = _build.fn("segmented_combine", "repro_segmented_combine", _ARGS)
    scratch = scratch_for("segmented_combine", "repro_segmented_combine_scratch_bytes", n, state)
    out = AggState(
        keys=torch.empty_like(state.keys), count=torch.empty_like(state.count),
        sum=torch.empty_like(state.sum), min=torch.empty_like(state.min),
        max=torch.empty_like(state.max), key_dtype=state.key_dtype,
    )
    ws, wm, wx = state.widths
    err = f(state.keys.data_ptr(), n, state.empty, state.count.data_ptr(),
            state.sum.data_ptr(), ws, state.min.data_ptr(), wm, state.max.data_ptr(), wx,
            out.keys.data_ptr(), out.count.data_ptr(), out.sum.data_ptr(),
            out.min.data_ptr(), out.max.data_ptr(), scratch.data_ptr(),
            _build.stream_of(state.keys))
    _build.raise_on(err, "segmented_combine")
    return out


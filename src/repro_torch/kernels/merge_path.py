"""The merge-path kernels: merge-absorb of two key-sorted states
(``csrc/merge_path.cu``) and the merge-join probe (``csrc/join_probe.cu``),
each beside its plain version.

Counterpart of :mod:`repro.kernels.merge_path`:

* ``merge_path_tiles`` with the compaction of ``ops.merge_absorb_sorted``,
  in one fused pass: each tile of 2,048 output rows merges its slices of
  ``a`` and ``b`` (A wins ties, duplicates allowed on either side) in
  shared memory and combines equal keys with a block scan and a decoupled
  look-back across tiles, writing the groups compacted to capacity
  ``|a|+|b|``; a second small kernel fills the rows past the last group;
* ``merge_path_probe_tiles`` with ``ops.join_probe``: each sorted left key
  finds its lower bound in the sorted right keys, clipped into the right
  side's rows, and a hit flag (EMPTY never hits).
"""
from __future__ import annotations

import torch

from repro_torch.core.merge_join import join_probe_torch as join_probe_plain  # noqa: F401
from repro_torch.core.ordered_index import (  # noqa: F401
    merge_absorb_torch as merge_absorb_plain,
)
from repro_torch.core.types import AggState
from repro_torch.kernels import _build
from repro_torch.kernels.segmented_reduce import scratch_for

_P, _I, _LL = _build.P, _build.I, _build.LL
_ARGS = [_P] * 5 + [_LL] + [_P] * 5 + [_LL, _I, _I, _I, _LL] + [_P] * 7
_PROBE_ARGS = [_P, _LL, _P, _LL, _LL, _P, _P, _P]


def _alloc(like: AggState, n: int) -> AggState:
    """Uninitialised rows shaped like ``like``'s (the kernel writes all)."""
    def new(x):
        return torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)

    return like.map(new)


def merge_absorb_cuda(a: AggState, b: AggState, *, assume_unique: bool = False) -> AggState:
    """Launch the merge-absorb kernel on two key-sorted CUDA states.
    ``assume_unique`` is accepted for interface parity: the combine fused
    into the merge is exact whether or not the inputs hold duplicates."""
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
    out = _alloc(a, na + nb)
    scratch = scratch_for("merge_path", "repro_merge_absorb_scratch_bytes", na + nb, a)
    ws, wm, wx = a.widths

    def ptrs(s):
        return [s.keys.data_ptr(), s.count.data_ptr(), s.sum.data_ptr(),
                s.min.data_ptr(), s.max.data_ptr()]

    err = f(*ptrs(a), na, *ptrs(b), nb, ws, wm, wx, a.empty, *ptrs(out), scratch.data_ptr(),
            _build.stream_of(a.keys))
    _build.raise_on(err, "merge_absorb")
    return out


def join_probe_cuda(a_keys: torch.Tensor, b_keys: torch.Tensor, empty: int):
    """Launch the probe kernel: ``(pos, hit)`` of each key of the sorted
    CUDA key vector ``a_keys`` in the sorted ``b_keys`` (int32 positions
    clipped into ``[0, |b|-1]``, bool hits; EMPTY ``a`` rows never hit).
    An empty ``a_keys`` launches nothing."""
    _build.check(a_keys, torch.int64, "a_keys", ndim=1)
    _build.check(b_keys, torch.int64, "b_keys", ndim=1, device=a_keys.device)
    n, m = a_keys.shape[0], b_keys.shape[0]
    if max(n, m) >= 1 << 31:
        raise ValueError(f"probe of {n} rows in {m}: the kernel indexes rows with 32 bits")
    pos = torch.empty((n,), dtype=torch.int32, device=a_keys.device)
    hit = torch.empty((n,), dtype=torch.bool, device=a_keys.device)
    f = _build.fn("join_probe", "repro_join_probe", _PROBE_ARGS)
    err = f(a_keys.data_ptr(), n, b_keys.data_ptr(), m, empty, pos.data_ptr(), hit.data_ptr(),
            _build.stream_of(a_keys))
    _build.raise_on(err, "join_probe")
    return pos, hit

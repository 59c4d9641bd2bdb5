"""Bitonic merge-absorb of two key-sorted u32-domain states: the CUDA
kernel of ``csrc/merge_aggregate.cu`` and its plain version.

Counterpart of :mod:`repro.kernels.merge_aggregate` (``merge_absorb_tiles``)
with the compaction of ``ops.merge_absorb_sorted_bitonic``, the previous
generation of the wide-merge step, kept as the foil of the merge-path
kernel (``merge_path.py``): both sides are padded with EMPTY rows to
``n``, the next power of two of the larger capacity; A ++ reverse(B) is
bitonic, and one sweep of log2(2n) compare-exchange stages orders it (at
equal keys each side keeps its own row, as the reference's ``take_self``);
the segmented combine then absorbs the duplicates and compacts the groups
to the front.  The output is trimmed to ``min(|a| + |b|, 2n)`` rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ordered_index import argsort_torch, segmented_combine_torch
from repro_torch.core.types import AggState, concat_states, take
from repro_torch.kernels import _build
from repro_torch.kernels.merge_path import _alloc
from repro_torch.kernels.segmented_reduce import scratch_for

_P, _I, _LL = _build.P, _build.I, _build.LL
_ARGS = ([_P] * 5 + [_LL] + [_P] * 5 + [_LL, _LL, _I, _I, _I, _LL] + [_P] * 2 + [_P] * 10
         + [_P] * 2)


def next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def _check_u32(a: AggState, b: AggState) -> None:
    for name, s in (("a", a), ("b", b)):
        if s.key_dtype != np.uint32:
            raise ValueError(f"bitonic merge-absorb: {name} has {s.key_dtype} keys; the "
                             "bitonic path takes u32-domain keys only")
    if a.device != b.device or a.widths != b.widths:
        raise ValueError(f"merge of incompatible states: {a.device}/{a.widths} vs "
                         f"{b.device}/{b.widths}")


def merge_absorb_bitonic_plain(a: AggState, b: AggState) -> AggState:
    """Concatenate, stable-sort, combine and compact (the reference's
    ``ref_merge_absorb`` and ``ops._compact``); EMPTY padding rows form no
    group, so none is added."""
    _check_u32(a, b)
    merged = concat_states(a, b)
    return segmented_combine_torch(take(merged, argsort_torch(merged.keys)))


def merge_absorb_bitonic_cuda(a: AggState, b: AggState) -> AggState:
    """Launch the bitonic merge-absorb kernel on two key-sorted CUDA
    states (u32 domain)."""
    _check_u32(a, b)
    _build.check_state(a, "a")
    _build.check_state(b, "b")
    na, nb = a.capacity, b.capacity
    n = next_pow2(max(na, nb))
    if 2 * n >= 1 << 31:
        raise ValueError(f"bitonic merge of 2 x {n} rows: the kernel indexes rows with 32 bits")
    dev = a.device
    kbuf = torch.empty((2 * n,), dtype=torch.int64, device=dev)
    sbuf = torch.empty((2 * n,), dtype=torch.int32, device=dev)
    merged, out = _alloc(a, 2 * n), _alloc(a, 2 * n)
    scratch = scratch_for("merge_aggregate", "repro_merge_absorb_bitonic_scratch_bytes", 2 * n, a)
    ws, wm, wx = a.widths

    def ptrs(s):
        return [s.keys.data_ptr(), s.count.data_ptr(), s.sum.data_ptr(),
                s.min.data_ptr(), s.max.data_ptr()]

    f = _build.fn("merge_aggregate", "repro_merge_absorb_bitonic", _ARGS)
    err = f(*ptrs(a), na, *ptrs(b), nb, n, ws, wm, wx, a.empty, kbuf.data_ptr(),
            sbuf.data_ptr(), *ptrs(merged), *ptrs(out), scratch.data_ptr(),
            _build.stream_of(a.keys))
    _build.raise_on(err, "merge_absorb_bitonic")
    cap = min(na + nb, 2 * n)
    return out.map(lambda x: x[:cap])

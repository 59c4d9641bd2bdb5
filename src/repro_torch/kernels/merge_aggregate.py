"""Bitonic merge-absorb of two key-sorted u32-domain states: the CUDA
kernel of ``csrc/merge_aggregate.cu`` and its plain version.

Counterpart of :mod:`repro.kernels.merge_aggregate` (``merge_absorb_tiles``)
with the compaction of ``ops.merge_absorb_sorted_bitonic``, the previous
generation of the wide-merge step, kept as the foil of the merge-path
kernel (``merge_path.py``).  The kernel sorts one 64-bit word (key << 32) |
src a row on ``m = next_pow2(|a| + |b|)`` positions: ``a`` ascending, then
``b`` reversed and virtually padded with EMPTY rows (``b``'s row ``q`` has
src ``m + q``).  That sequence is bitonic and its words are distinct, so one
bitonic merge sweep of log2(m) stages orders it exactly as the plain
version's stable argsort of ``a ++ b``.  Strides of a tile or more run as
global passes of several stages each (:func:`plan`), the rest in shared
memory, one tile a block, where the segmented combine then absorbs the
duplicates and compacts the groups to the front.  The output has
``min(|a| + |b|, 2n)`` rows, ``n`` the next power of two of the larger side,
as the reference trims it: that is ``|a| + |b|``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.ordered_index import argsort_torch, segmented_combine_torch
from repro_torch.core.types import AggState, concat_states, take
from repro_torch.kernels import _build
from repro_torch.kernels.merge_path import _alloc
from repro_torch.kernels.segmented_reduce import scratch_for

_P, _I, _LL = _build.P, _build.I, _build.LL
_ARGS = ([_P] * 5 + [_LL] + [_P] * 5 + [_LL, _I, _I, _I, _LL, _LL, _I, _P, _I, _P]
         + [_P] * 5 + [_P] * 2)

TILE = 8192  # words a block merges in shared memory (1,024 threads x 8)
MAX_R = 5  # stages a global pass keeps in registers (2^R words a thread)
MAX_WORDS = 1 << 31  # every src (below 2m) fits in 32 bits


def next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def plan(na: int, nb: int, tile: int = TILE) -> tuple[int, int, tuple[int, ...]]:
    """``(m, tile, passes)`` of the merge of ``na`` and ``nb`` rows: ``m =
    next_pow2(na + nb)`` (at least 2) positions; the network's tile,
    ``min(m, tile)`` words; and the stages of each global pass, first to
    last, which take the strides ``m/2`` down to ``tile`` in as few passes
    of at most ``MAX_R`` stages as there can be, the larger passes first
    (``2^21`` words: ``(4, 4)``; ``2^22``: ``(5, 4)``).  The kernel runs
    only ``tile == TILE``; the emulation in the tests takes smaller ones."""
    m = next_pow2(na + nb)
    stages = max(0, m.bit_length() - tile.bit_length())
    npass = -(-stages // MAX_R)
    passes = tuple(stages // npass + (i < stages % npass) for i in range(npass))
    return m, min(m, tile), passes


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
    m, tile, passes = plan(na, nb)
    if m > MAX_WORDS:
        raise ValueError(f"bitonic merge of {na} + {nb} rows on {m} positions: the kernel "
                         f"keeps each row's source in 32 bits (at most {MAX_WORDS} positions)")
    dev = a.device
    out = _alloc(a, na + nb)
    scratch = scratch_for("merge_aggregate", "repro_merge_absorb_bitonic_scratch_bytes",
                          na + nb, a)
    words = torch.empty((m,), dtype=torch.int64, device=dev) if passes else None
    ws, wm, wx = a.widths

    def ptrs(s):
        return [s.keys.data_ptr(), s.count.data_ptr(), s.sum.data_ptr(),
                s.min.data_ptr(), s.max.data_ptr()]

    f = _build.fn("merge_aggregate", "repro_merge_absorb_bitonic", _ARGS)
    err = f(*ptrs(a), na, *ptrs(b), nb, ws, wm, wx, a.empty, m, tile,
            (ctypes.c_int * len(passes))(*passes), len(passes),
            None if words is None else words.data_ptr(), *ptrs(out), scratch.data_ptr(),
            _build.stream_of(a.keys))
    _build.raise_on(err, f"merge_absorb_bitonic (m {m}, tile {tile}, passes {passes})")
    return out

"""Stable argsort of int64 keys: the CUDA kernel of ``csrc/argsort.cu``
and its plain version.

Counterpart of :mod:`repro.kernels.bitonic_sort` as reached through
``ops.argsort_keys``: a block-local bitonic sort of 2048-pair tiles in
shared memory, then merge-path passes across tiles.  Pairs of (key, row
index) are compared, so the order is the stable one, as the reference's
index lane makes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.ordered_index import argsort_torch as argsort_plain  # noqa: F401
from repro_torch.kernels import _build


def argsort_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Launch the argsort kernel on ``keys`` (contiguous 1-D int64 on a
    CUDA device); returns the int32 permutation."""
    _build.check(keys, torch.int64, "keys", ndim=1)
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"argsort of {n} keys: row indices are 32-bit")
    f = _build.fn("argsort", "repro_argsort", [_build.P, _build.LL] + [_build.P] * 6)
    kbuf = torch.empty((2, n), dtype=torch.int64, device=keys.device)
    ibuf = torch.empty((2, n), dtype=torch.int32, device=keys.device)
    perm = torch.empty((n,), dtype=torch.int32, device=keys.device)
    err = f(keys.data_ptr(), n, kbuf[0].data_ptr(), ibuf[0].data_ptr(),
            kbuf[1].data_ptr(), ibuf[1].data_ptr(), perm.data_ptr(), _build.stream_of(keys))
    _build.raise_on(err, "argsort")
    return perm

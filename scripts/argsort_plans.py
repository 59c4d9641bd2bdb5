#!/usr/bin/env python3
"""Time every plan the argsort kernel allows (``csrc/argsort.cu``: a block
of a power-of-two tile, a cluster of 2 to 16 CTAs of 512 to 4,096 pairs,
clusters then merge passes) at the sizes around ``bitonic_sort.plan``'s
boundaries, on one CUDA card, beside ``torch.argsort(stable=True)``.  The
plan's boundaries are chosen from these numbers.  Run from the repository
root:

    python3 scripts/argsort_plans.py

Keys are seeded u32-domain keys with duplicates and 20% EMPTY rows; every
plan's permutation must equal the plain version's.  Device ms by
``chip_smoke.cuda_ms`` (CUDA events around 20 calls the host enqueued while
the card slept).  Prints one JSON line; exits 2 without a card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SIZES = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 262144)
VARIANTS = {"block": 1, "cluster": 2, "large": 3}


def candidates(n: int):
    """(variant, tile, cluster) of every plan the C entry point takes for n."""
    out = []
    if n <= 4096:
        out.append(("block", max(64, 1 << (n - 1).bit_length()), 1))
    for tile in (512, 1024, 2048, 4096):
        ctas = 1 << ((n + tile - 1) // tile - 1).bit_length()
        if 2 <= ctas <= 16:
            out.append(("cluster", tile, ctas))
        if n > tile * 8 and tile >= 2048:
            out += [("large", tile, c) for c in (8, 16) if n > tile * c]
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("argsort_plans: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, bitonic_sort

    dev = torch.device("cuda", 0)
    f = _build.fn("argsort", "repro_argsort", bitonic_sort._ARGS)
    rng = np.random.default_rng(cs.SEED)
    rows = []
    for n in SIZES:
        keys = cs.make_state(rng, n, np.uint32, max(1, n // 4), 0.2, (0, 0, 0), sort=False,
                             device=dev).keys
        want = bitonic_sort.argsort_plain(keys)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        kbuf = torch.empty((2, n), dtype=torch.int64, device=dev)
        ibuf = torch.empty((2, n), dtype=torch.int32, device=dev)
        for variant, tile, cluster in candidates(n):
            def call():
                err = f(keys.data_ptr(), n, VARIANTS[variant], tile, cluster, kbuf[0].data_ptr(),
                        ibuf[0].data_ptr(), kbuf[1].data_ptr(), ibuf[1].data_ptr(),
                        perm.data_ptr(), _build.stream_of(keys))
                _build.raise_on(err, f"argsort ({variant}, {tile}, {cluster})")

            call()
            if not torch.equal(perm, want):
                raise SystemExit(f"FAIL argsort n={n} ({variant}, {tile}, {cluster}): differs "
                                 "from the plain version")
            rows.append(dict(n=n, plan=[variant, tile, cluster],
                             chosen=bitonic_sort.plan(n) == (variant, tile, cluster),
                             device_ms=cs.cuda_ms(call, 20)[0]))
        rows.append(dict(n=n, plan="torch.argsort(stable=True)", chosen=False,
                         device_ms=cs.cuda_ms(lambda: torch.argsort(keys, stable=True), 20)[0]))
    print(json.dumps(dict(card=cs.card_line(), plans=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compute the JAX package's results for the cases of
``tests/test_torch_baselines.py`` and store them in
``tests/data/torch_baselines_reference.npz``, which that test module holds
the port against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_baselines_reference.py

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference: keys, counts, stats and
host values exactly, float planes bit for bit).  Each case compiles its
own XLA programs, so a full run takes minutes on a CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):  # the reference's old name
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    import test_torch_baselines as cases

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the stored file instead of writing it")
    args = ap.parse_args()
    out: dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    for name in cases.CASES:
        out.update(cases.to_arrays(name, cases.compute(name, ref=True)))
        jax.clear_caches()  # one process compiles every case's programs
        print(f"[{time.perf_counter() - t0:7.1f} s] {name}", flush=True)
    if not args.check:
        cases.REFERENCE_FILE.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cases.REFERENCE_FILE, **out)
        print(f"wrote {len(cases.CASES)} cases to {cases.REFERENCE_FILE.relative_to(ROOT)}")
        return 0
    stored = np.load(cases.REFERENCE_FILE)
    bad = sorted(set(stored.files) ^ set(out))
    bad += [k for k in out if k in stored.files and not (
        out[k].dtype == stored[k].dtype and np.array_equal(out[k], stored[k], equal_nan=False)
        if out[k].dtype.kind != "U" else str(out[k]) == str(stored[k]))]
    for k in bad:
        print(f"differs: {k}")
    print(f"{len(cases.CASES)} cases, {len(out)} arrays, {len(bad)} differences")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

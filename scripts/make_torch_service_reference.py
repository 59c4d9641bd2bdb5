#!/usr/bin/env python3
"""Compute the JAX package's results for the stored cases of
``tests/test_torch_service.py`` (its ``STORED_CASES``, run by its
``compute(name, ref=True)``) and store them in
``tests/data/torch_service_reference.npz``, which that module holds the port
against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_service_reference.py

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference: keys, counts, stats and
host values exactly, float planes bit for bit).  Each case compiles its own
XLA programs, so a full run takes minutes on a CPU.
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
    import importlib

    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):  # the reference's old name
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the stored file instead of writing it")
    args = ap.parse_args()
    mod = importlib.import_module("test_torch_service")
    out: dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    for name in mod.STORED_CASES:
        out.update(mod.to_arrays(name, mod.compute(name, ref=True)))
        jax.clear_caches()  # one process compiles every case's programs
        print(f"[{time.perf_counter() - t0:7.1f} s] {name}", flush=True)
    path = mod.REFERENCE_FILE
    if not args.check:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, **out)
        print(f"wrote {len(mod.STORED_CASES)} cases to {path.relative_to(ROOT)}")
        return 0
    stored = np.load(path)
    bad = sorted(set(stored.files) ^ set(out))
    bad += [k for k in out if k in stored.files and not (
        out[k].dtype == stored[k].dtype and np.array_equal(out[k], stored[k])
        if out[k].dtype.kind != "U" else str(out[k]) == str(stored[k]))]
    for k in bad:
        print(f"differs: {k}")
    print(f"{len(mod.STORED_CASES)} cases, {len(out)} arrays, {len(bad)} differences")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

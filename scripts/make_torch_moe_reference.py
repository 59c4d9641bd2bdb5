#!/usr/bin/env python3
"""Compute the JAX package's kernel results for the cases of
``tests/test_torch_moe.py`` (its ``STORED_CASES``: the Pallas grouped
matmul and merge-absorb tiles in interpret mode, and ``ops``' bitonic
merge-absorb, on per-case seeded inputs) and store them in
``tests/data/torch_moe_reference.npz``, which that module holds the port's
plain versions against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_moe_reference.py

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference, bit for bit).
"""
import sys

from _stored_reference import main

if __name__ == "__main__":
    sys.exit(main("test_torch_moe", __doc__))

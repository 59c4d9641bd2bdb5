#!/usr/bin/env python3
"""Compute the JAX package's logits for the dense-family cases of
``tests/test_torch_dense.py`` (its ``STORED_CASES``: each smoke config, and
each with its full config's activation, cache duplication, bias and tying,
through ``forward`` and through the prefill and teacher-forced serve
steps) and store them in ``tests/data/torch_dense_reference.npz``, which that
module holds the port's models against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_dense_reference.py

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference, bit for bit).
"""
import sys

from _stored_reference import main

if __name__ == "__main__":
    sys.exit(main("test_torch_dense", __doc__))

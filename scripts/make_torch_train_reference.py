#!/usr/bin/env python3
"""Compute the JAX package's results for the training cases of
``tests/test_torch_train.py`` (its ``STORED_CASES``: the grouped matmul's
gradients, ``lm_loss`` and its gradients for every registered family,
three train steps with AdamW and Adafactor at ``grad_accum`` 1 and 2, and
the top-k compression with ``aggregate_sparse``) and store them in
``tests/data/torch_train_reference.npz``, which that module holds the
port's training path against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_train_reference.py

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference, bit for bit).
"""
import sys

from _stored_reference import main

if __name__ == "__main__":
    sys.exit(main("test_torch_train", __doc__))

#!/usr/bin/env python3
"""Compute the JAX package's results for the model-family cases of
``tests/test_torch_families.py`` (its ``STORED_CASES``: deepseek-v3's,
mamba2's, zamba2's, qwen2-vl's and hubert's smoke models through
``forward`` and through the prefill and teacher-forced serve steps, and
MLA, the SSD scan, the Mamba2 block and M-RoPE on their own) and store them
in ``tests/data/torch_families_reference.npz``, which that module holds the
port's models against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_families_reference.py

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference, bit for bit).
"""
import sys

from _stored_reference import main

if __name__ == "__main__":
    sys.exit(main("test_torch_families", __doc__))

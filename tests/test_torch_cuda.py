"""The CUDA kernels held against their plain versions on the card, and the
port's pipeline on the card against its plain CPU run.  Every test needs
an NVIDIA card and ``nvcc`` and skips elsewhere; on the card run

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port).
Payloads are integer-valued, so sums agree exactly in any order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ordered_index as oi
from repro_torch.core import pipeline
from repro_torch.core.types import ExecConfig, empty_key, rows_to_state, state_to_numpy, take
from repro_torch.kernels import bitonic_sort, merge_path, ops, segmented_reduce

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(17)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _state(dev, n, key_dtype, domain, *, widths=(1, 1, 1), empty_frac=0.1, sort=True,
           unique=False):
    k = RNG.integers(0, domain, n).astype(np.int64)
    if key_dtype == np.uint64:
        k = k * 2_147_483_659 - (1 << 62)
    k[RNG.random(n) < empty_frac] = empty_key(key_dtype)
    pay = torch.from_numpy(RNG.integers(0, 50, (n, max(widths))).astype(np.float32))
    st = rows_to_state(torch.from_numpy(k).to(dev), pay.to(dev), key_dtype=key_dtype,
                       widths=widths)
    if sort:
        st = take(st, oi.argsort_torch(st.keys))
        if unique:
            st = oi.segmented_combine_torch(st)
    return st


def _assert_same(a, b):
    for f in ("keys", "count", "sum", "min", "max"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n", [1, 2047, 2049, 70000])
def test_argsort_kernel_matches_plain(dev, n, key_dtype):
    keys = _state(dev, n, key_dtype, max(1, n // 4), widths=(0, 0, 0), empty_frac=0.3,
                  sort=False).keys
    assert torch.equal(bitonic_sort.argsort_cuda(keys), bitonic_sort.argsort_plain(keys))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,domain,widths", [
    (1, 1, (1, 1, 1)), (513, 60, (2, 0, 2)), (100_000, 1, (1, 0, 0)),  # one group spans all
    (100_000, 20_000, (0, 0, 0)),
])
def test_segmented_combine_kernel_matches_plain(dev, n, domain, widths, key_dtype):
    st = _state(dev, n, key_dtype, domain, widths=widths)
    _assert_same(segmented_reduce.segmented_combine_cuda(st),
                 segmented_reduce.segmented_combine_plain(st))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("assume_unique", [False, True])
@pytest.mark.parametrize("na,nb", [(0, 7), (9, 0), (3000, 500), (120_000, 4096)])
def test_merge_absorb_kernel_matches_plain(dev, na, nb, assume_unique, key_dtype):
    a = _state(dev, na, key_dtype, 2 * na + 1, unique=True)
    b = _state(dev, nb, key_dtype, 2 * na + 1, unique=assume_unique)
    _assert_same(merge_path.merge_absorb_cuda(a, b, assume_unique=assume_unique),
                 merge_path.merge_absorb_plain(a, b, assume_unique=assume_unique))


def test_wrappers_launch_on_cuda_and_count(dev):
    ops.reset_launch_counts()
    st = _state(dev, 1000, np.uint32, 300)
    ops.merge_absorb_sorted(ops.segmented_combine(st), st)
    ops.argsort_keys(st.keys)
    assert ops.LAUNCHES == {"argsort": 1, "segmented_combine": 1, "merge_absorb": 1}


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_pipeline_on_the_card_matches_cpu(dev, key_dtype):
    keys = RNG.integers(0, 3000, 20_000).astype(key_dtype)
    if key_dtype == np.uint64:
        keys = keys * np.uint64(0xF000000000000000 // 3000)
    pay = RNG.integers(0, 50, (20_000, 1)).astype(np.float32)
    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)
    out = [pipeline.insort_aggregate_device(keys, pay, cfg, output_estimate=1 << 14,
                                            device=d) for d in (dev, "cpu")]
    (sa, da), (sb, db) = out
    assert da.as_dict() == db.as_dict()
    a, b = state_to_numpy(sa), state_to_numpy(sb)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)

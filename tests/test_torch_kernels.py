"""The port's kernel modules held against the JAX package's kernels.

Each plain version (what the port's wrappers run on a CPU tensor, and what
the CUDA kernels are held against on the card) must agree with the Pallas
kernel in interpret mode at <= 256 rows, where the reference pads to a
power of two, and with the reference's ``"xla"`` backend at a few thousand
rows.  Keys and counts must be equal; float planes agree within rtol 1e-4
(the two sum in different orders).
"""
import functools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import sorted_ops as jso
from repro.core.types import key_dtype_context, rows_to_state as j_rows_to_state
from repro_torch.core.types import FIELDS, AggState, state_from_numpy, state_to_numpy
from repro_torch.kernels import bitonic_sort, grouped_matmul, ops

RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _reference_x64_scope(monkeypatch):
    """The reference scopes its uint64 work with
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; lend it the old name for one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def _keys(n, key_dtype, domain, empty_frac=0.0):
    k = RNG.integers(0, domain, n).astype(key_dtype)
    if key_dtype == np.uint64:  # both halves of the u64 domain
        k = k * np.uint64(0x9E3779B97F4A7C15 // domain)
    k[RNG.random(n) < empty_frac] = np.iinfo(key_dtype).max
    return k


def _ref_state(keys, payload, widths=None):
    """A reference (JAX) state as NumPy arrays."""
    with key_dtype_context(keys):
        st = j_rows_to_state(keys, payload, widths=widths)
        return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def _sorted_state(n, key_dtype, domain, width, *, unique=False, widths=None):
    """Key-sorted rows; ``unique`` draws distinct keys (a duplicate-free
    ordered index), else keys repeat."""
    k = _keys(n, key_dtype, domain)
    if unique:
        k = np.unique(k)
    k = np.sort(k)
    pay = RNG.normal(size=(k.size, width)).astype(np.float32)
    return _ref_state(k, pay, widths)


def _jax_call(fn, *states, **kw):
    """``fn`` of the reference, jitted (one compile instead of one per op)."""
    keys = states[0]["keys"]
    with key_dtype_context(keys):
        js = [jso.AggState(*(jax.numpy.asarray(s[f]) for f in FIELDS)) for s in states]
        return jax.jit(functools.partial(fn, **kw))(*js)


def _np(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def _port(arrs) -> AggState:
    return state_from_numpy(arrs, device="cpu")


def _assert_states(got: AggState, want: dict):
    g = state_to_numpy(got)
    np.testing.assert_array_equal(g["keys"], want["keys"])
    np.testing.assert_array_equal(g["count"], want["count"])
    for f in ("sum", "min", "max"):
        np.testing.assert_allclose(g[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# argsort (bitonic_sort_multi through ops.argsort_keys)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_argsort_plain_matches_pallas_with_interior_empty(key_dtype):
    """Stable order, interior EMPTY rows included (the reference's index
    lane makes its bitonic network stable; the plain version must give the
    same permutation)."""
    k = _keys(100, key_dtype, 40, empty_frac=0.4)  # the reference pads to 128
    arrs = _ref_state(k, None)
    want = _jax_call(lambda s: jso.dispatch.get_backend("pallas").argsort(s.keys), arrs)
    got = ops.argsort_keys(_port(arrs).keys)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n", [33, 2049])
def test_argsort_plain_matches_pallas_at_class_edges(n, key_dtype):
    """One past the CUDA kernel's warp class (32) and past its CTAs of
    2,048 pairs: the reference pads to 64 and 4,096 rows."""
    k = _keys(n, key_dtype, max(2, n // 3), empty_frac=0.3)
    arrs = _ref_state(k, None)
    want = _jax_call(lambda s: jso.dispatch.get_backend("pallas").argsort(s.keys), arrs)
    np.testing.assert_array_equal(ops.argsort_keys(_port(arrs).keys).numpy(), np.asarray(want))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_argsort_plain_matches_xla(key_dtype):
    k = _keys(3000, key_dtype, 500, empty_frac=0.1)
    arrs = _ref_state(k, None)
    want = _jax_call(lambda s: jso.dispatch.get_backend("xla").argsort(s.keys), arrs)
    np.testing.assert_array_equal(ops.argsort_keys(_port(arrs).keys).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# segmented combine (segmented_scan_tiles + _compact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype,n,width,widths", [
    (np.uint32, 200, 3, None), (np.uint64, 256, 2, (2, 0, 0)),
])
def test_segmented_combine_plain_matches_pallas(key_dtype, n, width, widths):
    arrs = _sorted_state(n, key_dtype, max(2, n // 8), width, widths=widths)
    want = _np(_jax_call(jso.segmented_combine, arrs, backend="pallas"))
    _assert_states(ops.segmented_combine(_port(arrs)), want)


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,domain", [(33, 5), (2049, 256), (2049, 1)])
def test_segmented_combine_plain_matches_pallas_at_tile_edges(n, domain, key_dtype):
    """One row past the kernel's warp (32) and tile (2,048 rows) sizes, and
    one group spanning both tiles of 2,049 rows."""
    arrs = _sorted_state(n, key_dtype, domain, 2)
    want = _np(_jax_call(jso.segmented_combine, arrs, backend="pallas"))
    _assert_states(ops.segmented_combine(_port(arrs)), want)


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_segmented_combine_plain_matches_xla(key_dtype):
    arrs = _sorted_state(3000, key_dtype, 400, 2)
    arrs["keys"] = np.where(np.arange(3000) < 2500, arrs["keys"], np.iinfo(key_dtype).max)
    want = _np(_jax_call(jso.segmented_combine, arrs, backend="xla"))
    _assert_states(ops.segmented_combine(_port(arrs)), want)


# ---------------------------------------------------------------------------
# merge-absorb (merge_path_tiles + _compact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_merge_absorb_plain_matches_pallas(key_dtype):
    """Unequal lengths, both inputs duplicate-free, so both combine paths of
    the plain version (segmented and pair) answer the one kernel result."""
    a = _sorted_state(150, key_dtype, 200, 2, unique=True)
    b = _sorted_state(70, key_dtype, 200, 2, unique=True)
    want = _np(_jax_call(jso.merge_absorb, a, b, backend="pallas"))
    for assume_unique in (False, True):
        _assert_states(
            ops.merge_absorb_sorted(_port(a), _port(b), assume_unique=assume_unique), want)


@pytest.mark.parametrize("key_dtype,assume_unique", [(np.uint32, False), (np.uint64, True)])
def test_merge_absorb_plain_matches_xla(key_dtype, assume_unique):
    a = _sorted_state(2000, key_dtype, 2500, 1, unique=True)
    b = _sorted_state(700, key_dtype, 2500, 1, unique=assume_unique)  # else duplicates
    want = _np(_jax_call(jso.merge_absorb, a, b, backend="xla", assume_unique=assume_unique))
    _assert_states(ops.merge_absorb_sorted(_port(a), _port(b), assume_unique=assume_unique),
                   want)


# ---------------------------------------------------------------------------
# the wrappers never answer a non-CPU tensor with a plain version
# ---------------------------------------------------------------------------


def _meta_state(n=16):
    return AggState(
        keys=torch.empty(n, dtype=torch.int64, device="meta"),
        count=torch.empty(n, dtype=torch.int32, device="meta"),
        sum=torch.empty((n, 1), dtype=torch.float32, device="meta"),
        min=torch.empty((n, 0), dtype=torch.float32, device="meta"),
        max=torch.empty((n, 0), dtype=torch.float32, device="meta"),
        key_dtype=np.dtype(np.uint32),
    )


@pytest.mark.parametrize("call", [
    lambda s: ops.argsort_keys(s.keys),
    lambda s: ops.segmented_combine(s),
    lambda s: ops.merge_absorb_sorted(s, s),
    lambda s: ops.join_probe(s.keys, s.keys, s.empty),
    lambda s: ops.moe_grouped_matmul(s.sum.reshape(4, 4), s.sum.reshape(2, 4, 2), capacity=2),
    lambda s: ops.merge_absorb_sorted_bitonic(s, s),
], ids=["argsort", "segmented_combine", "merge_absorb", "join_probe", "grouped_matmul",
        "merge_absorb_bitonic"])
def test_wrappers_take_the_kernel_path_off_the_cpu(call):
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        call(_meta_state())
    assert ops.LAUNCHES == before


# ---------------------------------------------------------------------------
# which grouped-matmul variant a product takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d,f,c,aligned,want", [
    (torch.bfloat16, 2048, 768, 8, True, ("wgmma", 8)),      # decode's wg/wi
    (torch.bfloat16, 768, 2048, 64, True, ("wgmma", 64)),    # prefill's wo
    (torch.bfloat16, 200, 136, 13, True, ("wgmma", 16)),     # multiples of 8, not of 64
    (torch.bfloat16, 136, 200, 72, True, ("wgmma", 128)),
    (torch.bfloat16, 200, 136, 264, True, ("wgmma", 256)),   # two N tiles
    (torch.bfloat16, 200, 130, 64, True, ("simt", 64)),      # F no multiple of 8
    (torch.bfloat16, 100, 8, 5, True, ("simt", 8)),          # D no multiple of 8
    (torch.bfloat16, 0, 8, 8, True, ("simt", 8)),            # no depth: nothing for TMA
    (torch.bfloat16, 2048, 768, 8, False, ("simt", 8)),      # not 16-byte aligned
    (torch.float32, 2048, 768, 8, True, ("simt", 8)),        # wgmma takes no float32
    (torch.float32, 768, 2048, 33, True, ("simt", 64)),
])
def test_grouped_matmul_variant_rule(dtype, d, f, c, aligned, want):
    assert grouped_matmul.variant(dtype, d, f, c, aligned=aligned) == want


# ---------------------------------------------------------------------------
# which size class an argsort takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,want", [
    (0, ("warp", 32, 1)), (1, ("warp", 32, 1)), (32, ("warp", 32, 1)),   # decode's 32 keys
    (33, ("block", 64, 1)), (65, ("block", 128, 1)), (1024, ("block", 1024, 1)),
    (1025, ("cluster", 1024, 2)), (2048, ("cluster", 1024, 2)),
    (2049, ("cluster", 1024, 4)), (8191, ("cluster", 1024, 8)),
    (8192, ("cluster", 1024, 8)),                                       # prefill's 8,192
    (8193, ("cluster", 1024, 16)), (16385, ("cluster", 2048, 16)),
    (32769, ("cluster", 4096, 16)), (65535, ("cluster", 4096, 16)),
    (65536, ("cluster", 4096, 16)),                                     # the aggregate's batch
    (65537, ("large", 2048, 16)), (1 << 20, ("large", 2048, 16)),
])
def test_argsort_plan_rule(n, want):
    """The plan depends on n alone; up to 65,536 keys it is one launch (the
    warp, block and cluster classes), and a cluster covers n."""
    got = bitonic_sort.plan(n)
    assert got == want
    variant, tile, cluster = got
    if variant != "large":
        assert n <= tile * cluster

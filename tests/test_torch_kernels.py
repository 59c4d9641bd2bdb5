"""The port's kernel modules held against the JAX package's kernels.

Each plain version (what the port's wrappers run on a CPU tensor, and what
the CUDA kernels are held against on the card) must agree with the Pallas
kernel in interpret mode at <= 256 rows, where the reference pads to a
power of two, and with the reference's ``"xla"`` backend at a few thousand
rows.  Keys and counts must be equal; float planes agree within rtol 1e-4
(the two sum in different orders).  The tile-batch sorts
(``bitonic_sort.bitonic_sort`` / ``bitonic_sort_kv``) and ``ops.sort_keys``
/ ``argsort_u32`` are held against the reference's on the shapes of
``tests/test_kernels.py``: sorted keys equal, and a moved payload a
permutation that gives them (the reference's network leaves the payload
order among equal keys undefined).

The reference's Pallas kernels run for minutes in interpret mode, so its
results for ``CASES`` (the inputs beside them) are computed by
``scripts/make_torch_kernels_reference.py`` from this module's own case
table and read here from ``tests/data/torch_kernels_reference.npz``; the
JAX package does not change, so neither does that file.
``test_stored_reference_is_the_reference_output`` recomputes one case of
each kind live, and the script's ``--check`` recomputes every case.
"""
import functools
import zlib
from pathlib import Path

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, st

from repro.core import sorted_ops as jso
from repro.core.types import key_dtype_context, rows_to_state as j_rows_to_state
from repro.kernels import bitonic_sort as j_bitonic
from repro.kernels import ops as j_ops
from repro_torch.core.types import FIELDS, AggState, state_from_numpy, state_to_numpy
from repro_torch.kernels import bitonic_sort, grouped_matmul, ops
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_kernels_reference.npz"
U32, U64 = np.dtype(np.uint32), np.dtype(np.uint64)


@pytest.fixture(autouse=True)
def _reference_x64_scope(monkeypatch):
    """The reference scopes its uint64 work with
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; lend it the old name for one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


# ---------------------------------------------------------------------------
# the cases: name -> what the reference computes on which seeded input
# ---------------------------------------------------------------------------

CASES: dict[str, dict] = {}
for _kd in (U32, U64):
    _k = _kd.name
    CASES[f"argsort-pallas-interior-{_k}"] = dict(kind="argsort", kd=_kd, n=100, domain=40,
                                                  empty=0.4, backend="pallas")
    for _n in (33, 2049):  # one past the warp class (32) and the CTAs of 2,048 pairs
        CASES[f"argsort-pallas-{_n}-{_k}"] = dict(kind="argsort", kd=_kd, n=_n,
                                                  domain=max(2, _n // 3), empty=0.3,
                                                  backend="pallas")
    CASES[f"argsort-xla-{_k}"] = dict(kind="argsort", kd=_kd, n=3000, domain=500, empty=0.1,
                                      backend="xla")
    for _n, _dom in ((33, 5), (2049, 256), (2049, 1)):
        CASES[f"combine-pallas-{_n}-{_dom}-{_k}"] = dict(kind="combine", kd=_kd, n=_n,
                                                         domain=_dom, width=2, widths=None,
                                                         backend="pallas")
    CASES[f"combine-xla-{_k}"] = dict(kind="combine", kd=_kd, n=3000, domain=400, width=2,
                                      widths=None, backend="xla", live=2500)
    # both inputs duplicate-free, so both combine paths of the plain version
    # (segmented and pair) answer the one kernel result
    CASES[f"merge-pallas-{_k}"] = dict(kind="merge", kd=_kd, na=150, nb=70, domain=200,
                                       width=2, unique_b=True, backend="pallas",
                                       assume_unique=False, port_unique=(False, True))
    for _n in (5, 100, 1000, 1537):  # ops.sort_keys / argsort_u32 off a power of two
        CASES[f"sort_keys-{_n}-{_k}"] = dict(kind="sort_keys", kd=_kd, n=_n, domain=500)
CASES["combine-pallas-200-u32"] = dict(kind="combine", kd=U32, n=200, domain=25, width=3,
                                       widths=None, backend="pallas")
CASES["combine-pallas-256-u64-widths"] = dict(kind="combine", kd=U64, n=256, domain=32,
                                              width=2, widths=(2, 0, 0), backend="pallas")
CASES["merge-xla-uint32"] = dict(kind="merge", kd=U32, na=2000, nb=700, domain=2500, width=1,
                                 unique_b=False, backend="xla", assume_unique=False,
                                 port_unique=(False,))
CASES["merge-xla-uint64"] = dict(kind="merge", kd=U64, na=2000, nb=700, domain=2500, width=1,
                                 unique_b=True, backend="xla", assume_unique=True,
                                 port_unique=(True,))
for _t in (1, 3):  # tests/test_kernels.py's tile batches
    for _n in (2, 8, 128, 1024, 4096):
        CASES[f"bitonic-{_t}x{_n}"] = dict(kind="bitonic", t=_t, n=_n, domain=2 ** 32 - 1)
for _dom in (2, 100, 2 ** 31):
    CASES[f"bitonic-dups-{_dom}"] = dict(kind="bitonic", t=2, n=512, domain=_dom)
CASES["bitonic-empty"] = dict(kind="bitonic", t=1, n=256, domain=1000, empty_span=(17, 93))
CASES["bitonic_kv-2048"] = dict(kind="bitonic_kv", t=1, n=2048, domain=2 ** 32 - 1)
STORED_CASES = tuple(CASES)


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _keys(rng, n, key_dtype, domain, empty_frac=0.0):
    k = rng.integers(0, domain, n).astype(key_dtype)
    if key_dtype == np.uint64:  # both halves of the u64 domain
        k = k * np.uint64(0x9E3779B97F4A7C15 // domain)
    k[rng.random(n) < empty_frac] = np.iinfo(key_dtype).max
    return k


def _ref_state(keys, payload, widths=None):
    """A reference (JAX) state as NumPy arrays."""
    with key_dtype_context(keys):
        st = j_rows_to_state(keys, payload, widths=widths)
        return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def _sorted_state(rng, n, key_dtype, domain, width, *, unique=False, widths=None):
    """Key-sorted rows; ``unique`` draws distinct keys (a duplicate-free
    ordered index), else keys repeat."""
    k = _keys(rng, n, key_dtype, domain)
    if unique:
        k = np.unique(k)
    k = np.sort(k)
    pay = rng.normal(size=(k.size, width)).astype(np.float32)
    return _ref_state(k, pay, widths)


def _jax_call(fn, *states, **kw):
    """``fn`` of the reference, jitted (one compile instead of one per op)."""
    keys = states[0]["keys"]
    with key_dtype_context(keys):
        js = [jso.AggState(*(jnp.asarray(s[f]) for f in FIELDS)) for s in states]
        return jax.jit(functools.partial(fn, **kw))(*js)


def _np(jstate, prefix=""):
    return {prefix + f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def _state_in(prefix, arrs):
    return {prefix + f: v for f, v in arrs.items()}


def compute(name: str) -> dict[str, np.ndarray]:
    """Case ``name`` through the reference: its inputs (``in_*``) and the
    reference's outputs (``out*``)."""
    c, rng = CASES[name], case_rng(name)
    if c["kind"] == "argsort":
        arrs = _ref_state(_keys(rng, c["n"], c["kd"], c["domain"], c["empty"]), None)
        perm = _jax_call(lambda s: jso.dispatch.get_backend(c["backend"]).argsort(s.keys), arrs)
        return {"in_keys": arrs["keys"], "out": np.asarray(perm)}
    if c["kind"] == "combine":
        arrs = _sorted_state(rng, c["n"], c["kd"], c["domain"], c["width"], widths=c["widths"])
        if "live" in c:  # an EMPTY tail
            arrs["keys"] = np.where(np.arange(c["n"]) < c["live"], arrs["keys"],
                                    np.iinfo(c["kd"]).max)
        want = _jax_call(jso.segmented_combine, arrs, backend=c["backend"])
        return {**_state_in("in_", arrs), **_np(want, "out_")}
    if c["kind"] == "merge":
        a = _sorted_state(rng, c["na"], c["kd"], c["domain"], c["width"], unique=True)
        b = _sorted_state(rng, c["nb"], c["kd"], c["domain"], c["width"], unique=c["unique_b"])
        want = _jax_call(jso.merge_absorb, a, b, backend=c["backend"],
                         assume_unique=c["assume_unique"])
        return {**_state_in("a_", a), **_state_in("b_", b), **_np(want, "out_")}
    if c["kind"] == "sort_keys":
        k = _keys(rng, c["n"], c["kd"], c["domain"])
        with key_dtype_context(k):
            return {"in_keys": k, "out": np.asarray(jax.jit(j_ops.sort_u32)(jnp.asarray(k))),
                    "out_perm": np.asarray(jax.jit(j_ops.argsort_u32)(jnp.asarray(k)))}
    k = rng.integers(0, c["domain"], size=(c["t"], c["n"])).astype(np.uint32)
    if "empty_span" in c:
        lo, hi = c["empty_span"]
        k[0, lo:hi] = np.iinfo(np.uint32).max
    if c["kind"] == "bitonic":
        return {"in_keys": k, "out": np.asarray(j_bitonic.bitonic_sort(jnp.asarray(k)))}
    v = np.arange(c["n"], dtype=np.uint32)[None]
    sk, sv = j_bitonic.bitonic_sort_kv(jnp.asarray(k), jnp.asarray(v))
    return {"in_keys": k, "in_vals": v, "out_keys": np.asarray(sk), "out_vals": np.asarray(sv)}


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict[str, np.ndarray]:
    arrays = _stored_arrays()
    prefix = f"{name}|"
    got = {k[len(prefix):]: arrays[k] for k in arrays.files if k.startswith(prefix)}
    if not got:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_kernels_reference.py")
    return got


def _port(arrs, prefix="in_") -> AggState:
    return state_from_numpy({f: arrs[prefix + f] for f in FIELDS}, device="cpu")


def _assert_states(got: AggState, want: dict, prefix="out_"):
    g = state_to_numpy(got)
    np.testing.assert_array_equal(g["keys"], want[prefix + "keys"])
    np.testing.assert_array_equal(g["count"], want[prefix + "count"])
    for f in ("sum", "min", "max"):
        np.testing.assert_allclose(g[f], want[prefix + f], rtol=1e-4, atol=1e-5, err_msg=f)


def _port_keys(keys) -> torch.Tensor:
    return state_from_numpy({"keys": keys, "count": np.zeros(keys.size, np.int32),
                             **{f: np.zeros((keys.size, 0), np.float32)
                                for f in ("sum", "min", "max")}}, device="cpu").keys


def check_case(name: str, want: dict) -> None:
    """The port's plain version on case ``name``'s inputs against the
    reference's outputs ``want``."""
    c = CASES[name]
    if c["kind"] == "argsort":
        got = ops.argsort_keys(_port_keys(want["in_keys"]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want["out"])
    elif c["kind"] == "combine":
        _assert_states(ops.segmented_combine(_port(want)), want)
    elif c["kind"] == "merge":
        a, b = _port(want, "a_"), _port(want, "b_")
        for assume_unique in c["port_unique"]:
            _assert_states(ops.merge_absorb_sorted(a, b, assume_unique=assume_unique), want)
    elif c["kind"] == "sort_keys":
        keys = _port_keys(want["in_keys"])
        got = ops.sort_u32(keys)
        assert ops.sort_u32 is ops.sort_keys and ops.argsort_u32 is ops.argsort_keys
        np.testing.assert_array_equal(state_to_numpy(AggState(
            keys=got, count=torch.zeros(got.shape[0], dtype=torch.int32),
            **{f: torch.zeros((got.shape[0], 0)) for f in ("sum", "min", "max")},
            key_dtype=c["kd"]))["keys"], want["out"])
        perm = ops.argsort_u32(keys).numpy()
        np.testing.assert_array_equal(want["in_keys"][perm], want["in_keys"][want["out_perm"]])
    elif c["kind"] == "bitonic":
        got = bitonic_sort.bitonic_sort(torch.from_numpy(want["in_keys"].astype(np.int64)))
        assert got.dtype == torch.int64 and got.shape == want["out"].shape
        np.testing.assert_array_equal(got.numpy(), want["out"].astype(np.int64))
    else:
        keys = torch.from_numpy(want["in_keys"].astype(np.int64))
        sk, sv = bitonic_sort.bitonic_sort_kv(keys, torch.from_numpy(
            want["in_vals"].astype(np.int64)))
        np.testing.assert_array_equal(sk.numpy(), want["out_keys"].astype(np.int64))
        for row in range(keys.shape[0]):  # the payload is a permutation giving the sorted keys
            assert sorted(sv[row].tolist()) == sorted(want["in_vals"][row].tolist())
            np.testing.assert_array_equal(want["in_keys"][row][sv[row].numpy()],
                                          want["out_keys"][row])


def _names(prefix):
    return [n for n in CASES if n.startswith(prefix)]



def _kd_name(key_dtype) -> str:
    return np.dtype(key_dtype).name


# ---------------------------------------------------------------------------
# argsort (bitonic_sort_multi through ops.argsort_keys)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_argsort_plain_matches_pallas_with_interior_empty(key_dtype):
    """Stable order, interior EMPTY rows included (the reference's index
    lane makes its bitonic network stable; the plain version must give the
    same permutation); the reference pads 100 keys to 128."""
    name = f"argsort-pallas-interior-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n", [33, 2049])
def test_argsort_plain_matches_pallas_at_class_edges(n, key_dtype):
    """One past the CUDA kernel's warp class (32) and past its CTAs of
    2,048 pairs: the reference pads to 64 and 4,096 rows."""
    name = f"argsort-pallas-{n}-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_argsort_plain_matches_xla(key_dtype):
    name = f"argsort-xla-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


# ---------------------------------------------------------------------------
# segmented combine (segmented_scan_tiles + _compact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype,n,width,widths", [
    (np.uint32, 200, 3, None), (np.uint64, 256, 2, (2, 0, 0)),
])
def test_segmented_combine_plain_matches_pallas(key_dtype, n, width, widths):
    name = f"combine-pallas-{n}-{'u32' if key_dtype == np.uint32 else 'u64-widths'}"
    assert (CASES[name]["width"], CASES[name]["widths"]) == (width, widths)
    check_case(name, stored(name))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,domain", [(33, 5), (2049, 256), (2049, 1)])
def test_segmented_combine_plain_matches_pallas_at_tile_edges(n, domain, key_dtype):
    """One row past the kernel's warp (32) and tile (2,048 rows) sizes, and
    one group spanning both tiles of 2,049 rows."""
    name = f"combine-pallas-{n}-{domain}-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_segmented_combine_plain_matches_xla(key_dtype):
    name = f"combine-xla-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


# ---------------------------------------------------------------------------
# merge-absorb (merge_path_tiles + _compact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_merge_absorb_plain_matches_pallas(key_dtype):
    """Unequal lengths, both inputs duplicate-free, so both combine paths of
    the plain version (segmented and pair) answer the one kernel result."""
    name = f"merge-pallas-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


@pytest.mark.parametrize("key_dtype,assume_unique", [(np.uint32, False), (np.uint64, True)])
def test_merge_absorb_plain_matches_xla(key_dtype, assume_unique):
    name = f"merge-xla-{_kd_name(key_dtype)}"
    assert CASES[name]["assume_unique"] == assume_unique
    check_case(name, stored(name))


# ---------------------------------------------------------------------------
# the key sorts: ops.sort_keys / argsort_u32, bitonic_sort(_kv)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n", [5, 100, 1000, 1537])
def test_sort_keys_matches_reference(n, key_dtype):
    """``sort_u32`` (``sort_keys``) gives the reference's sorted keys and
    ``argsort_u32`` a permutation that sorts them, off a power of two."""
    name = f"sort_keys-{n}-{_kd_name(key_dtype)}"
    check_case(name, stored(name))


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("n", [2, 8, 128, 1024, 4096])
def test_bitonic_sort_matches_reference(t, n):
    name = f"bitonic-{t}x{n}"
    check_case(name, stored(name))


@pytest.mark.parametrize("domain", [2, 100, 2**31])
def test_bitonic_sort_duplicates_match_reference(domain):
    name = f"bitonic-dups-{domain}"
    check_case(name, stored(name))


def test_bitonic_sort_with_empty_sentinels_matches_reference():
    want = stored("bitonic-empty")
    check_case("bitonic-empty", want)
    got = bitonic_sort.bitonic_sort(torch.from_numpy(want["in_keys"].astype(np.int64)))[0]
    assert bool((got[-76:] == 0xFFFFFFFF).all())  # sentinels sink to the tail


def test_bitonic_kv_payload_is_a_permutation_giving_the_reference_keys():
    check_case("bitonic_kv-2048", stored("bitonic_kv-2048"))


@settings(max_examples=10, deadline=None)
@given(logn=st.integers(1, 11), domain=st.sampled_from([1, 7, 1000, 2**31]),
       t=st.integers(1, 3), seed=st.integers(0, 2**31 - 1))
def test_bitonic_sort_property(logn, domain, t, seed):
    """The reference's own property (sorted rows equal ``np.sort``), with a
    payload moved alongside that must be a permutation giving them."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, domain, size=(t, 2**logn)).astype(np.int64)
    np.testing.assert_array_equal(bitonic_sort.bitonic_sort(torch.from_numpy(k)).numpy(),
                                  np.sort(k, -1))
    v = np.arange(k.size).reshape(k.shape)
    sk, sv = bitonic_sort.bitonic_sort_kv(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(k.reshape(-1)[sv.numpy()], sk.numpy())
    np.testing.assert_array_equal(np.sort(sv.numpy(), -1), v)


def test_bitonic_sort_takes_32_bit_keys_only():
    with pytest.raises(ValueError, match="32-bit"):
        bitonic_sort.bitonic_sort(torch.tensor([[1, 1 << 32]]))
    with pytest.raises(ValueError, match="32-bit"):
        bitonic_sort.bitonic_sort(torch.tensor([[-1, 2]]))
    with pytest.raises(ValueError, match=r"\(T, N\)"):
        bitonic_sort.bitonic_sort(torch.arange(4))
    with pytest.raises(ValueError, match="vals shape"):
        bitonic_sort.bitonic_sort_kv(torch.zeros((2, 4), dtype=torch.int64),
                                     torch.zeros((2, 3)))


@pytest.mark.parametrize("name", ["argsort-pallas-interior-uint32", "combine-pallas-33-5-uint64",
                                  "merge-pallas-uint32", "sort_keys-100-uint64", "bitonic-3x8",
                                  "bitonic_kv-2048"])
def test_stored_reference_is_the_reference_output(name):
    """One case of each kind recomputed live through the JAX package equals
    the stored file, inputs and outputs bit for bit."""
    want, got = stored(name), compute(name)
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


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
    lambda s: ops.sort_keys(s.keys),
    lambda s: ops.segmented_combine(s),
    lambda s: ops.merge_absorb_sorted(s, s),
    lambda s: ops.join_probe(s.keys, s.keys, s.empty),
    lambda s: ops.moe_grouped_matmul(s.sum.reshape(4, 4), s.sum.reshape(2, 4, 2), capacity=2),
    lambda s: ops.merge_absorb_sorted_bitonic(s, s),
], ids=["argsort", "sort_keys", "segmented_combine", "merge_absorb", "join_probe", "grouped_matmul",
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

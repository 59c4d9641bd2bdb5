"""The port's join path held against the JAX package's, on the CPU:
``merge_join`` (inner/semi/anti, u32/u64), the probe against the Pallas
probe kernel in interpret mode, the float32 group-join products of hot
keys, ``join_aggregate`` with a 64-bit-domain KeySpec, and the schema
composition (``AggResult.merge_join``, ``JoinResult.rollup``,
``AggResult.rollup``, the module-level ``rollup`` with a 64-bit KeySpec,
``pipeline``) over ``tests/test_join.py``'s two 600-row relations.

Keys, counts and ``join_count`` must be equal, float planes agree within
rtol 1e-4, ``SpillStats`` must be equal.

Cost on the CPU: the reference's compiles dominate, so its inputs share
shapes.  Its joins and rollups of the two relations start from its own
aggregates of the raw columns by its key-ordered hash baseline (the
in-sort pipeline compiles for several seconds more;
``tests/test_torch_schema.py`` holds the port's aggregate against it),
every reference state is cut to 64 rows, and the reference's eager
segmented combine, which compiles op by op (about 27 s for its first
call), runs under ``jax.jit`` for this module — the same function,
compiled once.  Only the 64-bit rollup hands the reference the port's
fine level (``_ref_result``); a NumPy oracle holds that level too.
"""
import dataclasses

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_join import SCENARIOS, _u64ify, make_state

import repro
import repro_torch
from repro.core import merge_join as jmj
from repro.core import ordered_index as joi
from repro.core import sorted_ops as jso
from repro.core.join import join_aggregate as j_join_aggregate
from repro.core.join import resolve_join_keys as j_resolve_join_keys
from repro.core.types import AggState as JAggState
from repro.core.types import ExecConfig as JExecConfig
from repro.core.types import SpillStats as JSpillStats
from repro.core.types import key_dtype_context
from repro.kernels import ops as kops
from repro_torch.core import join as join_mod
from repro_torch.core import merge_join as mj
from repro_torch.core.types import (
    FIELDS,
    empty_key,
    keys_to_numpy,
    keys_to_torch,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.kernels import merge_path, ops
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

_JIT_COMBINE = jax.jit(joi.segmented_combine_xla)
CFG = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)
REF_CAP = 64  # the reference's input capacity here; its compile times grow with it


def _jitted_combine(state, *, backend="auto"):
    assert backend == "xla", backend
    with key_dtype_context(state):
        return _JIT_COMBINE(state)


@pytest.fixture(scope="module", autouse=True)
def _reference_scope():
    """Lend the reference ``jax.experimental.enable_x64`` (newer JAX
    releases name it ``jax.enable_x64``; the loan of
    ``tests/test_torch_kernels.py``, held for the module), and run its
    segmented combine jitted."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                       raising=False)
        mp.setattr(jso, "segmented_combine", _jitted_combine)
        yield


def _np_state(jstate) -> dict:
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def _assert_state(got, want: dict, what: str):
    g = state_to_numpy(got)
    for f in ("keys", "count"):
        np.testing.assert_array_equal(g[f], want[f], err_msg=f"{what}: {f}")
    for f in ("sum", "min", "max"):
        np.testing.assert_allclose(g[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f"{what}: {f}")


def _assert_relation(got: dict, want: dict, what: str):
    assert list(got) == list(want), what
    for c, w in want.items():
        g = got[c]
        assert g.shape == w.shape, f"{what}: {c}"
        if np.issubdtype(w.dtype, np.integer) or c == "join_count":
            assert g.dtype == w.dtype, f"{what}: {c}"
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {c}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"{what}: {c}")


# ---------------------------------------------------------------------------
# (a) merge_join over test_join.py's scenarios, against backend="xla"
# ---------------------------------------------------------------------------


def _count_sum_state(keys, dtype=np.uint32, **kw):
    """test_join.py's state with only the count and sum planes, the layout
    of ``aggregate(aggs=("count", "sum"))`` that ``_ref_result`` hands the
    reference: one compile of each join serves both."""
    st = make_state(keys, dtype=dtype, capacity=REF_CAP, **kw)
    none = jnp.zeros((REF_CAP, 0), jnp.float32)
    return JAggState(st.keys, st.count, st.sum, none, none)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=["u32", "u64"])
@pytest.mark.parametrize("how", mj.JOIN_HOWS)
def test_merge_join_matches_reference(how, dtype):
    for name, (ka, kb) in SCENARIOS.items():
        ka = _u64ify(ka) if dtype is np.uint64 else np.asarray(ka, np.uint32)
        kb = _u64ify(kb) if dtype is np.uint64 else np.asarray(kb, np.uint32)
        with key_dtype_context(dtype):
            a, b = _count_sum_state(ka, dtype), _count_sum_state(kb, dtype)
            want_l, want_r = jmj.merge_join(a, b, how=how, backend="xla")
            want_l = _np_state(want_l)
            want_r = None if want_r is None else _np_state(want_r)
        pa = state_from_numpy(_np_state(a), device="cpu")
        pb = state_from_numpy(_np_state(b), device="cpu")
        got_l, got_r = mj.merge_join(pa, pb, how=how)
        _assert_state(got_l, want_l, f"{how}/{name} left")
        if want_r is None:
            assert got_r is None, name
        else:
            _assert_state(got_r, want_r, f"{how}/{name} right")


def test_merge_join_zero_capacity():
    """As test_join.py's zero-capacity case: an empty left side returns
    itself, an empty right side matches nothing."""
    empty = state_from_numpy(_np_state(make_state(np.array([], np.int64), capacity=0)),
                             device="cpu")
    some = state_from_numpy(_np_state(make_state(np.array([1, 2], np.int64), capacity=4)),
                            device="cpu")
    for how in mj.JOIN_HOWS:
        left, right = mj.merge_join(empty, some, how=how)
        assert left.capacity == 0 and (right is some if how == "inner" else right is None)
        left, right = mj.merge_join(some, empty, how=how)
        assert left.capacity == 4
        assert left.occupancy().item() == (2 if how == "anti" else 0)
        if how == "inner":
            assert right.capacity == 4 and right.occupancy().item() == 0


# ---------------------------------------------------------------------------
# (b) the probe against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=["u32", "u64"])
def test_probe_matches_pallas_and_numpy(dtype):
    rng = np.random.default_rng(29)
    base_a = np.sort(rng.choice(400, 30, replace=False))
    inner = rng.choice(np.arange(base_a[0] + 1, base_a[-1]), 20, replace=False)
    base_b = np.unique(np.concatenate([inner, base_a[[0, -1]]]))  # hits at b's ends
    ka = _u64ify(base_a) if dtype is np.uint64 else base_a.astype(np.uint32)
    kb = _u64ify(base_b) if dtype is np.uint64 else base_b.astype(np.uint32)
    with key_dtype_context(dtype):
        a = np.asarray(make_state(ka, capacity=32, dtype=dtype).keys)  # EMPTY tails
        b = np.asarray(make_state(kb, capacity=32, dtype=dtype).keys)
        pos_p, hit_p = (np.asarray(x) for x in kops.join_probe(jnp.asarray(a), jnp.asarray(b)))
    pos, hit = merge_path.join_probe_plain(keys_to_torch(a, "cpu"), keys_to_torch(b, "cpu"),
                                           empty_key(dtype))
    assert pos.dtype == torch.int32 and hit.dtype == torch.bool
    pos, hit = pos.numpy(), hit.numpy()
    np.testing.assert_array_equal(hit, hit_p)
    np.testing.assert_array_equal(pos[hit], pos_p[hit])
    np.testing.assert_array_equal(pos, np.minimum(np.searchsorted(b, a), b.size - 1))
    assert hit[0] and pos[0] == 0 and hit[29] and pos[29] == base_b.size - 1
    assert hit.sum() == np.isin(base_a, base_b).sum()


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=["u32", "u64"])
def test_probe_edge_cases(dtype):
    """Empty sides, left keys above every right key, hits at the right
    side's first and last rows; the wrapper on CPU tensors is the plain
    version and launches nothing."""
    ka = np.array([3, 7, 9, 40, 41], np.uint64)
    kb = np.array([3, 9, 40], np.uint64)
    if dtype is np.uint64:
        ka, kb = _u64ify(ka), _u64ify(kb)
    with key_dtype_context(dtype):
        a = np.asarray(make_state(ka.astype(dtype), capacity=8, dtype=dtype).keys)
        b = np.asarray(make_state(kb.astype(dtype), capacity=5, dtype=dtype).keys)
    ta, tb = keys_to_torch(a, "cpu"), keys_to_torch(b, "cpu")
    empty = empty_key(dtype)
    before = dict(ops.LAUNCHES)
    for x, y in ((ta, tb), (ta, tb[:3]), (ta, tb[:0]), (ta[:0], tb), (tb, ta)):
        pos, hit = ops.join_probe(x, y, empty)
        xa, ya = keys_to_numpy(x, dtype), keys_to_numpy(y, dtype)
        want_p = np.minimum(np.searchsorted(ya, xa), max(ya.size - 1, 0))
        want_h = (ya[want_p] == xa) & (xa != np.iinfo(dtype).max) if ya.size else want_p < 0
        np.testing.assert_array_equal(pos.numpy(), want_p)
        np.testing.assert_array_equal(hit.numpy(), want_h)
    assert ops.LAUNCHES == before
    pos, hit = ops.join_probe(ta, tb, empty)
    assert hit.tolist() == [True, False, True, True, False, False, False, False]
    assert pos.tolist()[:5] == [0, 1, 1, 2, 3]  # 41 is above every right key


# ---------------------------------------------------------------------------
# (c) hot-key group-join products stay float32
# ---------------------------------------------------------------------------


def test_hot_key_products_fp32_match_reference():
    ka = np.array([3, 8, 11], np.uint32)
    kb = np.array([8, 11, 20], np.uint32)
    a = _count_sum_state(ka, counts=[1_000_000, 1_000_000, 2])
    b = _count_sum_state(kb, counts=[1_000_000, 5, 9])
    want = jmj.group_join_products(*jmj.merge_join(a, b, how="inner", backend="xla"))
    pa, pb = (state_from_numpy(_np_state(s), device="cpu") for s in (a, b))
    got = mj.group_join_products(*mj.merge_join(pa, pb, how="inner"))
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["join_count"].numpy()[:2], [1e12, 10.0])


# ---------------------------------------------------------------------------
# (d) join_aggregate: one mixed sort, u64 KeySpec
# ---------------------------------------------------------------------------


def test_join_aggregate_u64_keyspec_matches_reference():
    spec, jspec = repro_torch.KeySpec.of(store=30, sku=20), repro.KeySpec.of(store=30, sku=20)
    r = np.random.default_rng(11)
    n = 300
    left = {"store": r.integers(0, 6, n) + 2**28, "sku": r.integers(0, 5, n)}
    right = {"store": r.integers(0, 6, n) + 2**28, "sku": r.integers(0, 5, n)}
    lpay = r.normal(size=n).astype(np.float32)
    rpay = r.normal(size=(n, 2)).astype(np.float32)
    want, wstats = j_join_aggregate(left, right, left_payload=lpay, right_payload=rpay,
                                    by=jspec, output_estimate=128, cfg=JExecConfig(**CFG))
    got, gstats = join_mod.join_aggregate(left, right, left_payload=lpay, right_payload=rpay,
                                          by=spec, output_estimate=128,
                                          cfg=repro_torch.ExecConfig(**CFG), device="cpu")
    assert got["key_dtype"] == np.uint64
    # the reference's host loop pads to another capacity: compare the groups
    gk, wk = keys_to_numpy(got["keys"], np.uint64), np.asarray(want["keys"])
    glive, wlive = gk != np.iinfo(np.uint64).max, wk != np.iinfo(np.uint64).max
    assert glive.sum() == 30 and not glive[glive.sum():].any()
    np.testing.assert_array_equal(gk[glive], wk[wlive])
    for c in ("n_left", "n_right", "join_count"):
        np.testing.assert_array_equal(got[c].numpy()[glive], np.asarray(want[c])[wlive],
                                      err_msg=c)
    for c in ("sum_left_pay", "sum_right_pay"):
        np.testing.assert_allclose(got[c].numpy()[glive], np.asarray(want[c])[wlive],
                                   rtol=1e-4, atol=1e-5, err_msg=c)
    assert gstats.as_dict() == wstats.as_dict()


def test_semi_and_anti_semi_join_partition_the_left_keys():
    lk = np.array([1, 2, 3, 5, 5, 8], np.uint32)
    rk = np.array([2, 5, 9, 9], np.uint32)
    semi, _ = join_mod.semi_join(lk, rk, device="cpu")
    anti, _ = join_mod.anti_semi_join(lk, rk, device="cpu")
    assert semi.dtype == np.uint32
    assert semi.tolist() == [2, 5] and anti.tolist() == [1, 3, 8]


def test_resolve_join_keys_matches_reference():
    cases = [(np.array([3, 7], np.uint32), np.array([7], np.uint32)),
             (np.array([2**40, 2**40 + 1], np.uint64), np.array([5], np.uint64)),
             (np.array([1, 2**32], np.int64), np.array([4], np.int64))]
    for lk, rk in cases:
        got, want = join_mod.resolve_join_keys(lk, rk), j_resolve_join_keys(lk, rk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype
    bad = [((np.array([1], np.uint32), np.array([1], np.uint64)), TypeError, "dtype mismatch"),
           ((np.array([1.0]), np.array([1.0])), TypeError, "integers"),
           ((np.array([-1]), np.array([1])), ValueError, "non-negative"),
           ((np.array([2**64 - 1], np.uint64), np.array([1], np.uint64)), ValueError, "EMPTY")]
    for args, exc, msg in bad:
        for fn in (join_mod.resolve_join_keys, j_resolve_join_keys):
            with pytest.raises(exc, match=msg):
                fn(*args)


# ---------------------------------------------------------------------------
# (e) schema composition on test_join.py's two 600-row relations
# ---------------------------------------------------------------------------

BITS = dict(region=6, store=8)
SPEC, JSPEC = repro_torch.KeySpec.of(**BITS), repro.KeySpec.of(**BITS)
N = 600


def _rel(seed, lo=0, hi=12):
    r = np.random.default_rng(seed)
    cols = {"region": r.integers(0, 4, N), "store": r.integers(lo, hi, N)}
    return cols, r.normal(size=N).astype(np.float32)


def _ref_result(res: repro_torch.AggResult, jspec) -> repro.AggResult:
    """The reference's AggResult over the port's aggregate state, cut to
    ``REF_CAP`` rows (the rows after them are EMPTY)."""
    arrs = {f: v[:REF_CAP] for f, v in state_to_numpy(res.state).items()}
    assert res.occupancy() <= REF_CAP
    with key_dtype_context(arrs["keys"]):
        state = JAggState(*(jnp.asarray(arrs[f]) for f in FIELDS))
    return repro.AggResult(state=state, stats=JSpillStats(**dataclasses.asdict(res.stats)),
                           by=jspec, aggs=repro.AggSpec(*res.aggs.names), plan={})


def _ref_aggregate(cols, vals, stats) -> repro.AggResult:
    """The reference's own aggregate of the raw columns, by its key-ordered
    hash baseline (its compile takes a fraction of the in-sort pipeline's),
    cut to ``REF_CAP`` rows (the rows after them must be EMPTY) so that its
    joins and rollups share one compile.  It carries the port's SpillStats
    (``stats``): the baseline counts its own, and the joins' stats are
    compared on equal inputs."""
    res = repro.aggregate(cols, by=JSPEC, values=vals, aggs=("count", "sum"),
                          algorithm="hash", order_by=True, backend="xla")
    keys = np.asarray(res.state.keys)
    assert (keys[REF_CAP:] == np.iinfo(keys.dtype).max).all()
    state = JAggState(*(getattr(res.state, f)[:REF_CAP] for f in FIELDS))
    return dataclasses.replace(res, state=state,
                               stats=JSpillStats(**dataclasses.asdict(stats)))


def _oracle_groups(cols, vals, spec):
    keys, inv, counts = np.unique(spec.pack(cols), return_inverse=True, return_counts=True)
    return keys, counts, np.bincount(inv, weights=vals.astype(np.float64))


@pytest.fixture(scope="module")
def relations():
    """(port L, port R, reference L, reference R, left inputs)."""
    out = []
    for cols, vals in (_rel(1), _rel(2, lo=6, hi=18)):
        res = repro_torch.aggregate(cols, by=SPEC, values=vals, aggs=("count", "sum"),
                                    output_estimate=256, device="cpu")
        rel, (keys, counts, sums) = res.relation(), _oracle_groups(cols, vals, SPEC)
        np.testing.assert_array_equal(SPEC.pack(rel), keys)
        np.testing.assert_array_equal(rel["count"], counts)
        np.testing.assert_allclose(rel["sum"][:, 0], sums, rtol=1e-4, atol=1e-5)
        out += [res, _ref_aggregate(cols, vals, res.stats)]
    L, JL, R, JR = out
    return L, R, JL, JR, _rel(1)


@pytest.mark.parametrize("how", mj.JOIN_HOWS)
def test_schema_merge_join_matches_reference(relations, how):
    L, R, JL, JR, _ = relations
    got, want = L.merge_join(R, how=how), JL.merge_join(JR, how=how, backend="xla")
    _assert_relation(got.relation(), want.relation(), how)
    assert got.occupancy() == want.occupancy()
    assert got.stats.as_dict() == want.stats.as_dict()
    assert got.sorted_by == want.sorted_by
    assert (got.right is None, got.products is None) == (want.right is None,
                                                         want.products is None)
    for k in ("operator", "how", "inputs_sorted", "sorted_by"):
        assert got.plan[k] == want.plan[k], k
    assert got.plan["backend"] == "torch"
    assert got.plan["left_plan"] is L.plan and got.plan["right_plan"] is R.plan


def test_reference_relations_equal_the_ports(relations):
    """The two sides' relations, the reference's and the port's, are the
    same groups before any join."""
    L, R, JL, JR, _ = relations
    for got, want in ((L, JL), (R, JR)):
        _assert_relation(got.relation(), want.relation(), "aggregate")
        assert got.sorted_by == want.sorted_by


def test_semi_anti_partition_the_left_groups(relations):
    L, R, _, _, _ = relations
    semi, anti = L.merge_join(R, how="semi"), L.merge_join(R, how="anti")
    assert semi.occupancy() + anti.occupancy() == L.occupancy()
    ks = set(SPEC.pack({c: semi.relation()[c] for c in BITS}).tolist())
    ka = set(SPEC.pack({c: anti.relation()[c] for c in BITS}).tolist())
    assert not ks & ka and ks | ka == set(SPEC.pack(L.relation()).tolist())


@pytest.mark.parametrize("how", ["inner", "anti"])
def test_join_rollup_matches_reference(relations, how):
    L, R, JL, JR, _ = relations
    got = L.merge_join(R, how=how).rollup()
    want = JL.merge_join(JR, how=how, backend="xla").rollup(backend="xla")
    assert list(got) == list(want) == [("region", "store"), ("region",), ()]
    for names, w in want.items():
        _assert_relation(got[names].relation(), w.relation(), str(names))
        assert got[names].plan["rollup"] == w.plan["rollup"]
        assert got[names].sorted_by == w.sorted_by
        assert got[names].stats.as_dict() == w.stats.as_dict()


def test_aggresult_rollup_matches_reference(relations):
    L, _, JL, _, _ = relations
    got, want = L.rollup(levels=[1, 0]), JL.rollup(levels=[1, 0], backend="xla")
    assert list(got) == list(want) == [("region",), ()]
    for names, w in want.items():
        _assert_relation(got[names].relation(), w.relation(), str(names))
        assert got[names].plan["rollup"] == w.plan["rollup"]


def test_module_rollup_64bit_keyspec_matches_reference():
    """A 64-bit KeySpec sets the top bit of valid keys, which the port holds
    as int64 with that bit flipped: the peel must shift logically and map
    back into the uint64 domain, and the grand total goes under the mapped
    zero."""
    bits = dict(a=40, b=16, c=8)
    spec, jspec = repro_torch.KeySpec.of(**bits), repro.KeySpec.of(**bits)
    r = np.random.default_rng(3)
    cols = {"a": (r.integers(0, 5, 400) + (1 << 39) + (1 << 38)).astype(np.uint64),
            "b": r.integers(0, 3, 400), "c": r.integers(252, 256, 400)}
    vals = r.normal(size=400).astype(np.float32)
    got, stats = repro_torch.rollup(cols, by=spec, values=vals, aggs=("count", "sum"),
                                    output_estimate=256, device="cpu")
    fine = got[("a", "b", "c")]
    assert fine.state.key_dtype == np.uint64
    assert (keys_to_numpy(fine.state.keys[:3], np.uint64) >> np.uint64(63) == 1).all()
    want = _ref_result(fine, jspec).rollup(backend="xla")
    assert list(got) == list(want) == [("a", "b", "c"), ("a", "b"), ("a",), ()]
    for names, w in want.items():
        _assert_relation(got[names].relation(), w.relation(), str(names))
    keys, counts, sums = _oracle_groups({"a": cols["a"]}, vals, repro_torch.KeySpec.of(a=40))
    rel = got[("a",)].relation()
    np.testing.assert_array_equal(rel["a"], keys)
    np.testing.assert_array_equal(rel["count"], counts)
    np.testing.assert_allclose(rel["sum"][:, 0], sums, rtol=1e-4, atol=1e-5)
    assert got[()].relation()["count"].tolist() == [400]
    assert stats.as_dict() == fine.stats.as_dict()


def test_pipeline_matches_reference(relations):
    L, R, JL, JR, (lc, lv) = relations
    got = repro_torch.pipeline([
        ("aggregate", dict(columns=lc, by=SPEC, values=lv, aggs=("count", "sum"),
                           output_estimate=256, device="cpu")),
        ("merge_join", {"right": R}),
        ("rollup", {"levels": [1, 0]}),
    ])
    want = repro.pipeline([JL, ("merge_join", {"right": JR, "backend": "xla"}),
                           ("rollup", {"levels": [1, 0], "backend": "xla"})])
    assert list(got) == list(want)
    for names, w in want.items():
        assert got[names].plan["pipeline"] == w.plan["pipeline"] == {
            "stages": ["aggregate", "merge_join[inner]", "rollup"], "source_sorts": 2,
            "re_sorts": 0}
        _assert_relation(got[names].relation(), w.relation(), str(names))
        assert got[names].stats.as_dict() == w.stats.as_dict()


def test_join_guards(relations):
    L, R, _, _, _ = relations
    with pytest.raises(ValueError, match="unknown join how"):
        L.merge_join(R, how="outer")
    from repro_torch.distributed import sharding

    mesh = sharding.data_mesh("data", device="cpu")  # one rank: no process group
    with pytest.raises(ValueError, match="no axis"):
        L.merge_join(R, mesh=mesh, mesh_axis="model")
    with pytest.raises(ValueError, match="without mesh"):
        L.merge_join(R, mesh_axis="data")
    one = L.merge_join(R, mesh=mesh)  # a mesh of one rank joins as one device does
    assert one.plan["mesh"]["world"] == 1 and one.stats.rows_exchanged > 0
    _assert_relation(one.relation(), L.merge_join(R).relation(), "mesh of one")
    wide = dataclasses.replace(R, by=repro_torch.KeySpec.of(region=6, store=30))
    with pytest.raises(TypeError, match="dtype mismatch"):
        L.merge_join(wide)
    swapped = dataclasses.replace(R, by=repro_torch.KeySpec.of(region=8, store=6))
    with pytest.raises(TypeError, match="layout mismatch"):
        L.merge_join(swapped)
    with pytest.raises(TypeError, match="fan-out"):
        repro_torch.pipeline([L, ("rollup", {}), ("rollup", {})])
    with pytest.raises(ValueError, match="out of range"):
        L.rollup(levels=[3])


def test_keyspec_shift_and_prefix_match_reference():
    mine, ref = repro_torch.KeySpec.of(a=40, b=16, c=8), repro.KeySpec.of(a=40, b=16, c=8)
    for name in ("a", "b", "c"):
        assert mine.shift_of(name) == ref.shift_of(name)
    for n in (1, 2, 3):
        assert mine.prefix(n).names == ref.prefix(n).names
        assert mine.prefix(n).key_dtype == ref.prefix(n).key_dtype
    with pytest.raises(KeyError):
        mine.shift_of("d")
    with pytest.raises(ValueError):
        mine.prefix(0)


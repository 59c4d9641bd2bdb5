"""The paper's baselines in the port held against the JAX package's.

Same seeded NumPy inputs through the reference (``"xla"`` backend) and
the port on the CPU: keys and counts equal, ``SpillStats.as_dict()``
equal, the float planes within rtol 1e-4 (tests/test_kernels.py's
tolerance).  States are compared whole, EMPTY padding and row order
included, so a hash result must equal the reference's row for row, in
hash order.  Covered (``CASES``): the device pipeline's ``traditional``,
``inrun_dedup`` and ``early_agg`` policies and its run generation alone;
the host loop (``pipeline="host"``) with each flag combination of the
paper's Fig 2; ``sort_then_stream``, ``hash``, ``f1_hash`` and
``inmemory`` over tests/test_core.py's output sizes O, and the front
door's hash result sorted by ``order_by``; in-stream aggregation with its
tiny and degenerate inputs; every operator of ``operators.py``; u32 and
u64 keys.  Small geometries (M = 2^8 and 2^10) make each path spill and
run its merge levels.

The reference's results for ``CASES`` cost minutes of XLA compiles (one
program per shape), so they are computed by
``scripts/make_torch_baselines_reference.py`` from this module's own case
table and read here from ``tests/data/torch_baselines_reference.npz``;
the JAX package does not change, so neither does that file.
``test_stored_reference_is_the_reference_output`` recomputes two cases
live and requires the stored results, and the script's ``--check``
recomputes every case and requires them bit for bit.  The cost model, the plans'
``cost_model`` entries, the hash's sentinel and the key packing are
pure Python or NumPy in both packages and are compared live.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import _cost_constants as j_constants
from repro.core import cost_model as j_cost
from repro.core import hash_agg as j_hash
from repro.core import insort as j_insort
from repro.core import instream as j_instream
from repro.core import operators as j_ops
from repro.core import pipeline as j_pipe
from repro.core import schema as j_schema
from repro.core.types import ExecConfig as JExecConfig
from repro_torch.core import _cost_constants as constants
from repro_torch.core import cost_model, hash_agg, insort, instream, operators, pipeline
from repro_torch.core import schema as schema_mod
from repro_torch.core.types import ExecConfig, keys_to_numpy, keys_to_torch, state_to_numpy

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_baselines_reference.npz"
FIELDS = ("keys", "count", "sum", "min", "max")
# M = 2^8: spills, pre-merge and traditional merge levels at N = 4000;
# M = 2^10 for the algorithms over O and the operators (the hash
# partitions one level deep)
SMALL = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)
GRID = dict(memory_rows=1024, page_rows=64, fanin=4, batch_rows=128)
O_GRID = (1, 37, 700, 5000)
FIG2 = {  # (early_aggregation, use_wide_merge, run_policy)
    "insort_rs": (True, True, "rs"),
    "insort_early_agg": (True, True, "early_agg"),
    "inrun_dedup_wide": (False, True, "rs"),
    "early_agg_traditional_merge": (True, False, "rs"),
    "inrun_dedup_traditional_merge": (False, False, "rs"),
}
U32, U64 = np.dtype(np.uint32), np.dtype(np.uint64)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU paths run thousands of small ops; with PyTorch's
    intra-op pool on a loaded host each op can wait milliseconds for its
    threads, so the port's CPU tests run on one thread (restored
    afterwards).  The other test_torch_* modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the cases: name -> parameters
# ---------------------------------------------------------------------------

CASES: dict[str, dict] = {}
for _policy in ("traditional", "inrun_dedup", "early_agg"):
    for _kd in (U32, U64):
        CASES[f"device-{_policy}-{_kd.name}"] = dict(kind="device", policy=_policy, kd=_kd)
CASES["generate_runs_device-early_agg"] = dict(kind="generate_runs_device")
for _plan in FIG2:
    CASES[f"host-{_plan}-uint32"] = dict(kind="host", plan=_plan, kd=U32)
for _plan in ("insort_rs", "early_agg_traditional_merge", "inrun_dedup_traditional_merge"):
    CASES[f"host-{_plan}-uint64"] = dict(kind="host", plan=_plan, kd=U64)
for _alg in ("sort_then_stream", "hash", "f1_hash", "inmemory"):
    for _o in O_GRID:
        CASES[f"algorithm-{_alg}-{_o}-uint32"] = dict(kind="algorithm", alg=_alg, o=_o, kd=U32)
for _alg in ("hash", "f1_hash"):
    for _o in (700, 5000):
        CASES[f"algorithm-{_alg}-{_o}-uint64"] = dict(kind="algorithm", alg=_alg, o=_o, kd=U64)
CASES["aggregate-hash-order_by"] = dict(kind="aggregate_order_by")
INSTREAM = {  # name: (rows, key domain, chunk, out_capacity, key dtype, payload width)
    "many_groups": (3000, 700, 256, None, U32, 2),
    "u64": (2000, 300, 128, None, U64, 1),
    "one_group_over_chunks": (1000, 1, 100, None, U32, 1),
    "chunk_multiple": (512, 64, 128, None, U32, 1),
    "one_row": (1, 5, 16, None, U32, 1),
    "no_rows": (0, 5, 16, None, U32, 1),
    "out_capacity_cut": (600, 200, 64, 50, U32, 0),
}
for _name in INSTREAM:
    CASES[f"instream-{_name}"] = dict(kind="instream", name=_name)
for _op in ("group_by_order_by-hash", "group_by_order_by-insort", "distinct",
            "count_and_count_distinct-insort", "count_and_count_distinct-hash", "rollup",
            "intersect_distinct-insort", "intersect_distinct-hash"):
    CASES[f"operator-{_op}"] = dict(kind="operator", op=_op)
# the cases the stored-results test recomputes live (the cheapest to
# compile; the script's --check recomputes them all)
LIVE_CASES = ("algorithm-inmemory-37-uint32", "instream-one_group_over_chunks")


def _keys(rng, n, domain, key_dtype):
    keys = rng.integers(0, domain, n).astype(np.uint64)
    if np.dtype(key_dtype) == U64:  # spread over both halves of the u64 domain
        return keys * np.uint64(0xF000000000000000 // max(domain, 1)) + np.uint64(3)
    return keys.astype(np.uint32)


def case_inputs(name):
    """The seeded input rows of a case: (keys, payload or None)."""
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if c["kind"] in ("device", "host"):
        n, domain, kd, width = 4000, 1200, c["kd"], 1
    elif c["kind"] == "generate_runs_device":
        n, domain, kd, width = 3000, 900, U32, 1
    elif c["kind"] == "algorithm":
        n, domain, kd, width = 6000, c["o"], c["kd"], 2
    elif c["kind"] == "instream":
        n, domain, _, _, kd, width = INSTREAM[c["name"]]
        keys = np.sort(_keys(rng, n, domain, kd))
        return keys, rng.normal(size=(n, width)).astype(np.float32) if width else None
    else:  # operators and the front door: two columns of a composite key
        n = 4000
        return rng.integers(0, 60, n), rng.integers(0, 40, n), rng.normal(
            size=(n, 1)).astype(np.float32)
    return _keys(rng, n, domain, kd), rng.normal(size=(n, width)).astype(np.float32)


# ---------------------------------------------------------------------------
# one case through either package: {entry: state dict | array | int | dict}
# ---------------------------------------------------------------------------


def _np_state(state) -> dict:
    if isinstance(state, dict):
        return state
    if hasattr(state, "key_dtype") and isinstance(getattr(state, "keys"), torch.Tensor):
        return state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _operator(op, cols, pay, *, ref: bool):
    """One operator case; ``ref`` picks the package."""
    g, a, _ = cols
    ops, cfg = (j_ops, JExecConfig(**GRID)) if ref else (operators, ExecConfig(**GRID))
    kw = dict(backend="xla") if ref else dict(device="cpu")
    packed = (g.astype(np.uint32) << np.uint32(6)) | a.astype(np.uint32)
    name, _, alg = op.partition("-")
    if name == "group_by_order_by":
        st, stats, extra = ops.group_by_order_by(packed, pay, cfg, algorithm=alg,
                                                 output_estimate=2400, **kw)
        return dict(state=st, stats=stats.as_dict(), extra_sort_rows=int(extra))
    if name == "distinct":
        st, stats = ops.distinct(packed, cfg, **kw)
        return dict(state=st, stats=stats.as_dict())
    if name == "count_and_count_distinct":
        st, stats = ops.count_and_count_distinct(g, a, 6, cfg, algorithm=alg, **kw)
        return dict(state=st, stats=stats.as_dict())
    if name == "rollup":
        day, month, year = a % 28 + 1, g % 12 + 1, g // 12 + 2000
        levels, stats = ops.rollup(day, month, year, pay, cfg, **kw)
        return dict(stats=stats.as_dict(), **{f"level_{k}": v for k, v in levels.items()})
    # intersect_distinct: g * 64 + a against a shifted copy of itself
    keys, stats = ops.intersect_distinct(packed, packed[: len(packed) // 2] + np.uint32(7),
                                         cfg, algorithm=alg, **kw)
    keys = keys_to_numpy(keys, np.uint32) if isinstance(keys, torch.Tensor) else keys
    return dict(keys=np.asarray(keys), stats=stats.as_dict())


def compute(name, *, ref: bool) -> dict:
    """Run case ``name`` through the reference (``ref``) or the port on the
    CPU."""
    c = CASES[name]
    kind = c["kind"]
    inputs = case_inputs(name)
    cfg_kw = SMALL if kind in ("device", "generate_runs_device", "host", "instream") else GRID
    cfg = JExecConfig(**cfg_kw) if ref else ExecConfig(**cfg_kw)
    kw = dict(backend="xla") if ref else dict(device="cpu")
    if kind == "device":
        keys, pay = inputs
        mod = j_pipe if ref else pipeline
        st, stats = mod.insort_aggregate_device(keys, pay, cfg, policy=c["policy"],
                                                output_estimate=1 << 12, **kw)
        return dict(state=st, stats=stats.as_dict())
    if kind == "generate_runs_device":
        keys, pay = inputs
        mod = j_pipe if ref else pipeline
        store, lens, table, dstats = mod.generate_runs_device(keys, pay, cfg,
                                                              policy="early_agg", **kw)
        return dict(store=store, lens=np.asarray(lens.cpu() if not ref else lens),
                    table=table, stats=dstats.finalize().as_dict())
    if kind == "host":
        keys, pay = inputs
        ea, wide, run_policy = FIG2[c["plan"]]
        mod = j_insort if ref else insort
        st, stats = mod.insort_aggregate(keys, pay, cfg, output_estimate=1 << 12,
                                         early_aggregation=ea, use_wide_merge=wide,
                                         run_policy=run_policy, pipeline="host", **kw)
        return dict(state=st, stats=stats.as_dict())
    if kind == "algorithm":
        keys, pay = inputs
        mod = j_ops if ref else operators
        st, stats = mod.group_by(keys, pay, cfg, algorithm=c["alg"], output_estimate=c["o"],
                                 **kw)
        return dict(state=st, stats=stats.as_dict())
    if kind == "instream":
        keys, pay = inputs
        _, _, chunk, cap, _, _ = INSTREAM[c["name"]]
        if ref:
            st, groups = j_instream.instream_aggregate(
                keys, None if pay is None else jax.numpy.asarray(pay), chunk=chunk,
                out_capacity=cap)
        else:
            st, groups = instream.instream_aggregate(keys, pay, chunk=chunk, out_capacity=cap,
                                                     device="cpu")
        return dict(state=st, groups=int(groups))
    if kind == "aggregate_order_by":
        g, a, pay = inputs
        pkg = repro if ref else repro_torch
        res = pkg.aggregate({"g": g, "a": a}, by=pkg.KeySpec.of(g=6, a=6), values=pay,
                            aggs=("count", "sum", "max"), order_by=True, algorithm="hash",
                            cfg=cfg, **kw)
        return dict(state=res.state, stats=res.stats.as_dict(), relation=res.relation())
    return _operator(c["op"], inputs, inputs[2], ref=ref)


def to_arrays(name: str, result: dict) -> dict[str, np.ndarray]:
    """A case's result flattened to named NumPy arrays (the stats and other
    host values as JSON)."""
    out, host = {}, {}
    for entry, v in result.items():
        if entry == "stats" or isinstance(v, int):
            host[entry] = v
        elif isinstance(v, np.ndarray):
            out[f"{name}|{entry}"] = v
        else:  # a state, or a relation's columns
            for f, arr in _np_state(v).items():
                out[f"{name}|{entry}|{f}"] = np.asarray(arr)
    out[f"{name}|host"] = np.asarray(json.dumps(host, sort_keys=True))
    return out


def from_arrays(name: str, arrays) -> dict:
    result: dict = json.loads(str(arrays[f"{name}|host"]))
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        parts = key.split("|")
        if parts[0] != name or parts[1] == "host":
            continue
        if len(parts) == 2:
            result[parts[1]] = arrays[key]
        else:
            result.setdefault(parts[1], {})[parts[2]] = arrays[key]
    return result


def assert_same(got: dict, want: dict):
    """Exact on keys, counts, stats and host values; rtol 1e-4 on floats."""
    assert sorted(got) == sorted(want)
    for entry, w in want.items():
        g = got[entry]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), entry
            for f, wa in w.items():
                if not isinstance(wa, np.ndarray):
                    assert g[f] == wa, (entry, f)
                elif wa.dtype.kind == "f":
                    np.testing.assert_allclose(g[f], wa, rtol=1e-4, atol=1e-5,
                                               err_msg=f"{entry}.{f}")
                else:
                    assert g[f].dtype == wa.dtype, (entry, f)
                    np.testing.assert_array_equal(g[f], wa, err_msg=f"{entry}.{f}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=entry)
        else:
            assert g == w, entry


@pytest.fixture(scope="module")
def reference():
    """The reference's results of ``CASES`` (``scripts/make_torch_baselines_
    reference.py``), as ``get(name)``."""
    arrays = np.load(REFERENCE_FILE)
    cache = {}

    def get(name):
        if name not in cache:
            if f"{name}|host" not in arrays.files:
                pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                            "scripts/make_torch_baselines_reference.py")
            cache[name] = from_arrays(name, arrays)
        return cache[name]

    return get


def port_result(name) -> dict:
    """The port's result of a case, in the stored layout."""
    return from_arrays(name, to_arrays(name, compute(name, ref=False)))


def _names(kind):
    return [n for n, c in CASES.items() if c["kind"] == kind]


# ---------------------------------------------------------------------------
# the paths against the reference's stored results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _names("device"))
def test_device_policy_matches_reference(reference, name):
    got, want = port_result(name), reference(name)
    assert_same(got, want)
    stats = got["stats"]
    assert stats["runs_generated"] > 1 and stats["rows_spilled_merge"] > 0  # pre-merge ran


def test_generate_runs_device_matches_reference(reference):
    """Run generation alone: the run store, run lengths, resident table and
    run-generation stats of ``early_agg``."""
    name = "generate_runs_device-early_agg"
    assert_same(port_result(name), reference(name))


@pytest.mark.parametrize("name", _names("host"))
def test_host_pipeline_matches_reference(reference, name):
    got = port_result(name)
    assert_same(got, reference(name))
    assert got["stats"]["runs_generated"] > 1 and got["stats"]["merge_levels"] > 1


@pytest.mark.parametrize("name", _names("algorithm"))
def test_algorithm_matches_reference(reference, name):
    got = port_result(name)
    assert_same(got, reference(name))
    alg, kd = CASES[name]["alg"], CASES[name]["kd"]
    keys = got["state"]["keys"]
    live = keys[keys != np.iinfo(kd).max]
    if alg in ("hash", "f1_hash"):  # hash order: ascending hashes of the user's keys
        order = hash_agg._np_hash(live)
        assert np.all(order[1:] > order[:-1])
    else:
        assert np.all(live[1:] > live[:-1])


def test_aggregate_hash_order_by_matches_reference(reference):
    """The front door's hash result with ``order_by``: the extra sort into
    key order (Fig 19), the relation and the stats."""
    name = "aggregate-hash-order_by"
    got = port_result(name)
    assert_same(got, reference(name))
    g = got["relation"]["g"].astype(np.int64) * 64 + got["relation"]["a"]
    assert np.all(g[1:] > g[:-1])


@pytest.mark.parametrize("name", _names("instream"))
def test_instream_matches_reference(reference, name):
    assert_same(port_result(name), reference(name))


@pytest.mark.parametrize("name", _names("operator"))
def test_operator_matches_reference(reference, name):
    assert_same(port_result(name), reference(name))


@pytest.mark.parametrize("name", LIVE_CASES)
def test_stored_reference_is_the_reference_output(reference, name):
    """The stored results are the reference's: recomputed live here, they
    equal the stored ones (keys, counts and stats exactly, the floats
    within the module's tolerance, as another CPU may round a sum
    differently)."""
    assert_same(from_arrays(name, to_arrays(name, compute(name, ref=True))), reference(name))


# ---------------------------------------------------------------------------
# live: the hash's sentinel, key packing, oracle check, cost model, plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [U32, U64], ids=["u32", "u64"])
def test_checked_hash_sentinel_matches_reference(key_dtype):
    """The one key that hashes to EMPTY raises in both packages with the
    same message; every other key hashes as the reference's does."""
    bad = j_hash._np_unhash(np.asarray([np.iinfo(key_dtype).max], dtype=key_dtype))
    keys = np.concatenate([np.arange(5, dtype=key_dtype), bad])
    with pytest.raises(ValueError) as want:
        j_hash._checked_hash(keys)
    with pytest.raises(ValueError) as got:
        hash_agg._checked_hash(keys)
    assert str(got.value) == str(want.value) and f"key {int(bad[0])}" in str(got.value)
    for fn in (hash_agg.hash_aggregate, hash_agg.f1_hash_aggregate):
        with pytest.raises(ValueError, match="reserved EMPTY"):
            fn(keys, None, ExecConfig(**SMALL), device="cpu")
    rng = np.random.default_rng(7)
    ok = rng.integers(0, np.iinfo(key_dtype).max, 1000, dtype=key_dtype)
    hashed = j_hash._checked_hash(ok)
    np.testing.assert_array_equal(hash_agg._checked_hash(ok), hashed)
    # the device's unhash (int64 keys, u64 with the top bit flipped)
    unhashed = hash_agg.unhash_keys(keys_to_torch(hashed, "cpu"), key_dtype)
    np.testing.assert_array_equal(keys_to_numpy(unhashed, key_dtype), ok)
    np.testing.assert_array_equal(j_hash._np_unhash(hashed), ok)
    if key_dtype == U32:
        mine = hash_agg.hash_u32(keys_to_torch(ok, "cpu"))
        np.testing.assert_array_equal(keys_to_numpy(mine, U32),
                                      np.asarray(j_hash.hash_u32(jax.numpy.asarray(ok))))
        np.testing.assert_array_equal(keys_to_numpy(hash_agg.unhash_u32(mine), U32), ok)


def test_pack_keys_and_oracle_check():
    rng = np.random.default_rng(8)
    hi, lo = rng.integers(0, 1000, 500), rng.integers(0, 64, 500)
    packed = operators.pack_keys(hi, lo, 6)
    np.testing.assert_array_equal(packed, np.asarray(j_ops.pack_keys(hi, lo, 6)))
    for mine, ref in zip(operators.unpack_keys(packed, 6), j_ops.unpack_keys(packed, 6)):
        np.testing.assert_array_equal(mine, np.asarray(ref))
    pay = rng.normal(size=(500, 1)).astype(np.float32)
    st, _ = operators.group_by(packed, pay, ExecConfig(**SMALL), algorithm="inmemory",
                               device="cpu")
    assert operators.validate_against_oracle(st, packed, pay)
    with pytest.raises(AssertionError, match="counts differ"):
        operators.validate_against_oracle(st, np.concatenate([packed, packed[:1]]))


def test_cost_constants_match_reference():
    """The port's ``cpu`` entry is the reference's committed table; the
    card has its own entry (``scripts/calibrate_torch.py`` on an H100),
    which the reference does not have."""
    assert constants.COST_CONSTANTS["cpu"] == j_constants.COST_CONSTANTS["cpu"]
    assert sorted(constants.COST_CONSTANTS) == ["cpu", "cuda"]
    assert constants.COST_SCHEMA_VERSION == j_constants.COST_SCHEMA_VERSION
    for dev in ("cpu", None):
        assert cost_model.load_cost_constants(dev) == j_cost.load_cost_constants(dev)
    assert cost_model.load_cost_constants("cuda") == constants.COST_CONSTANTS["cuda"]
    bad = {"cpu": dict(constants.COST_CONSTANTS["cpu"], schema_version=0)}
    with pytest.raises(cost_model.StaleConstantsError, match="schema_version"):
        cost_model.validate_constants(bad)


@pytest.mark.parametrize("input_sorted", [False, True])
@pytest.mark.parametrize("levels", [0, 1, 3])
def test_cost_model_matches_reference(levels, input_sorted):
    kw = dict(merge_levels=levels, input_sorted=input_sorted)
    for n, o in ((1e6, 1e3), (5e6, 4.9e6), (1e5, 0), (0, 10)):
        assert cost_model.cost_surface(n, o, **kw) == j_cost.cost_surface(n, o, **kw)
    for d in (0.0, 0.3, 0.97, 1.0, 1.5):
        assert cost_model.choose_policy(d, **kw) == j_cost.choose_policy(d, **kw)
        for p in j_cost.ABSORB_POLICIES:
            assert (cost_model.policy_cost_per_row(p, d, **kw)
                    == j_cost.policy_cost_per_row(p, d, **kw))
            assert (cost_model.estimate_seconds(p, 1e7, d, **kw)
                    == j_cost.estimate_seconds(p, 1e7, d, **kw))
    for a, b in (("traditional", "early_agg"), ("rs", "inrun_dedup"), ("rs", "rs")):
        assert (cost_model.crossover_dup_rate(a, b, **kw)
                == j_cost.crossover_dup_rate(a, b, **kw))
    for nl, nr, srt in ((1e6, 3e5, True), (7, 0, False), (1e8, 1e8, False)):
        assert (cost_model.join_cost_surface(nl, nr, inputs_sorted=srt)
                == j_cost.join_cost_surface(nl, nr, inputs_sorted=srt))
    assert (cost_model.merge_levels_traditional(1e6 * (levels + 1), 1e3, 10)
            == j_cost.merge_levels_traditional(1e6 * (levels + 1), 1e3, 10))
    assert cost_model.fig24_curves(points=5 + levels) == j_cost.fig24_curves(points=5 + levels)


@pytest.mark.parametrize("input_sorted", [False, True])
def test_plan_cost_model_matches_reference(input_sorted):
    """The front door's plan: the reference's ``_plan`` entries, the
    ``cost_model`` surface among them (both look up the CPU's constants),
    and the backend, algorithm and pipeline keys."""
    cfg = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)
    rng = np.random.default_rng(9)
    cols = {"g": rng.integers(0, 60, 3000), "a": rng.integers(0, 40, 3000)}
    for alg, est in (("hash", None), ("inmemory", 2000), ("auto", 900)):
        res = repro_torch.aggregate(cols, by=repro_torch.KeySpec.of(g=6, a=6), algorithm=alg,
                                    cfg=ExecConfig(**cfg), output_estimate=est,
                                    input_sorted=input_sorted, device="cpu")
        want = j_schema._plan(3000, JExecConfig(**cfg), est, input_sorted=input_sorted)
        for k, v in want.items():
            assert res.plan[k] == v, k
        assert res.plan["cost_model"]["calibrated_backend"] == "cpu"
        assert res.plan["algorithm"] == ("insort" if alg == "auto" else alg)
        assert res.plan["pipeline"] == ("device" if alg == "auto" else "host")


def test_merge_join_plan_cost_model_matches_reference():
    """The merge join's ``cost_model`` and ``cost_model_resort_baseline``
    entries: the reference's ``join_cost_surface`` of the two states'
    capacities (the join tests hold the capacities equal)."""
    rng = np.random.default_rng(10)
    by = repro_torch.KeySpec.of(k=12)
    left = repro_torch.aggregate({"k": rng.integers(0, 900, 2000)}, by=by,
                                 cfg=ExecConfig(**SMALL), device="cpu")
    right = repro_torch.aggregate({"k": rng.integers(0, 900, 700)}, by=by,
                                  cfg=ExecConfig(**SMALL), device="cpu")
    plan = left.merge_join(right).plan
    caps = (left.state.capacity, right.state.capacity)
    assert plan["cost_model"] == j_cost.join_cost_surface(*caps, inputs_sorted=True)
    assert plan["cost_model_resort_baseline"] == j_cost.join_cost_surface(
        *caps, inputs_sorted=False)


def test_schema_plan_keys_of_every_algorithm():
    """Every one-shot algorithm through the front door; the hash baselines
    run on the host loop, and ``unknown`` raises."""
    rng = np.random.default_rng(11)
    cols = {"k": rng.integers(0, 300, 1500)}
    by = repro_torch.KeySpec.of(k=10)
    for alg in ("hash", "f1_hash", "sort_then_stream", "inmemory", "insort"):
        res = repro_torch.aggregate(cols, by=by, algorithm=alg, order_by=True,
                                    cfg=ExecConfig(**SMALL), device="cpu")
        uk, cnt = np.unique(cols["k"], return_counts=True)
        rel = res.relation()
        np.testing.assert_array_equal(rel["k"], uk)
        np.testing.assert_array_equal(rel["count"], cnt)
    with pytest.raises(ValueError, match="unknown algorithm"):
        repro_torch.aggregate(cols, by=by, algorithm="unknown", device="cpu")
    assert schema_mod.AggResult is repro_torch.AggResult

"""The port's streamed pipeline held against the JAX package's.

Mirrors the single-device cases of tests/test_stream.py, on seeded NumPy
inputs through the reference (``"xla"`` backend) and the port on the CPU:
for every policy and both key dtypes a stream of unit-aligned chunks
gives the one-shot pipeline's rows and ``SpillStats`` exactly, and the
reference's stream state whole (EMPTY padding included); unaligned
chunks, the edges (an empty stream, one row, empty and all-EMPTY chunks,
one hot key, a plane-width restriction), ``rebatch_chunks``, the column
adapters of ``repro_torch.data.pipeline``, the front door with column
batches and its input validation, ``group_by`` over a chunk iterator,
``OrderedIndex``, merge-on-read snapshots (the engine's tensors equal
before and after) and ``evict_below``.  Keys and counts exactly, the
float planes within rtol 1e-4.

The reference's results cost XLA compiles (one program a shape), so
``scripts/make_torch_stream_reference.py`` computes them from the case
tables (``CASES``) of this module, tests/test_torch_adaptive.py,
tests/test_torch_pipeline.py and tests/test_torch_schema.py, and stores
them in ``tests/data/torch_stream_reference.npz``; its ``--check``
recomputes them all.  ``LIVE_CASE`` is recomputed live here.
"""
import contextlib
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import operators as j_ops
from repro.core import pipeline as j_pipe
from repro.core import types as j_types
from repro.core.ordered_index import OrderedIndex as JOrderedIndex
from repro.core.types import ExecConfig as JExecConfig
from repro.data import pipeline as j_data
from repro_torch.core import operators, pipeline
from repro_torch.core import schema as schema_mod
from repro_torch.core import sorted_ops
from repro_torch.core import types as t_types
from repro_torch.core.operators import validate_against_oracle
from repro_torch.core.ordered_index import OrderedIndex
from repro_torch.core.types import ExecConfig, keys_to_torch, rows_to_state, state_to_numpy
from repro_torch.data import pipeline as data
from test_torch_baselines import assert_same, from_arrays, one_torch_thread  # noqa: F401

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_stream_reference.npz"
FIELDS = ("keys", "count", "sum", "min", "max")
SMALL = dict(memory_rows=128, page_rows=16, fanin=4, batch_rows=32)
N = 2000
U32, U64 = np.dtype(np.uint32), np.dtype(np.uint64)
POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")


@pytest.fixture(autouse=True)
def _reference_x64_scope(monkeypatch):
    """The reference scopes its uint64 work with
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; lend it the old name for one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


# ---------------------------------------------------------------------------
# stored results: name -> {entry: state | array | host value}
# ---------------------------------------------------------------------------


def _np_state(state) -> dict:
    if isinstance(state.keys, torch.Tensor):
        return state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def to_arrays(name: str, result: dict) -> dict[str, np.ndarray]:
    """A case's result as named NumPy arrays: states and dicts of arrays
    field by field, arrays as they are, everything else (stats, events,
    counts) as one JSON string."""
    out, host = {}, {}
    for entry, v in result.items():
        if type(v).__name__ in ("AggState", "OrderedIndex"):
            v = _np_state(getattr(v, "state", v))
        if isinstance(v, dict) and v and all(isinstance(x, np.ndarray) for x in v.values()):
            for f, arr in v.items():
                out[f"{name}|{entry}|{f}"] = np.asarray(arr)
        elif isinstance(v, np.ndarray):
            out[f"{name}|{entry}"] = v
        else:
            host[entry] = v
    out[f"{name}|host"] = np.asarray(json.dumps(host, sort_keys=True))
    return out


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict:
    """The reference's stored result of case ``name``."""
    arrays = _stored_arrays()
    if f"{name}|host" not in arrays.files:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_stream_reference.py")
    return from_arrays(name, arrays)


def roundtrip(name: str, result: dict) -> dict:
    """A port result in the stored layout."""
    return from_arrays(name, to_arrays(name, result))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

CASES: dict[str, dict] = {}
for _policy in POLICIES:
    for _kd in (U32, U64):
        CASES[f"stream-{_policy}-{_kd.name}"] = dict(kind="stream", policy=_policy, kd=_kd)
CASES["stream-unaligned-rs"] = dict(kind="unaligned")
CASES["stream-edges"] = dict(kind="edges")
CASES["stream-front_door"] = dict(kind="front_door")
CASES["stream-group_by"] = dict(kind="group_by")
EVICT = (("rs", U32), ("early_agg", U32), ("traditional", U32), ("rs", U64))
for _policy, _kd in EVICT:
    CASES[f"stream-evict-{_policy}-{_kd.name}"] = dict(kind="evict", policy=_policy, kd=_kd)
for _kd in (U32, U64):
    CASES[f"stream-ordered_index-{_kd.name}"] = dict(kind="ordered_index", kd=_kd)
STORED_CASES = tuple(CASES)
LIVE_CASE = "stream-traditional-uint32"


def keys_of(rng, n, domain, kd):
    """Seeded keys; u64 keys spread over both halves of the domain, one of
    them 2^63 - 1 (a valid u64 key, and the int64 value of the port's u64
    EMPTY)."""
    keys = rng.integers(0, domain, n).astype(np.uint64)
    if np.dtype(kd) == U64:
        keys = keys * np.uint64(0xF000000000000000 // domain) + np.uint64(3)
        keys[keys.size // 2] = np.uint64((1 << 63) - 1)
        return keys
    return keys.astype(np.uint32)


def case_inputs(name):
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    kd = c.get("kd", U32)
    return keys_of(rng, N, 900, kd), rng.normal(size=(N, 1)).astype(np.float32), rng


def unit(policy: str) -> int:
    """The engine's input batch: chunks cut at its multiples absorb the
    batches the one-shot pipeline does."""
    rsw = policy in ("traditional", "inrun_dedup")
    return SMALL["memory_rows"] if rsw else SMALL["batch_rows"]


def chunk_sizes(policy: str, chunking: str, n: int = N) -> list[int]:
    u = unit(policy)
    if chunking == "three":
        return [6 * u, 3 * u, n - 9 * u]
    sizes = [5 * u] * ((n - 1) // (5 * u))  # "tail": a ragged last chunk
    return sizes + [n - sum(sizes)]


def chunks_of(keys, pay, sizes):
    s = 0
    for c in sizes:
        yield keys[s:s + c], None if pay is None else pay[s:s + c]
        s += c


def _mods(ref: bool):
    """(pipeline module, ExecConfig, keywords) of the reference or the port."""
    if ref:
        return j_pipe, JExecConfig(**SMALL), dict(backend="xla")
    return pipeline, ExecConfig(**SMALL), dict(device="cpu")


def _rows(ref, keys, pay, kd):
    """Raw rows as a state of either package."""
    if ref:
        with j_types.key_dtype_context(kd):
            return j_types.rows_to_state(j_types.as_key_array(keys), jnp.asarray(pay))
    return rows_to_state(keys_to_torch(keys, "cpu"), torch.from_numpy(pay), key_dtype=kd)


def _evict_run(mod, cfg, kw, policy, kd, keys, pay):
    """Half the stream, a snapshot, an eviction below the lowest third of
    the keys, a snapshot, the other half, finalize."""
    agg = mod.StreamingAggregator(cfg, policy=policy, key_dtype=kd, width=1, **kw)
    out = {}
    for k, p in chunks_of(keys[:N // 2], pay[:N // 2], [250] * 4):
        agg.absorb(k, p)
    out["snapshot"], stats = agg.snapshot()
    out["snapshot_stats"] = stats.as_dict()
    out["retired"] = int(agg.evict_below(int(np.sort(keys)[N // 3])))
    out["after_evict"], stats = agg.snapshot()
    out["after_evict_stats"] = stats.as_dict()
    for k, p in chunks_of(keys[N // 2:], pay[N // 2:], [250] * 4):
        agg.absorb(k, p)
    out["final"], stats = agg.finalize()
    out["final_stats"] = stats.as_dict()
    return out


def _front_door(ref, cols, alg):
    pkg = repro if ref else repro_torch
    cfg = JExecConfig(**SMALL) if ref else ExecConfig(**SMALL)
    kw = dict(backend="xla") if ref else dict(device="cpu")
    src = j_data if ref else data
    res = pkg.aggregate(src.iter_column_batches(cols, 320), by=pkg.KeySpec.of(u=16, i=16),
                        values="x", aggs=("count", "sum", "avg"), cfg=cfg, output_estimate=1024,
                        algorithm=alg, **kw)
    plan = {k: res.plan.get(k) for k in ("algorithm", "policy", "streamed", "pipeline",
                                         "input_rows", "policy_switches", "readbacks_paid",
                                         "predicted_spill_insort")}
    return res.relation(), res.stats.as_dict(), plan


def compute(name: str, *, ref: bool) -> dict:
    """Run case ``name`` through the reference (``ref``) or the port on the
    CPU."""
    c = CASES[name]
    kind = c["kind"]
    mod, cfg, kw = _mods(ref)
    keys, pay, rng = case_inputs(name)
    if kind == "stream":
        policy = c["policy"]
        one, s1 = mod.insort_aggregate_device(keys, pay, cfg, policy=policy, **kw)
        st, s2 = mod.insort_aggregate_device_stream(
            chunks_of(keys, pay, chunk_sizes(policy, "three")), cfg, policy=policy, **kw)
        return dict(one_shot=one, one_shot_stats=s1.as_dict(), stream=st,
                    stream_stats=s2.as_dict())
    if kind == "unaligned":
        st, stats = mod.insort_aggregate_device_stream(
            chunks_of(keys, pay, [350] * 5 + [250]), cfg, policy="rs", **kw)
        return dict(state=st, stats=stats.as_dict())
    if kind == "edges":
        out = {}
        st, stats = mod.insort_aggregate_device_stream(iter(()), cfg, **kw)
        out.update(empty=st, empty_stats=stats.as_dict())
        st, stats = mod.insort_aggregate_device_stream(iter([keys[:1]]), cfg, policy="rs", **kw)
        out.update(one_row=st, one_row_stats=stats.as_dict())
        e = np.zeros(0, np.uint32)
        st, stats = mod.insort_aggregate_device_stream(
            iter([e, keys[:700], e, keys[700:], e]), cfg, policy="rs", **kw)
        out.update(empty_chunks=st, empty_chunks_stats=stats.as_dict())
        tail = np.full(300, np.iinfo(np.uint32).max, np.uint32)  # all-EMPTY rows
        for policy in ("traditional", "rs"):
            st, stats = mod.insort_aggregate_device_stream(
                iter([keys[:1000], tail]), cfg, policy=policy, **kw)
            out.update({f"empty_tail_{policy}": st, f"empty_tail_{policy}_stats": stats.as_dict()})
        hot = np.full(1800, 7, np.uint32)
        st, stats = mod.insort_aggregate_device_stream(chunks_of(hot, None, [600] * 3), cfg,
                                                       policy="rs", **kw)
        out.update(hot=st, hot_stats=stats.as_dict())
        st, stats = mod.insort_aggregate_device_stream(
            chunks_of(keys, pay, [1000, 1000]), cfg, policy="rs", widths=(1, 0, 0), **kw)
        out.update(widths=st, widths_stats=stats.as_dict())
        return out
    if kind == "front_door":
        cols = {"u": rng.integers(0, 50, N).astype(np.uint32),
                "i": rng.integers(0, 20, N).astype(np.uint32),
                "x": rng.random(N).astype(np.float32)}
        out = {}
        for alg in ("insort", "auto"):
            rel, stats, plan = _front_door(ref, cols, alg)
            out.update({f"{alg}_relation": rel, f"{alg}_stats": stats, f"{alg}_plan": plan})
        return out
    if kind == "group_by":
        ops = j_ops if ref else operators
        st, stats = ops.group_by(chunks_of(keys, pay, chunk_sizes("rs", "three")), None, cfg,
                                 **kw)
        return dict(state=st, stats=stats.as_dict())
    if kind == "evict":
        return _evict_run(mod, cfg, kw, c["policy"], c["kd"], keys, pay)
    # ordered_index: canonicalize two unsorted row sets, merge-absorb, trim
    kd = c["kd"]
    cls, be = (JOrderedIndex, dict(backend="xla")) if ref else (OrderedIndex, {})
    with j_types.key_dtype_context(kd) if ref else contextlib.nullcontext():
        a = cls.from_unsorted(_rows(ref, keys[:700], pay[:700], kd), **be)
        b = cls.from_unsorted(_rows(ref, keys[700:900], pay[700:900], kd), **be)
        merged = a.merge_absorb(b, **be)
        empty = (cls.empty(16, 1, key_dtype=kd) if ref
                 else cls.empty(16, 1, key_dtype=kd, device="cpu"))
        out = dict(a=a, b=b, merged=merged, trimmed=merged.trim(700), empty=empty,
                   with_empty=a.merge_absorb(empty, **be))
        return {k: _np_state(v.state) for k, v in out.items()}


def port_result(name: str) -> dict:
    return roundtrip(name, compute(name, ref=False))


def _names(kind):
    return [n for n, c in CASES.items() if c["kind"] == kind]


def _live(state) -> tuple:
    """A state's valid rows (keys, counts, sums) on the host."""
    s = state_to_numpy(state)
    v = s["keys"] != np.iinfo(s["keys"].dtype).max
    return s["keys"][v], s["count"][v], s["sum"][v]


def _assert_rows_equal(a, b, msg=""):
    (ka, ca, va), (kb, cb, vb) = _live(a), _live(b)
    np.testing.assert_array_equal(ka, kb, err_msg=msg)
    np.testing.assert_array_equal(ca, cb, err_msg=msg)
    np.testing.assert_allclose(va, vb, rtol=1e-6, err_msg=msg)


# ---------------------------------------------------------------------------
# streamed vs one-shot, and against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _names("stream"))
def test_streamed_matches_one_shot_exactly(name):
    """The reference's one-shot and streamed results whole; the port's
    streams of unit-aligned chunkings (uneven chunks, and equal chunks with
    a ragged tail) equal its one-shot's rows and stats exactly."""
    policy = CASES[name]["policy"]
    result = compute(name, ref=False)
    got = roundtrip(name, result)
    assert_same(got, stored(name))
    assert got["stream_stats"] == got["one_shot_stats"]
    keys, pay, _ = case_inputs(name)
    st, stats = pipeline.insort_aggregate_device_stream(
        chunks_of(keys, pay, chunk_sizes(policy, "tail")), ExecConfig(**SMALL), policy=policy,
        device="cpu")
    assert stats.as_dict() == got["one_shot_stats"]
    _assert_rows_equal(result["one_shot"], st)
    _assert_rows_equal(result["one_shot"], result["stream"])
    validate_against_oracle(st, keys, pay)


def test_streamed_unaligned_chunks_match_reference_and_oracle():
    name = "stream-unaligned-rs"
    got = port_result(name)
    assert_same(got, stored(name))
    keys, pay, _ = case_inputs(name)
    st, stats = pipeline.insort_aggregate_device_stream(
        chunks_of(keys, pay, [350] * 5 + [250]), ExecConfig(**SMALL), device="cpu")
    assert stats.total_spill_rows > 0
    validate_against_oracle(st, keys, pay)


def test_streamed_edges():
    """An empty stream, one row, empty chunks among real ones, a chunk of
    EMPTY rows (no-ops in every policy), one hot key, and a plane-width
    restriction."""
    name = "stream-edges"
    got = port_result(name)
    assert_same(got, stored(name))
    assert got["empty"]["keys"].shape == (0,) and got["empty_stats"]["total_spill_rows"] == 0
    assert got["one_row"]["count"][0] == 1
    keys, _, _ = case_inputs(name)
    hot = got["hot"]
    assert (hot["keys"] != np.iinfo(np.uint32).max).sum() == 1 and hot["count"][0] == 1800
    assert got["widths"]["min"].shape[1] == 0 and got["widths"]["sum"].shape[1] == 1
    for policy in ("traditional", "rs"):
        st, stats = pipeline.insort_aggregate_device_stream(
            iter([keys[:1000]]), ExecConfig(**SMALL), policy=policy, device="cpu")
        want = state_to_numpy(st)
        live = want["keys"] != np.iinfo(np.uint32).max
        tail = got[f"empty_tail_{policy}"]
        np.testing.assert_array_equal(tail["keys"][:live.sum()], want["keys"][live])
        assert got[f"empty_tail_{policy}_stats"] == stats.as_dict()


def test_rebatch_chunks_and_super_batch_rows_match_reference():
    keys, pay, _ = case_inputs("stream-rs-uint32")
    sizes = [350] * 5 + [250]
    got = list(pipeline.rebatch_chunks(chunks_of(keys, pay, sizes), 512))
    want = list(j_pipe.rebatch_chunks(chunks_of(keys, pay, sizes), 512))
    assert [len(k) for k, _ in got] == [len(k) for k, _ in want] == [512, 512, 512, 464]
    for (gk, gp), (wk, wp) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gp, wp)
    assert [p for _, p in pipeline.rebatch_chunks(iter([keys[:3], (keys[3:5], None)]), 4)] == [
        None, None]
    with pytest.raises(ValueError, match="positive"):
        list(pipeline.rebatch_chunks(iter([keys]), 0))
    with pytest.raises(ValueError, match="pair"):
        list(pipeline.rebatch_chunks(iter([(keys, pay, pay)]), 4))
    cfg = ExecConfig(**SMALL)
    st1, s1 = pipeline.insort_aggregate_device_stream(
        chunks_of(keys, pay, sizes), cfg, super_batch_rows=512, device="cpu")
    st2, s2 = pipeline.insort_aggregate_device_stream(iter(got), cfg, device="cpu")
    assert s1.as_dict() == s2.as_dict()
    assert all(torch.equal(getattr(st1, f), getattr(st2, f)) for f in FIELDS)


def test_staging_pads_in_the_unsigned_domain():
    """A u64 chunk's tail pads with the dtype's all-ones (EMPTY), not with
    the int64 value of the port's EMPTY, which is the valid key 2^63 - 1."""
    agg = pipeline.StreamingAggregator(ExecConfig(**SMALL), key_dtype=np.uint64, width=1,
                                       device="cpu")
    keys = np.array([5, (1 << 63) - 1, 1 << 63], np.uint64)
    padded, pay, rows, rows_padded, local = agg._prep(keys, None)
    assert rows == local == 3 and rows_padded == SMALL["batch_rows"] == padded.size
    assert (padded[3:] == np.iinfo(np.uint64).max).all() and pay.shape == (32, 1)
    agg.absorb(keys)
    state, _ = agg.finalize()
    np.testing.assert_array_equal(_live(state)[0], np.sort(keys))


# ---------------------------------------------------------------------------
# the front door, group_by and the adapters
# ---------------------------------------------------------------------------


def test_schema_aggregate_streams_column_batches():
    """Column batches through ``repro_torch.aggregate`` with ``insort`` and
    with ``auto`` (adaptive here): the reference's relations, stats and
    plans; the one-shot relation; a count-only call drops the value column;
    an empty stream."""
    name = "stream-front_door"
    got = port_result(name)
    assert_same(got, stored(name))
    assert got["auto_plan"]["algorithm"] == "adaptive"
    assert got["insort_plan"]["streamed"] and got["insort_plan"]["input_rows"] == N
    _, _, rng = case_inputs(name)
    cols = {"u": rng.integers(0, 50, N).astype(np.uint32),
            "i": rng.integers(0, 20, N).astype(np.uint32),
            "x": rng.random(N).astype(np.float32)}
    by = repro_torch.KeySpec.of(u=16, i=16)
    one = repro_torch.aggregate({k: cols[k] for k in ("u", "i")}, by=by, values=cols["x"],
                                aggs=("count", "sum", "avg"), cfg=ExecConfig(**SMALL),
                                output_estimate=1024, device="cpu").relation()
    for k in ("u", "i", "count"):
        np.testing.assert_array_equal(got["insort_relation"][k], one[k])
    np.testing.assert_allclose(got["insort_relation"]["sum"], one["sum"], rtol=1e-5, atol=1e-5)
    res_c = repro_torch.aggregate(data.iter_column_batches(cols, 320), by=by, values="x",
                                  aggs=("count",), cfg=ExecConfig(**SMALL), device="cpu")
    assert res_c.state.widths == (0, 0, 0)
    np.testing.assert_array_equal(res_c.relation()["count"], one["count"])
    empty = repro_torch.aggregate(iter(()), by=by, aggs=("count",), cfg=ExecConfig(**SMALL),
                                  device="cpu")
    assert empty.occupancy() == 0 and empty.plan["streamed"]


def test_streamed_front_door_input_validation():
    """The port refuses what the reference refuses, with the same error
    types and words."""
    cfgs = (ExecConfig(**SMALL), JExecConfig(**SMALL))
    bad = (
        (ValueError, "in-sort", dict(algorithm="hash")),
        (ValueError, "pipeline='device'", dict(pipeline="host")),
        (TypeError, "must name a column", dict(values=np.zeros(100), aggs=("sum",))),
        (KeyError, "missing", dict(values="x", aggs=("sum",))),
        (ValueError, "need a payload", dict(aggs=("sum",))),
    )
    for exc, words, kw in bad:
        for pkg, cfg in zip((repro_torch, repro), cfgs):
            extra = dict(device="cpu") if pkg is repro_torch else {}
            with pytest.raises(exc, match=words):
                pkg.aggregate(iter([{"k": np.arange(100, dtype=np.uint32)}]),
                              by=pkg.KeySpec.of(k=12), cfg=cfg, **kw, **extra)
    for mod in (data, j_data):
        with pytest.raises(ValueError, match="rows"):
            list(mod.iter_column_batches({"k": np.arange(4)}, 0))
        with pytest.raises(ValueError, match="expected"):
            list(mod.iter_column_batches({"a": np.arange(4), "b": np.arange(5)}, 2))


def test_group_by_accepts_chunk_iterator():
    name = "stream-group_by"
    got = port_result(name)
    assert_same(got, stored(name))
    keys, pay, _ = case_inputs(name)
    cfg = ExecConfig(**SMALL)
    st1, s1 = operators.group_by(keys, pay, cfg, device="cpu")
    st2, s2 = operators.group_by(chunks_of(keys, pay, chunk_sizes("rs", "three")), None, cfg,
                                 device="cpu")
    _assert_rows_equal(st1, st2)
    assert s1.as_dict() == s2.as_dict()
    with pytest.raises(ValueError, match="in-sort"):
        operators.group_by(chunks_of(keys, pay, [N]), None, cfg, algorithm="hash", device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        operators.group_by(chunks_of(keys, None, [N]), pay, cfg, device="cpu")


def test_column_adapters_match_reference():
    """``iter_column_batches`` and ``rebatch_columns`` yield the
    reference's batches."""
    rng = np.random.default_rng(5)
    shards = [{"a": rng.integers(0, 9, n).astype(np.uint32),
               "x": rng.random(n).astype(np.float32)} for n in (300, 50, 0, 700, 10)]
    got = list(data.rebatch_columns(iter(shards), 256))
    want = list(j_data.rebatch_columns(iter(shards), 256))
    assert [len(b["a"]) for b in got] == [len(b["a"]) for b in want] == [256] * 4 + [36]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    table = {k: np.concatenate([s[k] for s in shards]) for k in ("a", "x")}
    for g, w in zip(data.iter_column_batches(table, 300), j_data.iter_column_batches(table, 300)):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert list(data.iter_column_batches({}, 3)) == []
    for mod in (data, j_data):
        with pytest.raises(ValueError, match="columns"):
            list(mod.rebatch_columns(iter([{"a": np.arange(4)}, {"b": np.arange(4)}]), 2))


# ---------------------------------------------------------------------------
# OrderedIndex, snapshots, eviction, the slice's small types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _names("ordered_index"))
def test_ordered_index_matches_reference(name):
    got = port_result(name)
    assert_same(got, stored(name))
    assert got["merged"]["keys"].shape == (900,) and got["trimmed"]["keys"].shape == (700,)
    assert sorted_ops.OrderedIndex is OrderedIndex is repro_torch.core.OrderedIndex


@pytest.mark.parametrize("policy", ["rs", "early_agg", "traditional", "adaptive"])
def test_snapshot_leaves_the_engine_equal(policy):
    """Every tensor of the engine is equal before and after a snapshot,
    and a stream with a snapshot in the middle ends equal to one without."""
    keys, pay, _ = case_inputs("stream-rs-uint32")
    cfg = ExecConfig(**SMALL)

    def run(snap_at):
        agg = pipeline.StreamingAggregator(cfg, policy=policy, width=1, device="cpu")
        for i, (k, p) in enumerate(chunks_of(keys, pay, [256] * 7 + [208])):
            agg.absorb(k, p)
            if i == snap_at:
                es = agg._es
                before = [t.clone() for t in _engine_tensors(es)]
                host = dataclasses.asdict(dataclasses.replace(
                    es, table=None, table2=None, frontier=None, store=None))
                state, stats = agg.snapshot()
                validate_against_oracle(state, keys[:256 * (i + 1)], pay[:256 * (i + 1)])
                assert all(torch.equal(a, b) for a, b in zip(before, _engine_tensors(es)))
                assert host == dataclasses.asdict(dataclasses.replace(
                    es, table=None, table2=None, frontier=None, store=None))
        return agg.finalize()

    (s1, st1), (s2, st2) = run(3), run(None)
    assert all(torch.equal(getattr(s1, f), getattr(s2, f)) for f in FIELDS)
    assert st1.as_dict() == st2.as_dict()


def _engine_tensors(es):
    return [getattr(s, f) for s in (es.table, es.table2, es.store) for f in FIELDS] + [
        es.frontier]


@pytest.mark.parametrize("name", _names("evict"))
def test_evict_below_matches_reference(name):
    """Snapshots before and after ``evict_below``, the retired-row count,
    and the finalize after more input, as the reference gives them."""
    got = port_result(name)
    want = stored(name)
    assert_same(got, want)
    assert got["retired"] > 0 and got["final_stats"]["rows_retired"] == got["retired"]
    keys, _, _ = case_inputs(name)
    thr = np.sort(keys)[N // 3]
    live = got["after_evict"]["keys"] != np.iinfo(keys.dtype).max
    assert (got["after_evict"]["keys"][live] >= thr).all()


def test_small_types_match_reference():
    """``KeySpec.max_packed``, ``types.max_key`` and
    ``ExchangeOverflowError`` as the reference has them; a mesh of one rank
    streams as one device does, but for the exchange's accounting."""
    for bits in ({"a": 12}, {"a": 20, "b": 20}):
        assert (repro_torch.KeySpec.of(**bits).max_packed
                == repro.KeySpec.of(**bits).max_packed)
    for kd in (U32, U64):
        assert t_types.max_key(kd) == j_types.max_key(kd)
        assert t_types.max_key(kd).dtype == kd
    err = t_types.ExchangeOverflowError("quota", quota=8, max_fill=11)
    assert isinstance(err, RuntimeError) and (err.quota, err.max_fill) == (8, 11)
    cfg = ExecConfig(**SMALL)
    from repro_torch.distributed import sharding

    mesh = sharding.data_mesh("data", device="cpu")
    with pytest.raises(ValueError, match="without mesh"):
        pipeline.StreamingAggregator(cfg, mesh_axis="data", device="cpu")
    keys = np.arange(5, dtype=np.uint32)
    st, stats = operators.group_by(iter([keys]), None, cfg, mesh=mesh, device="cpu")
    st1, stats1 = operators.group_by(iter([keys]), None, cfg, device="cpu")
    assert stats.rows_exchanged == 5 and stats.exchange_quota > 0
    np.testing.assert_array_equal(_live(st)[0], _live(st1)[0])
    with pytest.raises(ValueError, match="unknown policy"):
        pipeline.StreamingAggregator(cfg, policy="hash", device="cpu")
    agg = pipeline.StreamingAggregator(cfg, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        agg.evict_below(1 << 32)
    with pytest.raises(TypeError, match="key dtype"):
        agg.absorb(np.arange(4, dtype=np.uint64))
    assert agg.evict_below(3) == 0 and agg.snapshot()[0].capacity == 0
    state, stats = agg.finalize()
    assert state.capacity == 0 and stats.total_spill_rows == 0
    with pytest.raises(RuntimeError, match="finalized"):
        agg.absorb(np.arange(4, dtype=np.uint32))
    assert schema_mod.KeySpec is repro_torch.KeySpec


def test_stored_reference_is_the_reference_output():
    """The stored results are the reference's: the live case, recomputed
    here, equals its stored result."""
    assert_same(roundtrip(LIVE_CASE, compute(LIVE_CASE, ref=True)), stored(LIVE_CASE))

"""The port's aggregation service held against the JAX package's.

Mirrors tests/test_service.py but for its mesh test (ROADMAP Queue 1 item
11), on seeded NumPy inputs through the reference (``"xla"`` backend) and
the port on the CPU.  ``AggregationService``: a snapshot after k
unit-aligned chunks equals the reference's (keys, counts, ``SpillStats``
exactly, float planes within rtol 1e-4) and the port's one-shot pipeline
over those chunks, leaves every engine tensor equal, and ingest after it
closes to the one-shot result over all chunks, for every policy and both
key dtypes; back-to-back snapshots are identical; ``snapshot_device`` adds
no readback of its own; empty and all-evicted services answer empty
relations; ``retire_below`` retires exactly the rows below the watermark
and every later answer reports them; thresholds are validated; an output
overrun names ``snapshot`` or ``finalize``; ``wide_merge_device``'s
``out=`` buffer; the metrics facade.  ``AggregationSession`` /
``serve_aggregate``: composite keys, declarative aggregates, watermark
TTL, validation, and the launcher ``launch/serve_agg.py``.

The reference's results cost XLA compiles, so
``scripts/make_torch_service_reference.py`` computes them from this
module's case table (``CASES``) into ``tests/data/torch_service_reference.npz``;
its ``--check`` recomputes them all.  ``LIVE_CASE`` is recomputed live here.
"""
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.types import ExecConfig as JExecConfig
from repro.launch import serve_agg as j_serve_agg
from repro.service import AggregationService as JAggregationService
from repro.service import ServiceMetrics as JServiceMetrics
from repro.service.metrics import _quantile as j_quantile
from repro_torch.core import merge as merge_mod
from repro_torch.core import pipeline
from repro_torch.core.operators import validate_against_oracle
from repro_torch.core.types import (
    SYNCS,
    DeviceSpillStats,
    ExecConfig,
    empty_key,
    empty_state,
    max_key,
    state_to_numpy,
)
from repro_torch.launch import serve_agg
from repro_torch.service import AggregationService, AggregationSession, ServiceMetrics
from repro_torch.service.metrics import _quantile
from test_torch_baselines import assert_same, from_arrays, one_torch_thread  # noqa: F401
from test_torch_stream import _reference_x64_scope, to_arrays  # noqa: F401

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_service_reference.npz"
FIELDS = ("keys", "count", "sum", "min", "max")
SMALL = dict(memory_rows=128, page_rows=16, fanin=4, batch_rows=32)
N = 2000
DOMAIN = 600
U32, U64 = np.dtype(np.uint32), np.dtype(np.uint64)
POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")
THRESHOLD = 300
LATENCY_KEYS = ("snapshot_p50_s", "snapshot_p99_s")


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

CASES: dict[str, dict] = {}
for _policy in POLICIES:
    for _kd in (U32, U64):
        CASES[f"service-parity-{_policy}-{_kd.name}"] = dict(kind="parity", policy=_policy,
                                                             kd=_kd)
    CASES[f"service-evict-{_policy}"] = dict(kind="evict", policy=_policy)
CASES["service-all_evicted"] = dict(kind="all_evicted")
CASES["service-empty"] = dict(kind="empty")
CASES["session-schema"] = dict(kind="session")
CASES["session-empty"] = dict(kind="session_empty")
STORED_CASES = tuple(CASES)
LIVE_CASE = "service-evict-traditional"


def mkinput(rng, n=N, kd=U32):
    keys = rng.integers(0, DOMAIN, n).astype(kd)
    if kd == U64:
        keys = keys << np.uint64(30)
    return keys, rng.normal(size=(n, 1)).astype(np.float32)


def case_rng(name):
    return np.random.default_rng(sorted(CASES).index(name))


def unit(policy: str) -> int:
    return SMALL["memory_rows"] if policy in ("traditional", "inrun_dedup") else SMALL["batch_rows"]


def unit_sizes(policy: str, n: int) -> list[int]:
    u = unit(policy)
    return [u] * (n // u) + ([n % u] if n % u else [])


def chunks_of(keys, pay, sizes):
    s = 0
    for c in sizes:
        yield keys[s:s + c], None if pay is None else pay[s:s + c]
        s += c


def make_service(ref: bool, policy="rs", key_dtype=U32, width=1, **kw):
    kw.setdefault("output_rows", 4096)
    if ref:
        return JAggregationService(JExecConfig(**SMALL), policy=policy, key_dtype=key_dtype,
                                   width=width, backend="xla", **kw)
    return AggregationService(ExecConfig(**SMALL), policy=policy, key_dtype=key_dtype,
                              width=width, device="cpu", **kw)


def metrics_of(svc) -> dict:
    """The metrics summary but for the latencies (host clocks)."""
    return {k: v for k, v in svc.metrics.summary().items() if k not in LATENCY_KEYS}


def _session_inputs(rng):
    return (rng.integers(0, 8, N).astype(np.uint32), rng.integers(0, 400, N).astype(np.uint32),
            rng.random(N).astype(np.float32))


def _plan_of(res) -> dict:
    return {k: res.plan[k] for k in ("algorithm", "pipeline", "streamed", "service",
                                     "snapshots", "input_rows", "output_estimate",
                                     "predicted_spill_insort", "cost_model")}


def compute(name: str, *, ref: bool, probe=None) -> dict:
    """Run case ``name`` through the reference (``ref``) or the port on the
    CPU.  ``probe(svc, stage)`` sees the port's service at the case's
    checkpoints."""
    c = CASES[name]
    kind = c["kind"]
    rng = case_rng(name)
    out = {}
    if kind == "parity":
        policy, kd = c["policy"], c["kd"]
        keys, pay = mkinput(rng, kd=kd)
        cut = 8 * unit(policy)
        svc = make_service(ref, policy, kd)
        for k, p in chunks_of(keys[:cut], pay[:cut], [unit(policy)] * 8):
            svc.ingest(k, p)
        svc.flush()
        if probe:
            probe(svc, "before")
        out["snapshot"], stats = svc.snapshot()
        out["snapshot_stats"] = stats.as_dict()
        if probe:
            probe(svc, "after")
        for k, p in chunks_of(keys[cut:], pay[cut:], unit_sizes(policy, N - cut)):
            svc.ingest(k, p)
        out["final"], stats = svc.close()
        out["final_stats"] = stats.as_dict()
        out["metrics"] = metrics_of(svc)
        return out
    if kind == "evict":
        policy = c["policy"]
        keys, pay = mkinput(rng)
        svc = make_service(ref, policy)
        for k, p in chunks_of(keys, pay, unit_sizes(policy, N)):
            svc.ingest(k, p)
        out["retired"] = int(svc.retire_below(THRESHOLD))
        out["snapshot"], stats = svc.snapshot()
        out["snapshot_stats"] = stats.as_dict()
        # retirement is point in time: keys below the old watermark ingested
        # after the eviction are live again
        svc.ingest(np.full(64, 3, np.uint32), np.ones((64, 1), np.float32))
        out["final"], stats = svc.close()
        out["final_stats"] = stats.as_dict()
        return out
    if kind == "all_evicted":
        keys, pay = mkinput(rng)
        svc = make_service(ref, "rs")
        for k, p in chunks_of(keys, pay, unit_sizes("rs", N)):
            svc.ingest(k, p)
        out["retired"] = int(svc.retire_below(int(max_key(np.uint32))))
        out["snapshot"], stats = svc.snapshot()
        out["snapshot_stats"] = stats.as_dict()
        late_keys, late_pay = mkinput(rng, n=1024)
        for k, p in chunks_of(late_keys, late_pay, unit_sizes("rs", 1024)):
            svc.ingest(k, p)
        out["final"], stats = svc.close()
        out["final_stats"] = stats.as_dict()
        return out
    if kind == "empty":
        svc = make_service(ref, "rs", widths=(1, 0, 0))
        out["empty"], stats = svc.snapshot()
        out["empty_stats"] = stats.as_dict()
        keys, pay = mkinput(rng, n=512)
        svc.ingest(keys, pay)
        out["after_ingest"], stats = svc.snapshot()
        out["after_ingest_stats"] = stats.as_dict()
        out["metrics"] = metrics_of(svc)
        return out
    pkg = repro if ref else repro_torch
    by = pkg.KeySpec.of(minute=12, user=10)
    kw = dict(cfg=JExecConfig(**SMALL)) if ref else dict(cfg=ExecConfig(**SMALL), device="cpu")
    if kind == "session_empty":
        sess = pkg.serve_aggregate(by=by, watermark="minute", **kw)
        out["expired"] = sess.expire_below(minute=3)
        out["snapshot"] = sess.snapshot().relation()
        out["final"] = sess.close().relation()
        return out
    minutes, users, amount = _session_inputs(rng)
    sess = pkg.serve_aggregate(by=by, values="amount", aggs=("count", "sum", "avg"),
                               watermark="minute", output_rows=4096, **kw)
    for s in range(0, N, 500):
        sess.ingest({"minute": minutes[s:s + 500], "user": users[s:s + 500],
                     "amount": amount[s:s + 500]})
    res = sess.snapshot()
    out.update(snapshot=res.relation(), snapshot_stats=res.stats.as_dict(),
               snapshot_plan=_plan_of(res))
    out["retired"] = int(sess.expire_below(minute=4))
    res = sess.snapshot()
    out.update(expired=res.relation(), expired_stats=res.stats.as_dict())
    res = sess.close()
    out.update(final=res.relation(), final_stats=res.stats.as_dict(), final_plan=_plan_of(res))
    return out


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict:
    """The reference's stored result of case ``name``."""
    arrays = _stored_arrays()
    if f"{name}|host" not in arrays.files:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_service_reference.py")
    return from_arrays(name, arrays)


def roundtrip(name: str, result: dict) -> dict:
    return from_arrays(name, to_arrays(name, result))


def _names(kind):
    return [n for n, c in CASES.items() if c["kind"] == kind]


def _live(arrays: dict):
    v = arrays["keys"] != np.iinfo(arrays["keys"].dtype).max
    return arrays["keys"][v], arrays["count"][v], arrays["sum"][v]


def _engine_tensors(es):
    return [getattr(s, f) for s in (es.table, es.table2, es.store) for f in FIELDS] + [
        es.frontier]


# ---------------------------------------------------------------------------
# snapshot parity + non-destructiveness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _names("parity"))
def test_snapshot_parity_and_nondestructive(name):
    """The reference's snapshot, close and metrics; the snapshot equal to
    the port's one-shot pipeline over the ingested chunks (rows and
    ``SpillStats``) and leaving every engine tensor and counter equal; the
    close equal to the one-shot over every chunk; a closed service
    refuses."""
    policy = CASES[name]["policy"]
    seen = {}

    def probe(svc, stage):
        es = svc._agg._es
        host = dataclasses.asdict(dataclasses.replace(es, table=None, table2=None,
                                                      frontier=None, store=None))
        seen[stage] = ([t.clone() for t in _engine_tensors(es)], host)
        seen["svc"] = svc

    got = roundtrip(name, compute(name, ref=False, probe=probe))
    assert_same(got, stored(name))
    (tb, hb), (ta, ha) = seen["before"], seen["after"]
    assert all(torch.equal(a, b) for a, b in zip(tb, ta)) and hb == ha
    keys, pay = mkinput(case_rng(name), kd=CASES[name]["kd"])
    cut = 8 * unit(policy)
    cfg = ExecConfig(**SMALL)
    for rows, entry in ((cut, "snapshot"), (N, "final")):
        st, stats = pipeline.insort_aggregate_device(keys[:rows], pay[:rows], cfg, policy=policy,
                                                     device="cpu")
        assert got[f"{entry}_stats"] == stats.as_dict()
        want = _live(state_to_numpy(st))
        for a, b in zip(_live(got[entry]), want):
            np.testing.assert_allclose(a, b, rtol=1e-6)
    with pytest.raises(RuntimeError, match="closed"):
        seen["svc"].snapshot()


def test_repeated_snapshots_are_stable():
    """Back-to-back snapshots of one engine return identical states and
    stats (the port compiles nothing, so the reference's jit-cache check
    becomes this one)."""
    keys, pay = mkinput(np.random.default_rng(5))
    svc = make_service(False, "rs")
    for k, p in chunks_of(keys[:8 * 32], pay[:8 * 32], [32] * 8):
        svc.ingest(k, p)
    state1, stats1 = svc.snapshot()
    state2, stats2 = svc.snapshot()
    assert stats1.as_dict() == stats2.as_dict()
    assert all(torch.equal(getattr(state1, f), getattr(state2, f)) for f in FIELDS)
    assert svc.metrics.snapshots_taken == 2


@pytest.mark.parametrize("policy", ["rs", "early_agg"])
def test_snapshot_device_adds_no_host_sync(policy):
    """An ingest loop with ``snapshot_device`` queries reads back exactly
    as often as the same loop without them (``types.SYNCS``), and the
    answers stay unread: the stats are a ``DeviceSpillStats``."""
    keys, pay = mkinput(np.random.default_rng(6))
    sizes = unit_sizes(policy, N)

    def loop(query: bool):
        svc = make_service(False, policy)
        before = SYNCS["host_syncs"]
        answers = []
        for i, (k, p) in enumerate(chunks_of(keys, pay, sizes)):
            svc.ingest(k, p)
            if query and (i + 1) % 16 == 0:
                answers.append(svc.snapshot_device())
        svc.flush()
        return SYNCS["host_syncs"] - before, answers, svc

    base, _, _ = loop(False)
    syncs, answers, svc = loop(True)
    assert syncs == base and len(answers) == len(sizes) // 16
    state, dstats = svc.snapshot_device()
    assert isinstance(dstats, DeviceSpillStats) and state.device.type == "cpu"
    assert dstats.finalize(entry_point="snapshot").rows_retired == 0
    validate_against_oracle(state, keys, pay)


# ---------------------------------------------------------------------------
# empty / all-evicted services answer valid empty relations
# ---------------------------------------------------------------------------


def test_empty_service_snapshot_is_valid():
    name = "service-empty"
    got = roundtrip(name, compute(name, ref=False))
    assert_same(got, stored(name))
    assert got["empty"]["keys"].shape == (0,) and got["empty"]["sum"].shape == (0, 1)
    assert got["empty_stats"]["total_spill_rows"] == 0
    keys, _ = mkinput(case_rng(name), n=512)
    assert got["metrics"]["snapshots_taken"] == 2
    assert _live(got["after_ingest"])[0].size == np.unique(keys).size


def test_all_evicted_session_snapshot_and_reingest():
    name = "service-all_evicted"
    got = roundtrip(name, compute(name, ref=False))
    assert_same(got, stored(name))
    assert got["retired"] > 0 and _live(got["snapshot"])[0].size == 0
    assert got["snapshot_stats"]["rows_retired"] == got["final_stats"]["rows_retired"] == got[
        "retired"]


# ---------------------------------------------------------------------------
# TTL eviction semantics + accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _names("evict"))
def test_eviction_retires_exactly_below_watermark(name):
    got = roundtrip(name, compute(name, ref=False))
    assert_same(got, stored(name))
    assert got["retired"] > 0 and got["snapshot_stats"]["rows_retired"] == got["retired"]
    keys, pay = mkinput(case_rng(name))
    live = keys >= THRESHOLD
    exp_keys = np.unique(keys[live])
    k, c, v = _live(got["snapshot"])
    np.testing.assert_array_equal(k, exp_keys)
    np.testing.assert_array_equal(c, np.bincount(keys[live], minlength=DOMAIN)[exp_keys])
    np.testing.assert_allclose(v[:, 0], np.bincount(keys[live], weights=pay[live, 0],
                                                    minlength=DOMAIN)[exp_keys],
                               rtol=1e-4, atol=1e-3)
    k2, c2, _ = _live(got["final"])
    assert k2[0] == 3 and c2[0] == 64
    assert got["final_stats"]["rows_retired"] == got["retired"]


def test_evict_threshold_validation():
    svc = make_service(False, "rs")
    svc.ingest(*mkinput(np.random.default_rng(7), n=256))
    with pytest.raises(ValueError, match="threshold"):
        svc.retire_below(-1)
    with pytest.raises(ValueError, match="EMPTY"):
        svc.retire_below(int(empty_key(np.uint32)))  # the sentinel itself
    assert svc.retire_below(0) == 0  # a vacuous eviction is legal


# ---------------------------------------------------------------------------
# overflow errors name their entry point; the wide merge's out buffer
# ---------------------------------------------------------------------------


def test_output_overrun_names_entry_point():
    keys = np.arange(512, dtype=np.uint32)  # 512 distinct groups
    svc = make_service(False, "rs", width=0, output_rows=16)
    svc.ingest(keys)
    with pytest.raises(RuntimeError, match="snapshot"):
        svc.snapshot()
    svc2 = make_service(False, "rs", width=0, output_rows=16)
    svc2.ingest(keys)
    with pytest.raises(RuntimeError, match="finalize"):
        svc2.close()


def test_wide_merge_out_buffer():
    """A buffer of other plane widths is refused, a call with neither
    ``out`` nor ``out_capacity`` too; a caller's buffer gets the rows the
    allocating call returns, bit for bit, and host run lengths spare the
    readback."""
    store = empty_state(64, 1, key_dtype=np.uint32, device="cpu").map(lambda x: x[None])
    lens = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="does not match the run store"):
        merge_mod.wide_merge_device(store, lens, page_rows=32, index_rows=64,
                                    out=empty_state(16, 2, key_dtype=np.uint32, device="cpu"))
    with pytest.raises(ValueError, match="out_capacity"):
        merge_mod.wide_merge_device(store, lens, page_rows=32, index_rows=64)
    rng = np.random.default_rng(8)
    runs = [np.unique(rng.integers(0, 500, 300)).astype(np.uint32) for _ in range(4)]
    st = empty_state(4 * 320, 1, key_dtype=np.uint32, device="cpu")
    st = st.map(lambda x: x.reshape((4, 320) + tuple(x.shape[1:])))
    for r, k in enumerate(runs):
        st.keys[r, :k.size] = torch.from_numpy(k.astype(np.int64))
        st.count[r, :k.size] = 1
        st.sum[r, :k.size] = 1.0
    kw = dict(page_rows=32, index_rows=256)
    want = merge_mod.wide_merge_device(st, torch.tensor([k.size for k in runs]),
                                       out_capacity=1024, **kw)
    out = empty_state(1024, 1, key_dtype=np.uint32, widths=(1, 1, 1), device="cpu")
    before = SYNCS["host_syncs"]
    got = merge_mod.wide_merge_device(st, [k.size for k in runs], out=out, **kw)
    assert SYNCS["host_syncs"] == before and got[0] is out and got[2] == want[2]
    assert all(torch.equal(getattr(got[0], f), getattr(want[0], f)) for f in FIELDS)
    assert all(torch.equal(a, b) for a, b in zip(got[3:], want[3:])) and int(got[1]) == int(
        want[1])


# ---------------------------------------------------------------------------
# metrics facade
# ---------------------------------------------------------------------------


def test_metrics_facade():
    keys, pay = mkinput(np.random.default_rng(9))
    svc = make_service(False, "rs")
    sizes = unit_sizes("rs", N)
    for i, (k, p) in enumerate(chunks_of(keys, pay, sizes)):
        svc.ingest(k, p)
        if (i + 1) % 20 == 0:
            svc.snapshot()
    m = svc.metrics
    assert m.rows_ingested == N and m.chunks_ingested == len(sizes)
    assert m.snapshots_taken == len(m.snapshot_latencies_s) > 0
    assert 0.0 < m.duplicate_rate < 1.0  # domain << N: heavy duplication
    assert m.groups_last_snapshot > 0 and m.runs_generated > 0
    assert m.snapshot_latency_s(0.5) <= m.snapshot_latency_s(0.99)
    assert list(m.summary()) == list(JServiceMetrics().summary())
    assert ServiceMetrics().snapshot_latency_s(0.99) == 0.0
    xs = sorted(np.random.default_rng(10).random(7).tolist())
    for q in (0.0, 0.5, 0.99, 1.0):  # nearest rank, as the reference's
        assert _quantile(xs, q) == j_quantile(xs, q) and _quantile([], q) == 0.0


# ---------------------------------------------------------------------------
# schema sessions: composite keys, declarative aggs, watermark TTL
# ---------------------------------------------------------------------------


def test_session_schema_end_to_end():
    name = "session-schema"
    got = roundtrip(name, compute(name, ref=False))
    assert_same(got, stored(name))
    assert got["snapshot_plan"]["service"] and got["snapshot_plan"]["streamed"]
    assert got["retired"] > 0 and got["expired"]["minute"].min() >= 4
    assert got["expired_stats"]["rows_retired"] == got["final_stats"]["rows_retired"] == got[
        "retired"]
    minutes, users, amount = _session_inputs(case_rng(name))
    ref = repro_torch.aggregate({"minute": minutes, "user": users},
                                by=repro_torch.KeySpec.of(minute=12, user=10), values=amount,
                                aggs=("count", "sum", "avg"), cfg=ExecConfig(**SMALL),
                                device="cpu").relation()
    for col in ("minute", "user", "count"):
        np.testing.assert_array_equal(got["snapshot"][col], ref[col])
    np.testing.assert_allclose(got["snapshot"]["sum"], ref["sum"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["expired"]["count"], ref["count"][ref["minute"] >= 4])


def test_session_closed_and_validation():
    by = repro_torch.KeySpec.of(minute=12, user=10)
    kw = dict(cfg=ExecConfig(**SMALL), device="cpu")
    sess = repro_torch.serve_aggregate(by=by, watermark="minute", **kw)
    sess.ingest({"minute": np.arange(10), "user": np.arange(10)})
    assert sess.close().relation()["count"].sum() == 10 and sess.closed
    for call in (sess.snapshot, lambda: sess.ingest({"minute": [1], "user": [1]})):
        with pytest.raises(RuntimeError, match="closed"):
            call()
    with pytest.raises(ValueError, match="major"):
        repro_torch.serve_aggregate(by=by, watermark="user", **kw)
    with pytest.raises(ValueError, match="payload"):
        repro_torch.serve_aggregate(by=by, aggs=("sum",), **kw)
    with pytest.raises(TypeError, match="column"):
        repro_torch.serve_aggregate(by=by, values=np.zeros(4), aggs=("sum",), **kw)
    sess2 = repro_torch.serve_aggregate(by=by, watermark="minute", **kw)
    with pytest.raises(ValueError, match="range"):
        sess2.expire_below(minute=1 << 13)
    with pytest.raises(ValueError, match="ONE cutoff"):
        sess2.expire_below(3, minute=3)
    with pytest.raises(RuntimeError, match="watermark"):
        repro_torch.serve_aggregate(by=by, **kw).expire_below(3)
    from repro_torch.distributed import sharding

    mesh = sharding.data_mesh("data", device="cpu")
    for make in (lambda: AggregationService(ExecConfig(**SMALL), policy="adaptive", mesh=mesh,
                                            device="cpu"),
                 lambda: AggregationService(ExecConfig(**SMALL), mesh=mesh, mesh_axis="model",
                                            device="cpu")):
        with pytest.raises(ValueError, match="mesh|axis"):
            make()
    assert repro_torch.serve_aggregate(by=by, mesh=mesh, **kw).snapshot().relation()[
        "count"].size == 0
    assert repro_torch.service.serve_aggregate(by=by, **kw).device.type == "cpu"
    assert isinstance(sess2, AggregationSession)


def test_session_empty_answers_the_empty_relation():
    name = "session-empty"
    got = roundtrip(name, compute(name, ref=False))
    assert_same(got, stored(name))
    assert got["expired"] == 0 and set(got["snapshot"]) >= {"minute", "user", "count"}
    assert len(got["snapshot"]["count"]) == len(got["final"]["count"]) == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_agg_launcher_on_the_cpu(capsys):
    """``launch/serve_agg.py``: the reference's synthetic traffic and TTL
    cutoffs, and a session with TTL whose final group count equals a NumPy
    count of the rows not retired."""
    for a, b in zip(serve_agg.synth_chunks(3, 64, keyspace=1024, seed=4),
                    j_serve_agg.synth_chunks(3, 64, keyspace=1024, seed=4)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    kw = dict(chunks=12, chunk_rows=512, snapshot_every=4, memory_rows=256, batch_rows=64, ttl=1,
              warmup=False, quiet=True, device="cpu")
    r = serve_agg.serve(**kw)
    keyspace = 1024
    chunks = list(serve_agg.synth_chunks(12, 512, keyspace=keyspace, seed=0))
    thr = serve_agg.ttl_cutoff(12, ttl=1, snapshot_every=4, keyspace=keyspace)
    assert thr == int((12 - 4) * 0.02 * keyspace)
    keys = np.concatenate([k for k, _ in chunks])
    assert r["rows_ingested"] == keys.size and r["snapshots"] == 3
    assert r["final_groups"] == np.unique(keys[keys >= thr]).size
    assert r["rows_retired"] > 0 and r["device"] == "cpu"
    out = serve_agg.main(["--smoke", "--device", "cpu"])
    assert out["rows_ingested"] == 12 * 512
    assert "ingested 6144 rows" in capsys.readouterr().out


def test_stored_reference_is_the_reference_output():
    """The stored results are the reference's: the live case, recomputed
    here, equals its stored result."""
    assert_same(roundtrip(LIVE_CASE, compute(LIVE_CASE, ref=True)), stored(LIVE_CASE))

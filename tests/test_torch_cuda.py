"""The CUDA kernels held against their plain versions on the card, and the
port's pipeline and model families (MoE, dense, MLA, Mamba2, the hybrid,
M-RoPE, the encoder) on the card against their plain CPU runs.  Every test needs
an NVIDIA card and ``nvcc`` and skips elsewhere; on the card run

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port).
Aggregate payloads are integer-valued, so sums agree exactly in any
order; a grouped matmul must lie within one ulp of its dtype at the
float32 product plus float32's bound for summing D products in another
order (twice D * 2^-24 * sum |x||w|): both accumulate in float32, then
round once.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import insort, instream, operators, pipeline
from repro_torch.core import ordered_index as oi
from repro_torch.core.types import (
    ExecConfig,
    empty_key,
    keys_to_torch,
    rows_to_state,
    state_to_numpy,
    take,
)
from repro_torch.configs import get_config
from repro_torch.data import pipeline as data_pipeline
from repro_torch.kernels import (
    bitonic_sort,
    grouped_matmul,
    merge_aggregate,
    merge_path,
    ops,
    segmented_reduce,
)
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.models import transformer as T

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


# Every size class and its edges (bitonic_sort.plan): the warp's 32, the
# block's 1,024, a cluster's CTAs of 1,024 to 4,096 pairs up to 65,536 keys,
# the large class above; keys with 30% interior EMPTY rows, all keys equal
# (stable across CTAs and clusters) and all EMPTY.
@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("keys", ["30% empty", "all equal", "all empty"])
@pytest.mark.parametrize("n", [1, 32, 33, 1024, 1025, 2049, 8191, 8192, 8193, 65535, 65536,
                               65537, 70000, 1 << 20, (1 << 20) + 1])
def test_argsort_kernel_matches_plain(dev, n, keys, key_dtype):
    domain, empty_frac = {"30% empty": (max(1, n // 4), 0.3), "all equal": (1, 0.0),
                          "all empty": (1, 1.0)}[keys]
    k = _state(dev, n, key_dtype, domain, widths=(0, 0, 0), empty_frac=empty_frac,
               sort=False).keys
    assert torch.equal(bitonic_sort.argsort_cuda(k), bitonic_sort.argsort_plain(k))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,domain,widths", [
    (1, 1, (1, 1, 1)), (513, 60, (2, 0, 2)), (100_000, 1, (1, 0, 0)),  # one group spans all
    (100_000, 20_000, (0, 0, 0)),
    # a tile of the fused pass - 1, a tile and a tile + 1; one group over both tiles
    (2047, 300, (1, 0, 0)), (2048, 300, (1, 1, 1)), (2049, 300, (4, 4, 4)), (2049, 1, (1, 1, 1)),
    (65_536, 16_384, (1, 0, 0)),  # the aggregate's batch
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


# The cases a look-back across tiles of 2,048 output rows gets wrong: one key
# for every row (a group spanning every tile), an all-EMPTY side, empty
# sides, totals of a tile - 1, a tile and a tile + 1 (one and two tiles),
# very unequal sides, and min/max planes whose neutral values are +-inf.
@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("na,nb,domain,empty_a,empty_b,widths", [
    (70_000, 5_000, 1, 0.0, 0.0, (1, 1, 1)),       # one group spans every tile
    (9_000, 3_000, 4, 0.0, 0.3, (1, 0, 0)),        # four groups of some 3,000 rows
    (6_000, 2_500, 50, 1.0, 0.1, (1, 1, 1)),       # A all EMPTY
    (2_500, 6_000, 50, 0.1, 1.0, (1, 1, 1)),       # B all EMPTY
    (0, 5_000, 900, 0.0, 0.2, (2, 2, 2)), (5_000, 0, 900, 0.2, 0.0, (2, 2, 2)),
    (1_500, 547, 300, 0.1, 0.1, (1, 0, 0)), (1_024, 1_024, 300, 0.1, 0.1, (1, 0, 0)),
    (2_000, 49, 300, 0.1, 0.1, (1, 0, 0)), (3_000, 1_095, 600, 0.1, 0.1, (0, 2, 2)),
    (3_000, 1_096, 600, 0.1, 0.1, (0, 2, 2)), (3_000, 1_097, 600, 0.1, 0.1, (0, 2, 2)),
    (5, 70_000, 20_000, 0.0, 0.1, (4, 0, 0)), (200_000, 3, 50_000, 0.1, 0.0, (4, 0, 0)),
    (40_000, 40_000, 2_000, 0.05, 0.05, (2, 2, 2)),  # min/max planes, many tiles
])
def test_merge_absorb_kernel_edge_cases(dev, na, nb, domain, empty_a, empty_b, widths,
                                        key_dtype):
    a = _state(dev, na, key_dtype, domain, widths=widths, empty_frac=empty_a)
    b = _state(dev, nb, key_dtype, domain, widths=widths, empty_frac=empty_b)
    got = merge_path.merge_absorb_cuda(a, b)
    torch.cuda.synchronize()
    _assert_same(got, merge_path.merge_absorb_plain(a, b))


def _probe_pair(dev, n, m, key_dtype):
    """Sorted, duplicate-free key vectors with EMPTY tails: ``b`` holds
    ``m`` valid keys, ``a`` about ``n`` and shares b's first and last key
    and one key above all of b's.  ``chip_smoke.py::probe_keys`` makes the
    same pairs: the script imports nothing of the tests, so it keeps its
    own copy."""
    domain = 4 * max(n, m, 1)
    b = np.unique(RNG.integers(1, domain, m))[:m]
    a = np.unique(RNG.integers(0, domain, n))
    if n:
        extra = [domain + 7] + ([b[0], b[-1]] if b.size else [])
        a = np.unique(np.concatenate([a[: max(n - 3, 0)], extra]))
    out = []
    for k in (a, b):
        k = k.astype(np.uint64)
        if key_dtype == np.uint64:  # spread over both halves of the u64 domain
            k = k * np.uint64(0x9E3779B97F4A7C15 // (domain + 8))
        k = np.concatenate([k, np.full(k.size // 8 + (k.size > 0), np.iinfo(key_dtype).max,
                                       np.uint64)]).astype(key_dtype)
        out.append(keys_to_torch(k, dev))
    return out


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n,m", [(0, 50), (50, 0), (0, 0), (1, 1), (3000, 700), (700, 3000),
                                 (70_000, 200_000)])
def test_join_probe_kernel_matches_plain(dev, n, m, key_dtype):
    a, b = _probe_pair(dev, n, m, key_dtype)
    empty = empty_key(key_dtype)
    pos, hit = merge_path.join_probe_cuda(a, b, empty)
    want_pos, want_hit = merge_path.join_probe_plain(a, b, empty)
    assert pos.dtype == torch.int32 and hit.dtype == torch.bool
    assert torch.equal(pos, want_pos) and torch.equal(hit, want_hit)
    if n:  # b's first and last keys hit; a's largest valid key is above all of b's
        assert int(hit.sum()) >= min(2, m)


def test_wrappers_launch_on_cuda_and_count(dev):
    ops.reset_launch_counts()
    st = _state(dev, 1000, np.uint32, 300)
    ops.merge_absorb_sorted(ops.segmented_combine(st), st)
    ops.argsort_keys(st.keys)
    ops.join_probe(st.keys, st.keys, st.empty)
    ops.merge_absorb_sorted_bitonic(st, st)
    ops.moe_grouped_matmul(st.sum.reshape(10, 100), st.sum.reshape(2, 100, 5), capacity=5)
    ops.moe_grouped_matmul(st.sum.reshape(10, 100)[:, :96].contiguous().bfloat16(),
                           torch.ones((2, 96, 8), dtype=torch.bfloat16, device=dev), capacity=5)
    assert ops.LAUNCHES == {"argsort": 1, "segmented_combine": 1, "merge_absorb": 1,
                            "join_probe": 1, "grouped_matmul": 1, "grouped_matmul_simt": 1,
                            "grouped_matmul_bwd": 0, "merge_absorb_bitonic": 1}


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


def _baseline(name):
    """The paper's baselines and the host loop, each as ``f(keys, payload,
    cfg, device) -> (state, stats)``."""
    host = dict(host_rs=("rs", True), host_early_agg=("early_agg", True),
                host_traditional_merge=("rs", False))
    if name in ("traditional", "inrun_dedup", "early_agg"):
        return lambda k, p, cfg, d: pipeline.insort_aggregate_device(
            k, p, cfg, policy=name, output_estimate=1 << 14, device=d)
    if name in host:
        policy, wide = host[name]
        return lambda k, p, cfg, d: insort.insort_aggregate(
            k, p, cfg, pipeline="host", run_policy=policy, use_wide_merge=wide,
            output_estimate=1 << 14, device=d)
    return lambda k, p, cfg, d: operators.group_by(k, p, cfg, algorithm=name, device=d)


BASELINES = ("traditional", "inrun_dedup", "early_agg", "host_rs", "host_early_agg",
             "host_traditional_merge", "sort_then_stream", "hash", "f1_hash", "inmemory")


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_on_the_card_matches_cpu(dev, name, key_dtype):
    """Each policy and algorithm on the card equals its plain CPU run: the
    state (integer payloads: exact), ``SpillStats``, and the argsort
    launched on the card."""
    keys = RNG.integers(0, 3000, 20_000).astype(key_dtype)
    if key_dtype == np.uint64:
        keys = keys * np.uint64(0xF000000000000000 // 3000) + np.uint64(5)
    pay = RNG.integers(0, 50, (20_000, 1)).astype(np.float32)
    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)
    ops.reset_launch_counts()
    sa, da = _baseline(name)(keys, pay, cfg, dev)
    assert ops.LAUNCHES["argsort"] > 0
    sb, db = _baseline(name)(keys, pay, cfg, "cpu")
    assert da.as_dict() == db.as_dict()
    a, b = state_to_numpy(sa), state_to_numpy(sb)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


# tests/test_adaptive.py's crossover constants: traditional below a window
# duplicate rate of 0.3125, early_agg above
CROSSOVER = {
    "schema_version": 1,
    "absorb_row_ns": {"traditional": 100.0, "inrun_dedup": 120.0, "early_agg": 150.0,
                      "rs": 900.0},
    "absorb_dup_row_ns": {"traditional": 100.0, "inrun_dedup": 120.0, "early_agg": 50.0,
                          "rs": 900.0},
    "sort_row_ns": 30.0, "merge_row_ns": 50.0, "hash_probe_row_ns": 80.0,
    "spill_write_row_ns": 10.0, "meta": {"backend": "test", "generated_by": "tests"},
}


def _phase_change(key_dtype, n=24_576):
    """A unique-heavy half and a duplicate-heavy half; integer payloads."""
    keys = np.concatenate([RNG.integers(1, 2**31, n // 2), RNG.integers(1, 24, n // 2)])
    keys = keys.astype(np.uint64) * np.uint64(3) if key_dtype == np.uint64 else keys
    return keys.astype(key_dtype), RNG.integers(0, 50, (n, 1)).astype(np.float32)


def _stream_on(d, policy, keys, pay, *, snapshot_at=None, evict_at=None):
    """One stream in chunks of 1,024 rows on device ``d``: (state arrays,
    stats, policy events, rows retired)."""
    from repro_torch.core.adaptive import GovernorConfig

    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)
    gov = (GovernorConfig(constants=CROSSOVER, start="traditional", hysteresis=0.05,
                          min_window_rows=64) if policy == "adaptive" else None)
    agg = pipeline.StreamingAggregator(cfg, policy=policy, key_dtype=keys.dtype, width=1,
                                       governor=gov, device=d)
    retired = None
    for i in range(0, keys.size, 1024):
        agg.absorb(keys[i:i + 1024], pay[i:i + 1024])
        if i == snapshot_at:
            es = agg._es
            tensors = [getattr(s, f) for s in (es.table, es.table2, es.store)
                       for f in ("keys", "count", "sum", "min", "max")] + [es.frontier]
            before = [t.clone() for t in tensors]
            agg.snapshot()
            assert all(torch.equal(a, b) for a, b in zip(before, tensors))
        if i == evict_at:
            retired = agg.evict_below(int(np.sort(keys)[keys.size // 4]))
    state, stats = agg.finalize()
    return state_to_numpy(state), stats.as_dict(), agg.policy_events, retired


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("policy", ["rs", "early_agg", "traditional", "adaptive"])
def test_stream_on_the_card_matches_cpu(dev, policy, key_dtype):
    """A stream on the card (a snapshot in the middle that leaves every
    engine tensor equal, an eviction at three quarters) equals its plain CPU
    run: the state, ``SpillStats`` with the observation block, the policy
    events (an adaptive stream switches), the rows retired; the aggregate
    kernels launched."""
    keys, pay = _phase_change(key_dtype)
    ops.reset_launch_counts()
    got = _stream_on(dev, policy, keys, pay, snapshot_at=12_288, evict_at=18_432)
    assert ops.LAUNCHES["argsort"] > 0 and ops.LAUNCHES["merge_absorb"] > 0
    want = _stream_on("cpu", policy, keys, pay, evict_at=18_432)
    for f in got[0]:
        np.testing.assert_array_equal(got[0][f], want[0][f], err_msg=f)
    assert got[1:] == want[1:]
    assert got[3] > 0 and got[1]["rows_retired"] == got[3]
    if policy == "adaptive":
        assert got[1]["policy_switches"] >= 1 and got[2][0]["to"] == "early_agg"


def test_streamed_front_door_on_the_card_matches_cpu(dev, monkeypatch):
    """Column batches through ``repro_torch.aggregate``, ``insort`` and
    ``auto`` (adaptive), on the card and on the CPU.  The governor steers by
    its device type's constants, and the card has its own: both sides steer
    by the card's here, so that they pick the same arms."""
    from repro_torch.core import adaptive
    from repro_torch.data.pipeline import iter_column_batches

    class CardConstants(adaptive.GovernorConfig):
        def __post_init__(self):
            self.backend = "cuda"
            super().__post_init__()

    monkeypatch.setattr(adaptive, "GovernorConfig", CardConstants)
    cols = {"k": RNG.integers(0, 3000, 20_000).astype(np.uint32),
            "x": RNG.integers(0, 50, 20_000).astype(np.float32)}
    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)
    for alg in ("insort", "auto"):
        res = [repro_torch.aggregate(iter_column_batches(cols, 3000),
                                     by=repro_torch.KeySpec.of(k=12), values="x",
                                     aggs=("count", "sum"), algorithm=alg, cfg=cfg, device=d)
               for d in (dev, "cpu")]
        assert res[0].state.device.type == "cuda" and res[0].plan["streamed"]
        assert res[0].stats.as_dict() == res[1].stats.as_dict()
        a, b = res[0].relation(), res[1].relation()
        for c in a:
            np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def test_card_plans_read_the_cards_constants(dev):
    """A plan made on the card reads the ``"cuda"`` entry; the governor of
    an adaptive stream on the card steers by it."""
    cols = {"k": RNG.integers(0, 3000, 5000).astype(np.uint32)}
    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)
    by = repro_torch.KeySpec.of(k=12)
    for d, want in ((dev, "cuda"), ("cpu", "cpu")):
        res = repro_torch.aggregate(cols, by=by, cfg=cfg, device=d)
        assert res.plan["cost_model"]["calibrated_backend"] == want
        sess = repro_torch.serve_aggregate(by=by, cfg=cfg, device=d)
        sess.ingest(cols)
        assert sess.snapshot().plan["cost_model"]["calibrated_backend"] == want
    agg = pipeline.StreamingAggregator(cfg, policy="adaptive", device=dev)
    assert agg._governor._constants["meta"]["backend"] == "cuda"


def _service_on(d, policy, keys, pay):
    """A service in chunks of 1,024 rows on device ``d``: a snapshot at a
    third (every engine tensor equal after it), an eviction below the upper
    quarter of the keys at two thirds, ingest after it, close.  Returns the
    snapshots, stats and rows retired as NumPy and host values."""
    from repro_torch.service import AggregationService

    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)
    svc = AggregationService(cfg, policy=policy, key_dtype=keys.dtype, width=1, device=d)
    out = []
    n = keys.size
    for i in range(0, n, 1024):
        svc.ingest(keys[i:i + 1024], pay[i:i + 1024])
        if i == (n // 3) // 1024 * 1024:
            svc.flush()
            es = svc._agg._es
            tensors = [getattr(s, f) for s in (es.table, es.table2, es.store)
                       for f in ("keys", "count", "sum", "min", "max")] + [es.frontier]
            before = [t.clone() for t in tensors]
            state, stats = svc.snapshot()
            assert all(torch.equal(a, b) for a, b in zip(before, tensors))
            out.append((state_to_numpy(state), stats.as_dict()))
        if i == (2 * n // 3) // 1024 * 1024:
            out.append(svc.retire_below(int(np.sort(keys)[3 * n // 4])))
            state, stats = svc.snapshot()
            out.append((state_to_numpy(state), stats.as_dict()))
    state, stats = svc.close()
    out.append((state_to_numpy(state), stats.as_dict()))
    return out


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("policy", ["rs", "early_agg", "traditional"])
def test_service_on_the_card_matches_cpu(dev, policy, key_dtype):
    """``AggregationService`` on the card against its plain CPU run: the
    snapshot (which leaves every engine tensor equal), the eviction's count,
    the snapshot after it and the close; the aggregate kernels launched."""
    keys, pay = _phase_change(key_dtype)
    ops.reset_launch_counts()
    got = _service_on(dev, policy, keys, pay)
    assert ops.LAUNCHES["argsort"] > 0 and ops.LAUNCHES["merge_absorb"] > 0
    want = _service_on("cpu", policy, keys, pay)
    assert got[1] == want[1] and got[1] > 0
    for (ga, gs), (wa, ws) in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert gs == ws
        for f in ga:
            np.testing.assert_array_equal(ga[f], wa[f], err_msg=f)
    assert got[-1][1]["rows_retired"] == got[1]


@pytest.mark.parametrize("n,chunk,domain", [(20_000, 1024, 3000), (5000, 300, 1), (1, 16, 5),
                                            (0, 16, 5)])
def test_instream_on_the_card_matches_cpu(dev, n, chunk, domain):
    keys = np.sort(RNG.integers(0, domain, n).astype(np.uint32))
    pay = RNG.integers(0, 50, (n, 2)).astype(np.float32)
    ops.reset_launch_counts()
    sa, ga = instream.instream_aggregate(keys, pay, chunk=chunk, device=dev)
    assert ops.LAUNCHES["segmented_combine"] == -(-n // chunk)
    sb, gb = instream.instream_aggregate(keys, pay, chunk=chunk, device="cpu")
    assert int(ga) == int(gb)
    a, b = state_to_numpy(sa), state_to_numpy(sb)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("algorithm", ["insort", "hash"])
def test_intersect_distinct_on_the_card_matches_cpu(dev, algorithm):
    a = RNG.integers(0, 9000, 30_000).astype(np.uint32)
    b = RNG.integers(4000, 20_000, 12_000).astype(np.uint32)
    cfg = ExecConfig(memory_rows=1024, batch_rows=256, page_rows=128, fanin=4)
    ops.reset_launch_counts()
    ka, sa = operators.intersect_distinct(a, b, cfg, algorithm=algorithm, device=dev)
    assert ops.LAUNCHES["join_probe"] == 1
    kb, sb = operators.intersect_distinct(a, b, cfg, algorithm=algorithm, device="cpu")
    assert sa.as_dict() == sb.as_dict()
    assert torch.equal(ka.cpu(), kb)
    got = ka.cpu().numpy()
    np.testing.assert_array_equal(got[got != empty_key(np.uint32)], np.intersect1d(a, b))


@pytest.mark.parametrize("bits", [dict(region=6, store=8), dict(partkey=21, suppkey=17)],
                         ids=["u32", "u64"])
def test_merge_join_and_rollup_on_the_card_match_cpu(dev, bits):
    spec = repro_torch.KeySpec.of(**bits)
    names = list(bits)
    cfg = ExecConfig(memory_rows=512, batch_rows=128, page_rows=64, fanin=4)

    def relation(seed, lo, hi, d):
        r = np.random.default_rng(seed)
        cols = {names[0]: r.integers(0, 40, 5000), names[1]: r.integers(lo, hi, 5000)}
        vals = r.integers(0, 50, 5000).astype(np.float32)
        return repro_torch.aggregate(cols, by=spec, values=vals, aggs=("count", "sum"),
                                     cfg=cfg, device=d)

    got = {}
    for d in (dev, "cpu"):
        ops.reset_launch_counts()
        L, R = relation(1, 0, 60, d), relation(2, 30, 90, d)
        J = L.merge_join(R)
        out = {"inner": J.relation(), "semi": L.merge_join(R, how="semi").relation(),
               "anti": L.merge_join(R, how="anti").relation()}
        for level, tier in J.rollup().items():
            out[level] = tier.relation()
        got[d] = (out, J.stats.as_dict(), dict(ops.LAUNCHES))
    (a, sa, la), (b, sb, lb) = got[dev], got["cpu"]
    assert sa == sb
    assert la["join_probe"] == 3 and la["segmented_combine"] > 0
    assert lb == {k: 0 for k in lb}
    assert list(a) == list(b)
    for k in a:
        assert list(a[k]) == list(b[k]), k
        for c in a[k]:
            np.testing.assert_array_equal(a[k][c], b[k][c], err_msg=f"{k}: {c}")
    assert a["inner"]["join_count"].size > 0 and a["anti"]["count_left"].size > 0


def gmm_error(got, x, w, c) -> float:
    """Largest |got - float32 product| in units of the tolerance above."""
    e, d, f = w.shape
    xs = x.reshape(e, c, d).float()
    want32 = torch.einsum("ecd,edf->ecf", xs, w.float()).reshape(e * c, f)
    mag = torch.einsum("ecd,edf->ecf", xs.abs(), w.float().abs()).reshape(e * c, f)
    _, ex = torch.frexp(want32)
    bits = 8 if x.dtype == torch.bfloat16 else 24
    tol = torch.ldexp(torch.ones_like(want32), ex - bits) + 2 * d * 2.0 ** -24 * mag
    return float(((got.float() - want32).abs() / tol).max())


# the four serve shapes (wg/wi 2048 -> 768 and wo 768 -> 2048 at decode's
# C = 8 and prefill's C = 64); capacities 8, 13, 64, 72 and 264 (two N
# tiles); D and F multiples of 8 but not of 64; the CUDA-core variant's
# bfloat16 widths (F = 130, 257) and float32; bf16: the variant bfloat16
# takes at these widths (float32 always runs on the CUDA cores)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,c,d,f,bf16", [
    (128, 8, 2048, 768, "wgmma"), (128, 8, 768, 2048, "wgmma"), (128, 64, 2048, 768, "wgmma"),
    (128, 64, 768, 2048, "wgmma"), (4, 8, 256, 384, "wgmma"), (3, 13, 200, 136, "wgmma"),
    (5, 72, 136, 200, "wgmma"), (2, 264, 200, 136, "wgmma"), (3, 64, 200, 130, "simt"),
    (2, 72, 96, 257, "simt"), (1, 33, 2048, 768, "wgmma"),
])
def test_grouped_matmul_kernel_matches_plain(dev, e, c, d, f, bf16, dtype):
    x = torch.from_numpy(RNG.normal(size=(e * c, d)).astype(np.float32)).to(dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(e * c + d + f)  # serve-size weights on the card
    w = (torch.randn((e, d, f), generator=gen, device=dev) / np.sqrt(d)).to(dtype)
    x[: c // 2] = 0  # capacity padding rows
    ops.reset_launch_counts()
    got = ops.moe_grouped_matmul(x, w, capacity=c)
    torch.cuda.synchronize()
    tensor_cores = dtype == torch.bfloat16 and bf16 == "wgmma"
    assert ops.LAUNCHES["grouped_matmul" if tensor_cores else "grouped_matmul_simt"] == 1
    assert ops.LAUNCHES["grouped_matmul_simt" if tensor_cores else "grouped_matmul"] == 0
    want32 = torch.einsum("ecd,edf->ecf", x.reshape(e, c, d).float(), w.float()).reshape(e * c, f)
    assert got.dtype == dtype and got.shape == (e * c, f)
    assert torch.equal(grouped_matmul.grouped_matmul_plain(x, w, capacity=c), want32.to(dtype))
    assert gmm_error(got, x, w, c) <= 1.0
    assert not got[: c // 2].any()


# The plan's edges (merge_aggregate.plan, a tile of 8,192 words): m one
# tile; a tile x 2 and x 8, each -1 and +1 row (no pass, one pass of one
# stage; one of three, one of four); |a| + |b| above n, the next power of two
# of the larger side (m = 2n); B empty; two global passes.
@pytest.mark.parametrize("na,nb,domain,widths", [
    (64, 64, 32, (2, 2, 2)), (1024, 1024, 512, (1, 0, 0)), (3000, 500, 5000, (4, 0, 0)),
    (5, 70_000, 50_000, (1, 1, 1)), (1 << 16, 4096, 1, (1, 0, 0)),  # all keys equal
    (0, 9, 20, (1, 0, 0)),
    (6000, 2192, 3000, (1, 0, 0)), (10_000, 6383, 5000, (1, 1, 1)),
    (10_000, 6385, 5000, (1, 0, 0)), (60_000, 5535, 40_000, (1, 0, 0)),
    (60_000, 5537, 1, (2, 0, 0)), (5000, 4000, 2000, (1, 1, 1)), (70_000, 0, 30_000, (1, 0, 0)),
    (300_000, 200_000, 100_000, (1, 0, 0)),
])
def test_bitonic_kernel_matches_plain(dev, na, nb, domain, widths):
    a = _state(dev, na, np.uint32, domain, widths=widths, empty_frac=0.2, unique=True)
    b = _state(dev, nb, np.uint32, domain, widths=widths, empty_frac=0.1)
    got = merge_aggregate.merge_absorb_bitonic_cuda(a, b)
    torch.cuda.synchronize()
    assert got.capacity == na + nb
    _assert_same(got, merge_aggregate.merge_absorb_bitonic_plain(a, b))
    _assert_same(got, merge_path.merge_absorb_plain(a, b))


def test_serve_full_width_two_layers_on_the_card_matches_cpu(dev):
    """qwen3-moe-30b-a3b at its published widths, cut to 2 layers, in
    float32: the card (kernels) and the CPU (plain versions) on the same
    weights, the CPU run teacher-forced with the card's tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dc.replace(get_config("qwen3-moe-30b-a3b"), n_layers=2, dtype="float32")
    card = M.init(cfg, torch.Generator(device=dev).manual_seed(5))
    host = M.Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    prompts = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(5))
    ops.reset_launch_counts()
    a = generate(card, cfg, prompts, gen=4, max_len=36, keep_logits=True)
    assert ops.LAUNCHES["grouped_matmul_simt"] == 3 * 2 * 4 and ops.LAUNCHES["argsort"] == 2 * 4
    b = generate(host, cfg, prompts, gen=4, max_len=36, force=a.tokens[:, :-1],
                 keep_logits=True)
    np.testing.assert_allclose(a.logits, b.logits, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("n", [1, 33, 1537, 65536, 1 << 20])
@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_sort_keys_on_the_card_matches_plain(dev, n, key_dtype):
    """``ops.sort_keys`` (one argsort launch and a gather) against its plain
    version on the CPU, EMPTY rows included."""
    keys = _state(dev, n, key_dtype, max(2, n // 3), sort=False).keys
    ops.reset_launch_counts()
    got = ops.sort_keys(keys)
    assert ops.LAUNCHES["argsort"] == 1
    assert torch.equal(got.cpu(), ops.sort_keys(keys.cpu()))


@pytest.mark.parametrize("t,n,domain", [(1, 2, 2**32), (3, 4096, 2**32), (64, 4096, 2**32),
                                        (2, 512, 2), (64, 4096, 100)])
def test_bitonic_sorts_on_the_card_match_plain(dev, t, n, domain):
    """The tile-batch sorts: one argsort launch each, the sorted rows equal
    the plain version's, the payload the plain version's (the argsort is
    stable on both)."""
    keys = torch.from_numpy(RNG.integers(0, domain, (t, n))).to(dev)
    vals = torch.arange(t * n, device=dev).view(t, n)
    ops.reset_launch_counts()
    got = bitonic_sort.bitonic_sort(keys)
    sk, sv = bitonic_sort.bitonic_sort_kv(keys, vals)
    assert ops.LAUNCHES["argsort"] == 2
    want_k, want_v = bitonic_sort.bitonic_sort_kv(keys.cpu(), vals.cpu())
    assert torch.equal(got.cpu(), want_k) and torch.equal(sk.cpu(), want_k)
    assert torch.equal(sv.cpu(), want_v)


def test_dedup_on_the_card_matches_cpu(dev):
    """Fingerprints, kept documents and ``SpillStats`` of a corpus that
    spills (M = 2^10 over 20,000 documents) equal the CPU run's."""
    docs = data_pipeline.SyntheticCorpus(vocab=128256, n_docs=20_000, dup_rate=0.3, seed=2,
                                         max_len=256).documents()
    np.testing.assert_array_equal(data_pipeline.fingerprints(docs, device=dev),
                                  data_pipeline.fingerprints(docs, device="cpu"))
    cfg = ExecConfig(memory_rows=1 << 10, page_rows=64, fanin=4, batch_rows=256)
    ops.reset_launch_counts()
    card, s_card = data_pipeline.dedup_examples(docs, cfg, device=dev)
    assert all(ops.LAUNCHES[k] > 0 for k in ("argsort", "segmented_combine", "merge_absorb"))
    host, s_host = data_pipeline.dedup_examples(docs, cfg, device="cpu")
    assert s_card.as_dict() == s_host.as_dict() and s_card.runs_generated > 4
    assert len(card) == len(host) and all(a is b for a, b in zip(card, host))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-1.5b", "granite-20b",
                                  "mistral-large-123b"])
def test_dense_serve_on_the_card_matches_cpu(dev, arch):
    """Each dense smoke config, with its full config's activation, cache
    duplication, bias and tying, in float32: the card and the CPU on the
    same weights, the CPU run teacher-forced with the card's tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = get_config(arch)
    cfg = dc.replace(get_config(arch, smoke=True), act=full.act, kv_dup=full.kv_dup,
                     qkv_bias=full.qkv_bias, tie_embeddings=full.tie_embeddings)
    card = M.init(cfg, torch.Generator(device=dev).manual_seed(7))
    host = M.Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    prompts = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(7))
    a = generate(card, cfg, prompts, gen=5, max_len=64, keep_logits=True)
    b = generate(host, cfg, prompts, gen=5, max_len=64, force=a.tokens[:, :-1],
                 keep_logits=True)
    np.testing.assert_allclose(a.logits, b.logits, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def _card_and_host(dev, cfg, seed):
    """A model drawn on the card and its copy on the CPU (float32 products
    in float32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = M.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    host = M.Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    return card, host


def _block_steps(blk, cfg, x, caches, steps: int):
    """A block's prefill of x[:, :-steps] into ``caches`` (one layer's rows
    of :func:`M.init_cache`), then ``steps`` one-token steps: the outputs
    concatenated."""
    s = x.shape[1] - steps
    cache = T.layer_cache(caches, 0)
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[0], -1)
    out, cache, _ = T.apply_block(blk, cfg, x[:, :s], pos[:, :s], cache=cache)
    outs = [out]
    for t in range(s, x.shape[1]):
        out, cache, _ = T.apply_block(blk, cfg, x[:, t:t + 1], pos[:, t:t + 1], cache=cache)
        outs.append(out)
    return torch.cat(outs, 1)


@pytest.mark.parametrize("arch,kind", [("deepseek-v3-671b", "attn_mlp"),
                                       ("deepseek-v3-671b", "attn_moe"),
                                       ("mamba2-2.7b", "mamba")])
def test_full_width_block_on_the_card_matches_cpu(dev, arch, kind):
    """One block at its published widths in float32: deepseek-v3's MLA with
    its dense MLP; its MLA with the MoE (7168 -> 2048 experts and the
    shared one, through the kernels), 32 of its 256 experts so that the
    CPU copy stays small; mamba2's SSD.  A prefill of 32 positions into the
    cache and 2 decode steps, the card against the CPU on the same weights
    within rtol/atol 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dc.replace(get_config(arch), n_layers=1, dtype="float32")
    if cfg.moe is not None:
        cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, num_experts=32,
                                             first_k_dense=int(kind == "attn_mlp")))
    card = T.Block(cfg, kind, dtype=torch.float32, device=dev,
                   gen=torch.Generator(device=dev).manual_seed(11))
    host = T.Block(cfg, kind, dtype=torch.float32, device="cpu")
    host.load_state_dict(card.state_dict())
    x = torch.randn((2, 34, cfg.d_model), generator=torch.Generator().manual_seed(11))
    caches = M.init_cache(cfg, 2, 40, device="cpu")
    caches = caches[0] if isinstance(caches, tuple) else caches
    ops.reset_launch_counts()
    got = _block_steps(card, cfg, x.to(dev), {k: v.to(dev) if v.dim() > 1 else v.clone()
                                              for k, v in caches.items()}, 2)
    if kind == "attn_moe":
        assert ops.LAUNCHES["grouped_matmul_simt"] == 3 * 3 and ops.LAUNCHES["argsort"] == 3
    want = _block_steps(host, cfg, x, caches, 2)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-2.7b", "zamba2-2.7b",
                                  "qwen2-vl-2b", "hubert-xlarge"])
def test_family_serve_on_the_card_matches_cpu(dev, arch):
    """Each new family's smoke config in float32 (deepseek-v3 through the
    MoE kernels): the card and the CPU on the same weights, the CPU run
    teacher-forced with the card's tokens; qwen2-vl and hubert from (B, S,
    D) embeddings."""
    cfg = get_config(arch, smoke=True)
    card, host = _card_and_host(dev, cfg, 7)
    gen = torch.Generator().manual_seed(7)
    prompts = (torch.randn((2, 32, cfg.d_model), generator=gen) if cfg.frontend_stub
               else torch.randint(0, cfg.vocab, (2, 32), generator=gen))
    ops.reset_launch_counts()
    a = generate(card, cfg, prompts, gen=5, max_len=64, keep_logits=True)
    if cfg.moe is not None:
        moe_layers = cfg.n_layers - cfg.moe.first_k_dense
        assert ops.LAUNCHES["argsort"] == moe_layers * 5
    b = generate(host, cfg, prompts, gen=5, max_len=64, force=a.tokens[:, :-1],
                 keep_logits=True)
    np.testing.assert_allclose(a.logits, b.logits, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    if cfg.family == "encoder":  # the forward alone, non-causal
        np.testing.assert_allclose(M.forward(card, cfg, prompts)[0].cpu().numpy(),
                                   M.forward(host, cfg, prompts)[0].numpy(),
                                   rtol=1e-3, atol=1e-3)


def _mesh_ranks(tmp_path, device: str, names, world: int = 2) -> dict:
    """Run ``names`` (cases of ``tests/_torch_shard_cases.py``) on ``world``
    spawned ranks joined over gloo on ``device``: {name: [rank results]}."""
    import _torch_shard_cases as cases

    ctx = torch.multiprocessing.get_context("spawn")
    tasks = [ctx.Queue() for _ in range(world)]
    results = ctx.Queue()
    procs = [ctx.Process(target=cases.rank_main, daemon=True,
                         args=(r, world, str(tmp_path / f"rdv_{device}"), device, tasks[r],
                               results)) for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for name in names:
            for q in tasks:
                q.put(name)
            got = {}
            for _ in range(world):
                rank, n, status, payload = results.get(timeout=300)
                assert status == "ok", payload
                got[rank] = payload
            out[name] = [got[r] for r in range(world)]
    finally:
        for q in tasks:
            q.put(None)
        for p in procs:
            p.join(timeout=60)
    return out


def test_gloo_mesh_on_the_card_matches_cpu_ranks(dev, tmp_path):
    """A 2-rank gloo mesh on cuda:0 against the same mesh of CPU ranks: the
    one-shot mesh pipeline (both key widths), its exchange retry, the
    exchange at edge geometry and the distributed group-by give equal rows,
    shard by shard, and equal ``SpillStats``."""
    names = ("oneshot-rs-uint32-w2", "oneshot-early_agg-uint64-w2", "retry-w2",
             "exchange-edge-w2", "groupby-w2")
    card = _mesh_ranks(tmp_path, "cuda", names)
    cpu = _mesh_ranks(tmp_path, "cpu", names)
    for name in names:
        for r, (a, b) in enumerate(zip(card[name], cpu[name])):
            assert sorted(a) == sorted(b), name
            for entry, want in b.items():
                got = a[entry]
                if not isinstance(want, dict) or not all(isinstance(v, np.ndarray)
                                                         for v in want.values()):
                    assert got == want, (name, r, entry)
                    continue
                for f, w in want.items():
                    if w.dtype.kind == "f":  # normal payloads: sums in another order
                        np.testing.assert_allclose(got[f], w, rtol=1e-5, atol=1e-5)
                    else:
                        np.testing.assert_array_equal(got[f], w, err_msg=f"{name} {entry}")


def test_ep_block_on_the_card_matches_plain(dev, tmp_path):
    """Two ranks share the card over gloo on mesh (1, 2): the sorted_ep
    block of the smoke config, float32 forward and backward, the kernels
    (the argsort, the grouped matmul and its backward) against the plain
    versions on the same inputs (rtol/atol 1e-5; gradients within 1e-4 of
    each leaf's largest magnitude); a bfloat16 forward on the tensor-core
    grouped matmul."""
    import _torch_ep_cases as cases

    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=cases.card_rank_main, daemon=True,
                         args=(r, 2, str(tmp_path / "rdv"), q)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    for r, res in got.items():
        assert isinstance(res, dict), res
        card, plain = res["float32 cuda"], res["float32 torch"]
        np.testing.assert_allclose(card["y"], plain["y"], rtol=1e-5, atol=1e-5)
        assert card["aux"] == pytest.approx(plain["aux"], rel=1e-6)
        for leaf in ("dx", "g_wi", "g_wg", "g_wo", "g_router"):
            scale = np.abs(plain[leaf]).max()
            assert np.abs(card[leaf] - plain[leaf]).max() <= 1e-4 * scale, (r, leaf)
        assert card["launches"]["argsort"] > 0 and card["launches"]["grouped_matmul_bwd"] > 0
        assert plain["launches"]["argsort"] == 0
        bf16 = res["bfloat16 cuda"]["launches"]
        assert bf16["grouped_matmul"] > 0 and bf16["grouped_matmul_simt"] == 0
        assert np.isfinite(res["bfloat16 cuda"]["y"]).all()


def test_sharded_train_step_on_the_card_matches_plain(dev, tmp_path):
    """Two ranks share the card over gloo: one float32 sharded train step
    of the qwen3-moe smoke config (every leaf and moment sharded by the
    logical-axis rules, ``sorted_ep``) on meshes (2, 1) and (1, 2), the
    kernels against the plain versions from the same draw and batch: the
    loss within rtol 1e-5, the gradient norm within rtol 1e-4, and each
    shard of a parameter and of both AdamW moments (which hold the clipped
    gradient, where the warmup's first update is below the parameters'
    bound) within 1e-3 of its largest magnitude; the argsort and the
    grouped matmul (forward and backward) launched."""
    import _torch_sharding_cases as cases

    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=cases.card_rank_main, daemon=True,
                         args=(r, 2, str(tmp_path / "rdv"), q)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    for r, res in got.items():
        assert isinstance(res, dict), res
        for shape in ("(2, 1)", "(1, 2)"):
            card, plain = res[f"{shape} cuda"], res[f"{shape} torch"]
            assert card["loss"] == pytest.approx(plain["loss"], rel=1e-5)
            assert card["grad_norm"] == pytest.approx(plain["grad_norm"], rel=1e-4)
            for field in ("params", "m", "v"):
                for n, want in plain[field].items():
                    scale = max(np.abs(want).max(), 1e-12)
                    err = np.abs(card[field][n] - want).max()
                    assert err <= 1e-3 * scale, (r, shape, field, n)
            launches = card["launches"]
            assert launches["argsort"] > 0 and launches["grouped_matmul_bwd"] > 0, launches
            assert plain["launches"]["argsort"] == 0


def test_sharded_serve_on_the_card_matches_plain_and_one_process(dev, tmp_path):
    """Two ranks share the card over gloo on (1, 2): the qwen3-moe smoke
    config in float32 served through ``generate(mesh=)`` (every leaf
    sharded, ``sorted_ep``, each rank's half of the KV heads), teacher-forced
    for a prefill and two decode steps: the kernels against the plain
    versions and against one process from the same draw, logits within
    rtol/atol 1e-3, the argsort and the grouped matmul launched."""
    import _torch_sharded_serve_cases as cases

    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=cases.card_rank_main, daemon=True,
                         args=(r, 2, str(tmp_path / "rdv"), q)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    for r, res in got.items():
        assert isinstance(res, dict), res
        card, plain = res["cuda"], res["torch"]
        np.testing.assert_allclose(card["logits"], plain["logits"], rtol=1e-3, atol=1e-3)
        assert card["launches"]["argsort"] > 0 and card["launches"]["grouped_matmul_simt"] > 0
        assert plain["launches"]["argsort"] == 0
        assert np.array_equal(card["logits"], got[0]["cuda"]["logits"])  # alike on every rank
    np.testing.assert_allclose(got[0]["cuda"]["logits"], got[0]["one process"]["logits"],
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(8, 16, 64, 48), (4, 24, 128, 256), (3, 13, 200, 136)])
def test_grouped_matmul_backward_on_the_card_matches_plain(dev, e, c, d, f, dtype):
    """The kernel's own backward (dX and dW, two more launches of the
    kernel) against the plain version's autograd gradients: within
    ``gmm_error``'s bound of the float32 products, each product on the
    variant its dtype and widths call for (dW's inner width is C: bfloat16
    at C = 13 runs it on the CUDA cores)."""
    gen = torch.Generator(device=dev).manual_seed(e * c + d + f)
    x = torch.randn((e * c, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((e, d, f), generator=gen, device=dev) / np.sqrt(d)).to(dtype)
    dy = torch.randn((e * c, f), generator=gen, device=dev).to(dtype)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    ops.reset_launch_counts()
    dx, dw = torch.autograd.grad(ops.moe_grouped_matmul(xg, wg, capacity=c), (xg, wg), dy)
    torch.cuda.synchronize()
    # forward (d -> f at c), dX (f -> d at c), dW (c -> f at d)
    variants = [grouped_matmul.variant(dtype, *dims)[0] for dims in ((d, f, c), (f, d, c),
                                                                     (c, f, d))]
    assert ops.LAUNCHES["grouped_matmul"] == variants.count("wgmma")
    assert ops.LAUNCHES["grouped_matmul_simt"] == variants.count("simt")
    assert ops.LAUNCHES["grouped_matmul_bwd"] == 2
    if dtype == torch.bfloat16 and c % 8 == 0:
        assert variants == ["wgmma"] * 3
    assert dx.dtype == dw.dtype == dtype
    assert gmm_error(dx, dy, w.transpose(1, 2).contiguous(), c) <= 1.0
    xt = x.view(e, c, d).transpose(1, 2).contiguous().view(e * d, c)
    assert gmm_error(dw.reshape(e * d, f), xt, dy.view(e, c, f), d) <= 1.0
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    pdx, pdw = torch.autograd.grad(grouped_matmul.grouped_matmul_plain(xp, wp, capacity=c),
                                   (xp, wp), dy)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), pdw.float(), rtol=tol, atol=tol)


def test_train_steps_on_the_card_match_cpu(dev):
    """qwen3-moe's and deepseek-v3's smoke configs (float32), three train
    steps on the card (the kernels, their backward included) and on the
    CPU (the plain versions) from the same weights and batch: losses within
    rtol 1e-4, parameters within 1e-3 of each leaf's largest magnitude."""
    import copy

    from repro_torch.data import DataLoader
    from repro_torch.launch import steps as ST

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v3-671b"):
        cfg = get_config(arch, smoke=True)
        step, init_state, _ = ST.make_train_step(cfg, lr=5e-3)
        cpu = init_state(torch.Generator().manual_seed(3))
        card = ST.TrainState(copy.deepcopy(cpu.params).to(dev),
                             {k: v.to(dev) for k, v in cpu.opt_m.items()},
                             {k: v.to(dev) for k, v in cpu.opt_v.items()}, 0)
        batch = DataLoader(cfg.vocab, 4, 64, seed=3).next()
        ops.reset_launch_counts()
        for _ in range(3):
            card, a = step(card, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            cpu, b = step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-4)
        assert ops.LAUNCHES["grouped_matmul_bwd"] > 0 and ops.LAUNCHES["argsort"] > 0
        host = {n: t.detach() for n, t in cpu.params.named_parameters()}
        for n, t in card.params.named_parameters():
            bound = 1e-3 * max(float(host[n].abs().max()), 1e-6)
            assert float((t.detach().cpu() - host[n]).abs().max()) <= bound, n


def test_train_driver_resumes_bit_exactly_on_the_card(dev, tmp_path):
    from repro_torch.launch import train as TR

    kw = dict(smoke=True, batch=2, seq=32, log_every=100, device="cuda")
    full = TR.train("qwen3-moe-30b-a3b", steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    TR.train("qwen3-moe-30b-a3b", steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    rest = TR.train("qwen3-moe-30b-a3b", steps=6, ckpt_dir=str(tmp_path / "b"), resume=True,
                    **kw)
    assert rest == full[3:]
    with np.load(tmp_path / "a" / "step_00000006" / "shard_p0.npz") as a, \
            np.load(tmp_path / "b" / "step_00000006" / "shard_p0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

"""The CUDA kernels held against their plain versions on the card, and the
port's pipeline and MoE serve path on the card against their plain CPU
runs.  Every test needs
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
                            "merge_absorb_bitonic": 1}


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

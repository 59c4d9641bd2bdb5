"""The port's adaptive streaming held against the JAX package's.

Mirrors the single-device cases of tests/test_adaptive.py.  The governor
(:mod:`repro_torch.core.adaptive`) is pure Python in both packages, so
every decision path (``start``, ``hold``, ``hysteresis``,
``small_window``, ``switch``) runs live through both with injected
constants and must give the same arms and events.  The engine cases
(phase-change and Zipf streams through ``policy="adaptive"``, the
streamed front door's default, the finalize and snapshot retries) are
held against the reference's stored results
(``tests/data/torch_stream_reference.npz``, see tests/test_torch_stream.py):
states whole, ``SpillStats`` with the observation block exactly,
``policy_events``, the governor's events and the arm of every chunk.
"""
import logging

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import pipeline as j_pipe
from repro.core.adaptive import GovernorConfig as JGovernorConfig
from repro.core.adaptive import Observation as JObservation
from repro.core.adaptive import PolicyGovernor as JPolicyGovernor
from repro.core.types import ExecConfig as JExecConfig
from repro_torch.core import adaptive, cost_model, pipeline
from repro_torch.core.adaptive import ARMS, GovernorConfig, Observation, PolicyGovernor
from repro_torch.core.operators import validate_against_oracle
from repro_torch.core.types import ExecConfig, MergeOverflowError
from test_torch_baselines import assert_same, one_torch_thread  # noqa: F401  (autouse)
from test_torch_stream import _reference_x64_scope, roundtrip, stored  # noqa: F401

CFG = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)
N = 4096


def make_constants(*, traditional=100.0, early=150.0, early_dup=None, rs=400.0, sort=30.0,
                   merge=50.0, spill=10.0) -> dict:
    """A schema-complete constants entry with injected per-policy costs
    (tests/test_adaptive.py's)."""
    absorb = {"traditional": traditional, "inrun_dedup": traditional + 20,
              "early_agg": early, "rs": rs}
    absorb_dup = dict(absorb)
    if early_dup is not None:
        absorb_dup["early_agg"] = early_dup
    return {"schema_version": cost_model.COST_SCHEMA_VERSION, "absorb_row_ns": absorb,
            "absorb_dup_row_ns": absorb_dup, "sort_row_ns": sort, "merge_row_ns": merge,
            "hash_probe_row_ns": 80.0, "spill_write_row_ns": spill,
            "meta": {"backend": "test", "generated_by": "tests"}}


FAVOR_TRAD = make_constants(traditional=100.0, early=400.0, rs=900.0)
FAVOR_EARLY = make_constants(traditional=400.0, early=100.0, rs=900.0)
# crossover at d = 0.3125: traditional below, early_agg above
CROSSOVER = make_constants(traditional=100.0, early=150.0, early_dup=50.0, rs=900.0,
                           merge=50.0, spill=10.0)
CLOSE = make_constants(traditional=95.0, early=100.0, rs=900.0, merge=0.0, spill=0.0, sort=0.0)


# ---------------------------------------------------------------------------
# the governor, live through both packages
# ---------------------------------------------------------------------------


def _govs(constants, **kw):
    """The port's governor and the reference's, configured alike."""
    return (PolicyGovernor(ExecConfig(**CFG), config=GovernorConfig(constants=constants, **kw)),
            JPolicyGovernor(JExecConfig(**CFG), config=JGovernorConfig(constants=constants, **kw)))


def _decide(govs, rows, dups, current, slots=1):
    """One decision of each governor on the same observation; both must
    pick the same arm.  Returns it."""
    mine, ref = govs
    got = mine.decide(Observation(rows, dups, 0, 0, slots), current=current)
    want = ref.decide(JObservation(rows, dups, 0, 0, slots), current=current)
    assert got == want and mine.events == ref.events
    return got


def test_governor_start_paths():
    for constants, kw, est in ((FAVOR_TRAD, {}, None), (FAVOR_EARLY, {}, None),
                               (FAVOR_TRAD, dict(start="rs"), None), (CROSSOVER, {}, 10_000)):
        mine, ref = _govs(constants, **kw)
        assert mine.start_arm(output_estimate=est) == ref.start_arm(output_estimate=est)
        assert mine.events == ref.events and mine.events[-1]["path"] == "start"
    assert _govs(FAVOR_TRAD)[0].start_arm() == "traditional"
    assert _govs(FAVOR_EARLY)[0].start_arm() == "early_agg"


def test_governor_hold_and_switch_paths():
    govs = _govs(FAVOR_TRAD, min_window_rows=64)
    assert _decide(govs, 1024, 0, "traditional") == "traditional"
    assert govs[0].events[-1]["path"] == "hold"
    govs = _govs(FAVOR_TRAD, min_window_rows=64)
    assert _decide(govs, 1024, 0, "rs") == "traditional"
    ev = govs[0].events[-1]
    assert ev["path"] == "switch" and ev["from"] == "rs" and ev["advantage"] > 0.5


def test_governor_small_window_path():
    govs = _govs(FAVOR_TRAD, min_window_rows=10_000)
    assert _decide(govs, 1024, 0, "rs") == "rs"
    assert govs[0].events[-1]["path"] == "small_window"
    # the window is measured since the last decision, not the stream's start
    govs = _govs(FAVOR_TRAD, min_window_rows=512)
    _decide(govs, 1024, 0, "rs")
    assert _decide(govs, 1100, 0, "rs") == "rs"
    assert govs[0].events[-1]["path"] == "small_window"


def test_governor_hysteresis_path():
    govs = _govs(CLOSE, min_window_rows=64, hysteresis=0.5)
    assert _decide(govs, 1024, 0, "early_agg") == "early_agg"
    ev = govs[0].events[-1]
    assert ev["path"] == "hysteresis" and ev["challenger"] == "traditional"
    assert 0.0 < ev["advantage"] < 0.5


def test_governor_windowed_dup_rate_crosses():
    govs = _govs(CROSSOVER, min_window_rows=64, hysteresis=0.05)
    assert _decide(govs, 1000, 100, "traditional") == "traditional"
    assert _decide(govs, 2000, 900, "traditional") == "early_agg"
    assert govs[0].events[-1]["path"] == "switch"
    assert Observation(10, 4, 0, 0, 0).duplicate_rate == JObservation(10, 4, 0, 0, 0).duplicate_rate
    assert Observation(0, 0, 0, 0, 0).duplicate_rate == 0.0


def test_governor_config_validation():
    for cls in (GovernorConfig, JGovernorConfig):
        with pytest.raises(ValueError, match="interval_chunks"):
            cls(interval_chunks=0)
        with pytest.raises(ValueError, match="arms"):
            cls(arms=("early_agg", "hash"))
        with pytest.raises(ValueError, match="start"):
            cls(start="traditional", arms=("early_agg", "rs"))
    assert ARMS == pipeline.ADAPTIVE_ARMS == j_pipe.ADAPTIVE_ARMS
    assert pipeline.STREAM_POLICIES == j_pipe.STREAM_POLICIES
    # a dict config, and the committed constants by torch device type
    gov = PolicyGovernor(ExecConfig(**CFG), config={"interval_chunks": 2, "backend": "cuda"})
    assert gov.interval == 2 and gov._constants == cost_model.load_cost_constants("cuda")
    assert gov._constants["meta"]["backend"] == "cuda"


def test_governor_refused_where_it_cannot_steer():
    """A governor that would never steer is refused at construction; an
    adaptive stream needs M divisible by B; neither the adaptive policy nor
    a governor composes with ``mesh=`` (ValueError, as in the
    reference)."""
    gov = PolicyGovernor(ExecConfig(**CFG))
    with pytest.raises(ValueError, match="fixed policy 'rs'"):
        pipeline.StreamingAggregator(ExecConfig(**CFG), policy="rs", governor=gov, device="cpu")
    odd = ExecConfig(memory_rows=192, page_rows=32, fanin=4, batch_rows=128)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.StreamingAggregator(odd, policy="adaptive", device="cpu")
    from repro_torch.distributed import sharding

    mesh = sharding.data_mesh("data", device="cpu")
    with pytest.raises(ValueError, match="does not compose with mesh"):
        pipeline.StreamingAggregator(ExecConfig(**CFG), policy="adaptive", mesh=mesh,
                                     device="cpu")
    with pytest.raises(ValueError, match="does not compose with mesh"):
        pipeline.StreamingAggregator(ExecConfig(**CFG), policy="rs", governor=gov, mesh=mesh,
                                     device="cpu")


# ---------------------------------------------------------------------------
# the engine: stored results of the reference
# ---------------------------------------------------------------------------

SCENARIOS = {
    # name: (constants, governor keywords, key order, key dtype, the path that must show)
    "wrong_start_recovers": (FAVOR_TRAD, dict(start="rs"), "uniq->dup", "uint32", "switch"),
    "hold_steady": (FAVOR_TRAD, dict(start="traditional"), "uniq->dup", "uint32", "hold"),
    "crossover_switch": (CROSSOVER, dict(start="traditional", hysteresis=0.05), "uniq->dup",
                         "uint32", "switch"),
    "crossover_switch_u64": (CROSSOVER, dict(start="traditional", hysteresis=0.05),
                             "uniq->dup", "uint64", "switch"),
    "reverse_crossover": (CROSSOVER, dict(hysteresis=0.05), "dup->uniq", "uint32", "switch"),
    "hysteresis_blocks_flap": (CLOSE, dict(start="early_agg", hysteresis=0.5), "uniq->dup",
                               "uint32", "hysteresis"),
    "small_window_holds": (FAVOR_TRAD, dict(start="rs", interval_chunks=1,
                                            min_window_rows=10**6), "uniq->dup", "uint32",
                           "small_window"),
}
CASES: dict[str, dict] = {f"adaptive-{s}": dict(kind="scenario", scenario=s) for s in SCENARIOS}
CASES["adaptive-zipf_default_governor"] = dict(kind="zipf")
CASES["adaptive-finalize_retry"] = dict(kind="retry", entry="finalize")
CASES["adaptive-snapshot_retry"] = dict(kind="retry", entry="snapshot")
CASES["adaptive-front_door"] = dict(kind="front_door")
STORED_CASES = tuple(CASES)
LIVE_CASE = "adaptive-hold_steady"


def _rng(name):
    return np.random.default_rng(100 + sorted(CASES).index(name))


def phase_keys(rng, order="uniq->dup", n=N, key_dtype="uint32"):
    """A unique-heavy half (keys over 2^31) and a duplicate-heavy half
    (keys in [1, 24)), in ``order``; u64 keys move to the upper half of
    the domain."""
    h = n // 2
    parts = {"uniq": rng.integers(1, 2**31, h), "dup": rng.integers(1, 24, h)}
    a, b = order.split("->")
    keys = np.concatenate([parts[a], parts[b]]).astype(np.uint64)
    if key_dtype == "uint64":
        return keys * np.uint64(3) + np.uint64(1 << 63)
    return keys.astype(np.uint32)


def zipf_keys(rng, n=N, a=1.4, domain=4096):
    return ((rng.zipf(a, n) - 1) % domain + 1).astype(np.uint32)


def _stream(keys, pay, chunk=256):
    for i in range(0, len(keys), chunk):
        yield keys[i:i + chunk], None if pay is None else pay[i:i + chunk]


def _run_adaptive(ref, keys, pay, gkw, *, chunk=256):
    """One adaptive stream: the state, stats, the stream's policy events,
    the governor's events and the arm after each chunk."""
    mod, E, G, P = ((j_pipe, JExecConfig, JGovernorConfig, JPolicyGovernor) if ref
                    else (pipeline, ExecConfig, GovernorConfig, PolicyGovernor))
    kw = dict(backend="xla") if ref else dict(device="cpu")
    gov = None if gkw is None else P(E(**CFG), config=G(**gkw))
    agg = mod.StreamingAggregator(E(**CFG), policy="adaptive", key_dtype=keys.dtype,
                                  width=0 if pay is None else pay.shape[1], governor=gov, **kw)
    arms = []
    for k, p in _stream(keys, pay, chunk):
        agg.absorb(k, p)
        arms.append(agg.arm)
    state, stats = agg.finalize()
    return dict(state=state, stats=stats.as_dict(), policy_events=agg.policy_events,
                governor_events=(gov or agg._governor).events, arms=arms,
                readbacks_paid=agg.readbacks_paid)


def _overflow(ref, rng, entry, n_unique=24):
    """An rs stream of 4 copies of ``n_unique`` keys with a 16-row output:
    the merge overflows and retries once at 32 rows.  The snapshot is
    followed by more input and a finalize that retries too."""
    mod, E = (j_pipe, JExecConfig) if ref else (pipeline, ExecConfig)
    kw = dict(backend="xla") if ref else dict(device="cpu")
    keys = np.repeat(np.arange(n_unique, dtype=np.uint32) + 1, 4)
    rng.shuffle(keys)
    agg = mod.StreamingAggregator(E(**CFG), policy="rs", key_dtype=np.uint32, width=0,
                                  output_rows=16, **kw)
    for k, _ in _stream(keys, None):
        agg.absorb(k, None)
    out = {}
    if entry == "snapshot":
        out["snapshot"], stats = agg.snapshot()
        out["snapshot_stats"] = stats.as_dict()
        agg.absorb(rng.integers(1, 25, 256).astype(np.uint32), None)
    out["final"], stats = agg.finalize()
    out["final_stats"] = stats.as_dict()
    return out


def compute(name: str, *, ref: bool) -> dict:
    c = CASES[name]
    rng = _rng(name)
    if c["kind"] == "scenario":
        constants, gkw, order, kd, _ = SCENARIOS[c["scenario"]]
        keys = phase_keys(rng, order, key_dtype=kd)
        pay = rng.normal(size=(len(keys), 1)).astype(np.float32)
        return _run_adaptive(ref, keys, pay, {"constants": constants, "min_window_rows": 64,
                                              **gkw})
    if c["kind"] == "zipf":
        keys = zipf_keys(rng)
        return _run_adaptive(ref, keys, rng.normal(size=(N, 2)).astype(np.float32), None)
    if c["kind"] == "retry":
        return _overflow(ref, rng, c["entry"])
    keys = zipf_keys(rng, n=2048) % 1000
    pkg = repro if ref else repro_torch
    kw = dict(backend="xla") if ref else dict(device="cpu")
    out = {}
    for label, cfg in (("default", CFG), ("odd", dict(memory_rows=192, page_rows=32, fanin=4,
                                                      batch_rows=128))):
        res = pkg.aggregate(({"k": keys[i:i + 256]} for i in range(0, len(keys), 256)),
                            by=pkg.KeySpec.of(k=10),
                            cfg=(JExecConfig if ref else ExecConfig)(**cfg), **kw)
        out[f"{label}_relation"] = res.relation()
        out[f"{label}_stats"] = res.stats.as_dict()
        out[f"{label}_plan"] = {k: res.plan.get(k) for k in (
            "algorithm", "policy", "streamed", "policy_switches", "readbacks_paid")}
    return out


def port_result(name):
    return roundtrip(name, compute(name, ref=False))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_adaptive_decision_paths_match_reference(scenario):
    """Every decision path through the engine: the reference's state,
    stats (observation block included), policy events, governor events
    and arm of every chunk; the oracle's groups."""
    name = f"adaptive-{scenario}"
    result = compute(name, ref=False)
    got = roundtrip(name, result)
    assert_same(got, stored(name))
    _, _, order, kd, path = SCENARIOS[scenario]
    assert path in {e["path"] for e in got["governor_events"]}
    stats = got["stats"]
    assert stats["readbacks_paid"] == got["readbacks_paid"] > 0
    assert stats["policy_switches"] == len(got["policy_events"])
    assert (stats["policy_switches"] >= 1) == (path == "switch")
    if path == "switch":
        assert set(got["policy_events"][0]) == {"rows_seen", "from", "to", "duplicate_rate"}
    rng = _rng(name)
    keys = phase_keys(rng, order, key_dtype=kd)
    validate_against_oracle(result["state"], keys, rng.normal(size=(len(keys), 1)))


def test_adaptive_zipf_parity_and_default_governor():
    """The committed constants steer the default governor, as in the
    reference."""
    name = "adaptive-zipf_default_governor"
    got = port_result(name)
    assert_same(got, stored(name))
    assert got["stats"]["readbacks_paid"] > 0 and 0.0 <= got["stats"]["duplicate_rate"] <= 1.0


def test_adaptive_switch_changes_the_arm_mid_stream():
    got = port_result("adaptive-crossover_switch")
    assert got["arms"][0] == "traditional" and "early_agg" in got["arms"]
    assert got["stats"]["duplicate_rate"] > 0.2


def test_readback_count_is_stream_over_k():
    """The observation is harvested one boundary behind: a stream of C
    chunks with no switch pays C // k - 1; fixed policies pay none."""
    keys = zipf_keys(np.random.default_rng(3), n=16 * 256)
    for k in (2, 4, 8):
        got = _run_adaptive(False, keys, None, dict(constants=FAVOR_TRAD, interval_chunks=k))
        assert got["readbacks_paid"] == got["stats"]["readbacks_paid"] == 16 // k - 1
        assert got["stats"]["policy_switches"] == 0
    agg = pipeline.StreamingAggregator(ExecConfig(**CFG), policy="rs", device="cpu")
    for k, p in _stream(keys, None):
        agg.absorb(k, p)
    _, stats = agg.finalize()
    assert stats.readbacks_paid == 0 and stats.policy_switches == 0


@pytest.mark.parametrize("entry", ["finalize", "snapshot"])
def test_retry_once_at_next_pow2(entry, caplog):
    """An output of 24 groups in 16 rows: finalize (and a snapshot, which
    leaves the engine to ingest more) retries once at 32 rows, with the
    reference's result."""
    name = f"adaptive-{entry}_retry"
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.pipeline"):
        got = port_result(name)
    assert any("retrying once" in r.message for r in caplog.records)
    assert_same(got, stored(name))
    assert got["final"]["keys"].shape == (32,)


def test_retry_that_still_overflows_raises():
    agg = pipeline.StreamingAggregator(ExecConfig(**CFG), policy="rs", output_rows=16,
                                       device="cpu")
    keys = np.repeat(np.arange(512, dtype=np.uint32) + 1, 4)
    for k, _ in _stream(keys, None):
        agg.absorb(k, None)
    with pytest.raises(MergeOverflowError, match="snapshot"):
        agg.snapshot()
    with pytest.raises(MergeOverflowError, match="finalize"):
        agg.finalize()


def test_streamed_default_is_adaptive():
    """``algorithm="auto"`` on column batches runs adaptive, and ``rs`` where
    M is not a multiple of B, with the reference's relations and plans."""
    name = "adaptive-front_door"
    got = port_result(name)
    assert_same(got, stored(name))
    assert got["default_plan"]["algorithm"] == got["default_plan"]["policy"] == "adaptive"
    assert got["odd_plan"]["algorithm"] == "insort" and got["odd_plan"]["policy"] == "rs"


def test_adaptive_algorithm_validation():
    keys = np.arange(64, dtype=np.uint32)
    odd = dict(memory_rows=192, page_rows=32, fanin=4, batch_rows=128)
    for pkg, E, kw in ((repro_torch, ExecConfig, dict(device="cpu")),
                       (repro, JExecConfig, {})):
        with pytest.raises(ValueError, match="streamed"):
            pkg.aggregate({"k": keys}, by=pkg.KeySpec.of(k=10), algorithm="adaptive", **kw)
        with pytest.raises(ValueError, match="divisible"):
            pkg.aggregate(iter([{"k": keys}]), by=pkg.KeySpec.of(k=10), algorithm="adaptive",
                          cfg=E(**odd), **kw)


def test_adaptive_observation_block_is_the_engines():
    """``observe()`` reads the engine's counters: valid rows absorbed,
    duplicates, rows spilled, resident table rows and run slots used."""
    agg = pipeline.StreamingAggregator(ExecConfig(**CFG), policy="adaptive",
                                       governor=dict(constants=FAVOR_EARLY), device="cpu")
    assert agg.observe() == Observation(0, 0, 0, 0, 0) and agg.readbacks_paid == 0
    keys = np.concatenate([np.arange(1, 101), np.arange(1, 101)]).astype(np.uint32)
    agg.absorb(keys)
    assert agg.arm == "early_agg" and isinstance(agg._governor, adaptive.PolicyGovernor)
    assert agg.observe() == Observation(200, 100, 0, 100, 0)
    assert agg.readbacks_paid == 1


def test_stored_reference_is_the_reference_output():
    assert_same(roundtrip(LIVE_CASE, compute(LIVE_CASE, ref=True)), stored(LIVE_CASE))

"""The port's one-shot device pipeline held against the JAX package's.

Same inputs through ``repro.core.pipeline.insort_aggregate_device`` (rs
policy, ``"xla"`` backend) and the port's counterpart on the CPU: keys,
counts and ``SpillStats.as_dict()`` must be equal, sums agree within rtol
1e-4.  Covered: u32 spilling through pre-merge levels, u64 spilling with
keys in both halves of the u64 domain (the mapped frontier zero), and the
in-memory case N <= M.  The reference's results are stored in
``tests/data/torch_stream_reference.npz`` (``STORED_CASES``, written by
``scripts/make_torch_stream_reference.py``); ``LIVE`` is recomputed live
and must equal its stored result too.
"""
import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core.types import ExecConfig as JExecConfig
from repro_torch.core import merge as merge_mod
from repro_torch.core import pipeline, run_generation
from repro_torch.core.insort import insort_aggregate
from repro_torch.core.operators import validate_against_oracle
from repro_torch.core.types import (
    INT64_MIN,
    SYNCS,
    ExecConfig,
    empty_state,
    keys_to_torch,
    rows_to_state,
    state_to_numpy,
)
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_stream import stored

CFG = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)
CASES = {
    # name: (n, key dtype, key domain, output_estimate)
    "u32_premerge": (4000, np.uint32, 1200, 1 << 12),
    "u64_spill": (4000, np.uint64, 1200, None),
    "u32_in_memory": (200, np.uint32, 150, None),
}
STORED_CASES = tuple(f"pipeline-{name}" for name in CASES)
LIVE = "u32_in_memory"


@pytest.fixture(autouse=True)
def _reference_x64_scope(monkeypatch):
    """The reference scopes its uint64 work with
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; lend it the old name for one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def _inputs(name):
    n, kd, domain, est = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    keys = rng.integers(0, domain, n).astype(kd)
    if kd == np.uint64:  # spread over both halves of the u64 domain
        keys = keys * np.uint64(0xF000000000000000 // domain) + np.uint64(3)
        assert (keys >= np.uint64(1 << 63)).any() and (keys < np.uint64(1 << 63)).any()
    pay = rng.normal(size=(n, 1)).astype(np.float32)
    return keys, pay, est


def compute(case: str, *, ref: bool = True) -> dict:
    """The JAX pipeline's result of stored case ``pipeline-<name>``."""
    keys, pay, est = _inputs(case.removeprefix("pipeline-"))
    state, stats = jpipe.insort_aggregate_device(
        keys, pay, JExecConfig(**CFG), policy="rs", backend="xla", output_estimate=est)
    return dict(state=state, stats=stats.as_dict())


def _reference(name):
    """The JAX pipeline's result: stored, or live for ``LIVE`` (which must
    equal its stored result)."""
    want = stored(f"pipeline-{name}")
    if name == LIVE:
        live = compute(f"pipeline-{name}")
        for f, arr in want["state"].items():
            np.testing.assert_allclose(np.asarray(getattr(live["state"], f)), arr, rtol=1e-4,
                                       atol=1e-5, err_msg=f)
        assert live["stats"] == want["stats"]
    return want["state"], want["stats"]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rs_pipeline_matches_reference(name, backend):
    """``backend="cuda"`` on CPU tensors runs through the kernel wrappers,
    which take their plain versions there."""
    keys, pay, est = _inputs(name)
    want, want_stats = _reference(name)
    state, stats = pipeline.insort_aggregate_device(
        keys, pay, ExecConfig(**CFG), policy="rs", backend=backend, output_estimate=est,
        device="cpu")
    got = state_to_numpy(state)
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_array_equal(got["count"], want["count"])
    for f in ("sum", "min", "max"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f)
    assert stats.as_dict() == want_stats
    if name == "u32_premerge":
        assert stats.rows_spilled_merge > 0 and stats.merge_levels > 1
    if name == "u32_in_memory":
        assert stats.runs_generated == 0


def test_wide_merge_reads_back_once():
    """The page loop knows its page count from one readback of the run
    lengths and pays no per-page sync."""
    rng = np.random.default_rng(3)
    runs = [np.unique(rng.integers(0, 500, 300)) for _ in range(5)]
    C = 320
    store = empty_state(5 * C, 0, key_dtype=np.uint32, device="cpu")
    store = store.map(lambda x: x.reshape((5, C) + tuple(x.shape[1:])))
    for r, k in enumerate(runs):
        st = rows_to_state(keys_to_torch(k, "cpu"), None, key_dtype=np.uint32)
        for f in ("keys", "count"):
            getattr(store, f)[r, :k.size] = getattr(st, f)
    lens = torch.tensor([k.size for k in runs])
    before = SYNCS["host_syncs"]
    out, emitted, pages, *_ = merge_mod.wide_merge_device(
        store, lens, page_rows=32, index_rows=256, out_capacity=5 * C)
    assert SYNCS["host_syncs"] == before + 1
    assert pages == sum(-(-k.size // 32) for k in runs)
    uk, cnt = np.unique(np.concatenate(runs), return_counts=True)
    got = state_to_numpy(out)
    np.testing.assert_array_equal(got["keys"][:uk.size], uk)
    np.testing.assert_array_equal(got["count"][:uk.size], cnt)
    assert int(emitted) == uk.size


def test_rs_frontier_zero_is_the_mapped_u64_zero():
    """Before any eviction the frontier is the u64 domain's zero, mapped to
    INT64_MIN: every key of the batch, upper half of the domain included,
    joins the open run's partition."""
    keys = np.array([1, 1 << 63, (1 << 64) - 2, 5], dtype=np.uint64)
    batch = rows_to_state(keys_to_torch(np.sort(keys), "cpu"), None, key_dtype=np.uint64)
    table = empty_state(8, 0, key_dtype=np.uint64, device="cpu")
    _, _, frontier, n_ev = run_generation.rs_evict_step(table, 4)
    assert int(frontier) == INT64_MIN and int(n_ev) == 0
    run_t, next_t = run_generation.rs_split_absorb(table, table, frontier, batch,
                                                   backend="torch")
    assert int(run_t.occupancy()) == 4 and int(next_t.occupancy()) == 0


@pytest.mark.parametrize("policy", ["traditional", "inrun_dedup", "early_agg"])
def test_unported_policies_raise(policy):
    """The three policies that raised until the baselines were ported now
    run and give the oracle's groups; an unknown policy still raises."""
    keys = np.arange(10, dtype=np.uint32) % 4
    state, stats = pipeline.insort_aggregate_device(keys, None, policy=policy, device="cpu")
    assert validate_against_oracle(state, keys) and stats.rows_emitted <= keys.size
    with pytest.raises(ValueError, match="unknown policy"):
        pipeline.insort_aggregate_device(keys, None, policy=policy + "x", device="cpu")


def test_host_pipeline_raises():
    """The host loop runs now; the mesh it cannot take raises, as the
    reference's guard does (the mesh needs the device pipeline)."""
    from repro_torch.distributed import sharding

    keys = np.arange(10, dtype=np.uint32) % 4
    state, _ = insort_aggregate(keys, pipeline="host", device="cpu")
    assert validate_against_oracle(state, keys)
    mesh = sharding.data_mesh("data", device="cpu")
    with pytest.raises(ValueError, match="pipeline='device'"):
        insort_aggregate(keys, pipeline="host", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="pipeline='device'"):
        insort_aggregate(keys, use_wide_merge=False, mesh=mesh, device="cpu")


@pytest.mark.parametrize("capacity,dropped", [(6, False), (5, True)])
def test_trim_to_capacity_flags_lost_rows(capacity, dropped):
    keys = np.array([1, 2, 3, 4, 5, 6, 0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32)
    st = rows_to_state(keys_to_torch(keys, "cpu"), None, key_dtype=np.uint32)
    out, flag = merge_mod.trim_to_capacity(st, capacity)
    assert out.capacity == capacity and bool(flag) == dropped

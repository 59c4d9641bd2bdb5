"""The port's mesh paths held against the JAX package's, through real
multi-process gloo collectives on the CPU.

One pool of 4 ranks (spawned processes joined by ``torch.distributed`` over
gloo, rendezvous in a ``file://`` store under the test's temp dir) is
started once per test process; a case of world 2 runs on the sub-mesh of
ranks 0 and 1, a case of world 1 in this process.  Each rank's output must
equal the reference's shard ``r`` (its global array cut into ``world``
shards): keys and counts exactly, float planes within rtol 1e-4,
``SpillStats.as_dict()`` exactly, exchange fields included; relations and
host values equal.  The cases (``tests/_torch_shard_cases.py``) mirror
``tests/test_shard.py``, ``tests/test_distributed.py``'s group-by,
``tests/test_join.py``'s mesh join, ``tests/test_stream.py``'s mesh stream
and ``tests/test_service.py``'s mesh service at their sizes (N = 4,096,
``ExecConfig(256, 32, 4, 64)``), at worlds 1, 2 and 4.

The reference's mesh programs need several host devices and cost XLA
compiles, so ``scripts/make_torch_shard_reference.py`` computes them into
``tests/data/torch_shard_reference.npz`` (``--check`` recomputes them).
The pure functions (``strictify_cuts``, ``_range_of``, the quota helpers,
``fragments_to_store``, ``compact_state``) are held against the reference
live.
"""
import functools
import os
import queue
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_shard_cases as cases
from repro_torch.core import merge as merge_mod
from repro_torch.core.merge_join import compact_state
from repro_torch.core.types import (
    DeviceSpillStats,
    SpillStats,
    keys_to_torch,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.distributed import groupby as gb
from repro_torch.distributed import sharding

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_FILE = ROOT / "tests" / "data" / "torch_shard_reference.npz"
POOL_WORLD = 4
EXCHANGE_FIELDS = ("rows_exchanged", "exchange_quota", "exchange_max_fill", "exchange_retries")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops on one torch thread (a loaded host's intra-op pool
    makes each wait milliseconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _stored():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict:
    arrays = _stored()
    if f"{name}|host" not in arrays.files:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_shard_reference.py")
    return cases.from_arrays(name, arrays)


class Pool:
    """Four CPU ranks joined over gloo, each running the cases it is sent."""

    def __init__(self, tmpdir: Path):
        ctx = torch.multiprocessing.get_context("spawn")
        rdv = str(tmpdir / "rendezvous")
        self.tasks = [ctx.Queue() for _ in range(POOL_WORLD)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=cases.rank_main,
                                  args=(r, POOL_WORLD, rdv, "cpu", self.tasks[r], self.results),
                                  daemon=True) for r in range(POOL_WORLD)]
        for p in self.procs:
            p.start()

    def run(self, name: str) -> list[dict]:
        for q in self.tasks:
            q.put(name)
        got, errors = {}, []
        for _ in range(POOL_WORLD):
            try:
                rank, n, status, payload = self.results.get(timeout=240)
            except queue.Empty:
                pytest.fail(f"{name}: a rank did not answer within 240 s")
            assert n == name
            if status == "error":
                errors.append(f"rank {rank}:\n{payload}")
            elif status == "ok":
                got[rank] = payload
        if errors:
            pytest.fail(f"{name} failed on the mesh:\n" + "\n".join(errors))
        return [got[r] for r in range(len(got))]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = Pool(tmp_path_factory.mktemp("mesh"))
    yield p
    p.close()


def run_case(name: str, pool) -> list[dict]:
    world = cases.CASES[name]["world"]
    if world == 1:
        return [cases.port(name, sharding.data_mesh("data", device="cpu"))]
    return pool.run(name)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def _same_arrays(g, w, what):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def assert_same(got: dict, want: dict, where: str):
    assert sorted(got) == sorted(want), (where, sorted(got), sorted(want))
    for entry, w in want.items():
        g = got[entry]
        what = f"{where} {entry}"
        if isinstance(w, dict) and w and all(isinstance(v, np.ndarray) for v in w.values()):
            assert sorted(g) == sorted(w), what
            for f, wa in w.items():
                if set(w) == set(cases.FIELDS) and wa.dtype.kind != "f":
                    assert np.asarray(g[f]).dtype == wa.dtype, (what, f)
                _same_arrays(g[f], wa, f"{what}.{f}")
        elif isinstance(w, np.ndarray):
            _same_arrays(g, w, what)
        else:
            assert g == w, (what, g, w)


# ---------------------------------------------------------------------------
# every case, rank by rank, against the reference's shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.CASES))
def test_mesh_rank_equals_reference_shard(name, pool):
    world = cases.CASES[name]["world"]
    ranks = run_case(name, pool)
    assert len(ranks) == world
    want_all = stored(name)
    local = [r.pop("local_stats", None) for r in ranks]
    for r, got in enumerate(ranks):
        assert_same(got, cases.shard(want_all, r, world), f"{name} rank {r}")
    kind = cases.CASES[name]["kind"]
    if kind == "oneshot" and world > 1:
        # the mesh's stats are the ranks' one-device stats reduced, but for
        # the exchange's own fields (tests/test_shard.py's _PARITY)
        want = SpillStats.reduce_shards([SpillStats(**{k: v for k, v in d.items()
                                                       if k != "total_spill_rows"})
                                         for d in local]).as_dict()
        got = dict(ranks[0][f"stats_{cases.CASES[name]['policy']}"])
        assert got["rows_exchanged"] > 0 and got["exchange_retries"] == 0
        assert 0 < got["exchange_max_fill"] <= got["exchange_quota"]
        for k in EXCHANGE_FIELDS:
            got.pop(k), want.pop(k)
        assert got == want
    if kind == "zipf":
        # every rank dedups its slice, then puts each surviving row on the
        # wire once: rows_exchanged is the sum of the slices' distinct keys
        keys = cases.inputs(name)["keys"]
        n_loc = keys.size // world
        sent = sum(len(np.unique(keys[i * n_loc:(i + 1) * n_loc])) for i in range(world))
        assert ranks[0][f"stats_{cases.CASES[name]['policy']}"]["rows_exchanged"] == sent


# ---------------------------------------------------------------------------
# the pure functions, against the live reference
# ---------------------------------------------------------------------------


@pytest.fixture
def _reference_x64_scope(monkeypatch):
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                            raising=False)


@pytest.mark.parametrize("kd", (np.uint32, np.uint64))
def test_strictify_cuts_matches_reference(kd, _reference_x64_scope):
    """Repeated, already strict, top-clamped and domain-top cuts
    (tests/test_shard.py:296), on both key widths, against the live
    reference."""
    import jax.numpy as jnp

    from repro.core.types import key_dtype_context
    from repro.distributed.groupby import strictify_cuts as j_strictify

    top = int(np.iinfo(kd).max) - 1
    for raw in ([7, 7, 7, 9, 9, 3], [5, 100, 2000], [top, top, top], [top - 1, top - 1, 3],
                [0, 0, 0, 0], [top - 2, top, top - 5], [1]):
        cuts = np.array(raw, dtype=kd)
        with key_dtype_context(kd):
            want = np.asarray(j_strictify(jnp.asarray(cuts)))
        got = gb.strictify_cuts(keys_to_torch(cuts, "cpu"), np.dtype(kd))
        np.testing.assert_array_equal(state_to_numpy_keys(got, kd), want, err_msg=str(raw))
        assert want.max() <= top


def state_to_numpy_keys(t, kd):
    from repro_torch.core.types import keys_to_numpy

    return keys_to_numpy(t, np.dtype(kd))


@pytest.mark.parametrize("kd", (np.uint32, np.uint64))
def test_range_of_matches_reference(kd, _reference_x64_scope):
    import jax.numpy as jnp

    from repro.core.types import key_dtype_context
    from repro.distributed.groupby import _range_of as j_range_of

    info = np.iinfo(kd)
    rng = np.random.default_rng(5)
    keys = np.concatenate([rng.integers(0, info.max, 200, dtype=kd, endpoint=True),
                           np.array([0, 1, info.max // 2, info.max // 2 + 1, info.max - 1,
                                     info.max], dtype=kd)])
    # world 1 overflows the reference's span (2^bits // 1 in the key dtype);
    # every key is rank 0's
    assert not gb._range_of(keys_to_torch(keys, "cpu"), 1, np.dtype(kd)).any()
    for world in (2, 3, 4, 7):
        with key_dtype_context(kd):
            want = np.asarray(j_range_of(jnp.asarray(keys), world))
        got = gb._range_of(keys_to_torch(keys, "cpu"), world, np.dtype(kd)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"world {world}")


def test_quota_helpers_match_reference():
    """default_exchange_quota, exchange_page_rows and
    exchange_footprint_rows are the reference's numbers; the footprint at
    a fixed capacity a rank stays flat in the world
    (tests/test_shard.py:168)."""
    from repro.distributed import groupby as jgb

    for cap in (1, 7, 64, 1000, 4096, 1 << 20, 15_000_000):
        for world in (1, 2, 3, 4, 8, 32):
            q = gb.default_exchange_quota(cap, world)
            assert q == jgb.default_exchange_quota(cap, world), (cap, world)
            for page in (None, 1, 32, 100, 1 << 14):
                assert gb.exchange_page_rows(q, page) == jgb.exchange_page_rows(q, page)
                assert (gb.exchange_footprint_rows(world, q, page)
                        == jgb.exchange_footprint_rows(world, q, page))
    foot = {w: gb.exchange_footprint_rows(w, gb.default_exchange_quota(2048, w), 32)
            for w in (8, 32)}
    assert foot[32] / foot[8] <= 1.3


def test_fragments_to_store_and_compact_state_match_reference():
    import jax.numpy as jnp

    from repro.core import merge as jmerge
    from repro.core.merge_join import compact_state as j_compact
    from repro.core.types import AggState as JAggState

    rng = np.random.default_rng(11)
    world, quota = 4, 8
    keys = np.full(world * quota, 0xFFFFFFFF, np.uint32)
    for i, n in enumerate((3, 0, 8, 5)):
        keys[i * quota:i * quota + n] = np.sort(rng.choice(1000, n, replace=False))
    arrays = dict(keys=keys, count=(keys != 0xFFFFFFFF).astype(np.int32),
                  sum=rng.normal(size=(world * quota, 2)).astype(np.float32),
                  min=rng.normal(size=(world * quota, 2)).astype(np.float32),
                  max=rng.normal(size=(world * quota, 0)).astype(np.float32))
    jst = JAggState(**{f: jnp.asarray(a) for f, a in arrays.items()})
    st = state_from_numpy(arrays, device="cpu")
    jstore, jlens = jmerge.fragments_to_store(jst, world, quota)
    store, lens = merge_mod.fragments_to_store(st, world, quota)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    got = state_to_numpy(store)
    for f in cases.FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jstore, f)), err_msg=f)
    got = state_to_numpy(compact_state(st))
    want = j_compact(jst)
    for f in cases.FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------------
# the mesh object, the backends and the launcher
# ---------------------------------------------------------------------------


def test_local_slice_is_the_reference_sharding():
    """Rank r's slice is rows [r·n_loc, (r+1)·n_loc) of the input padded
    with EMPTY (keys) or zeros to world·n_loc rows, as the reference's
    ``_pad_flat`` + ``P(axis)`` place them."""
    for n, world in ((4096, 4), (4001, 4), (5, 4), (3, 4), (0, 2), (7, 1)):
        keys = np.arange(n, dtype=np.uint32)
        pay = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
        n_loc = -(-n // world)
        pk = np.concatenate([keys, np.full(world * n_loc - n, 0xFFFFFFFF, np.uint32)])
        pp = np.concatenate([pay, np.zeros((world * n_loc - n, 2), np.float32)])
        for r in range(world):
            mesh = sharding.Mesh(axis="data", world=world, rank=r, device=torch.device("cpu"))
            np.testing.assert_array_equal(sharding.local_slice(keys, mesh),
                                          pk[r * n_loc:(r + 1) * n_loc])
            np.testing.assert_array_equal(sharding.local_slice(pay, mesh),
                                          pp[r * n_loc:(r + 1) * n_loc])
            assert len(sharding.local_slice(keys, mesh, pad=False)) <= n_loc


def test_backend_is_explicit_and_nccl_needs_a_card_a_rank():
    with pytest.raises(ValueError, match="collective backend"):
        sharding.init_distributed(backend="auto", num_processes=2, process_id=0)
    assert sharding.init_distributed(backend="gloo") is False  # no world: one process
    assert sharding.init_distributed(backend="gloo", num_processes=1, process_id=0) is False
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="NCCL refuses"):
            sharding.init_distributed(backend="nccl", num_processes=2, process_id=0,
                                      init_method="file:///nonexistent")
    mesh = sharding.data_mesh("data", device="cpu")
    assert (mesh.world, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
    assert sharding.resolve_mesh_axis(mesh, None) == "data"
    with pytest.raises(ValueError, match="no axis"):
        sharding.resolve_mesh_axis(mesh, "model")


def test_cross_shard_of_one_rank_is_the_stats():
    mesh = sharding.data_mesh("data", device="cpu")
    d = DeviceSpillStats(3, 1, 2, 1, 1, 9, 40, False, 17, False, torch.tensor(False),
                         rows_retired=2, rows_exchanged=torch.tensor(40),
                         exchange_dropped=torch.tensor(False), exchange_quota=64,
                         exchange_max_fill=torch.tensor(33))
    assert d.cross_shard(mesh).finalize().as_dict() == d.finalize().as_dict()


def test_shard_agg_smoke_on_cpu_ranks():
    """``python -m repro_torch.launch.shard_agg --world 4 --dist-backend
    gloo --device cpu --smoke``: four spawned ranks, the report, and the
    result equal to the NumPy oracle."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.shard_agg", "--world", "4",
                        "--dist-backend", "gloo", "--device", "cpu", "--smoke"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("world=4 ranks on cpu (gloo")
    report = dict(line.split(None, 1) for line in lines[1:])
    assert {"world", "processes", "rows_global", "zipf_s", "policy", "groups",
            "rows_exchanged", "exchange_quota", "exchange_max_fill", "fill_frac",
            "exchange_retries", "exchange_footprint_rows", "seconds"} <= set(report)
    assert report["oracle"] == "equal" and report["world"] == "4"
    assert 0 < int(report["rows_exchanged"]) < 4096

"""The port's expert parallelism, ring all-gather matmul and GPipe pipeline
held against the JAX package's, through real multi-process gloo
collectives on the CPU.

One pool of 8 ranks (spawned processes joined by ``torch.distributed`` over
gloo, rendezvous in a ``file://`` store) runs every case once, on the
sub-meshes of ``tests/_torch_ep_cases.py``'s ``MESHES``, for the whole
session: the first test process to need the results runs the pool under a
file lock in the session's shared temp dir, the others read what it
stored.  Cases:

* the reference test's EP block (smoke qwen3-moe, ``moe_chunk`` 64,
  capacity factor 4) on meshes (2, 4), (1, 4), (2, 2) and ("pod", "data",
  "model") (2, 2, 2), and at capacity factor 1 with chunks that overflow:
  each rank's ``y`` shard within 1e-5, the aux within 1e-6, every gradient
  leaf's slice (router columns, ``wi``, ``wg``, ``wo``) and ``dx`` within
  1e-5 of its largest magnitude, of the loss ``sum(y * ct) + aux``; the
  dropped rows counted from each package's routes equal;
* the smoke model's prefill and 4 decode steps with ``sorted_ep`` on (2,
  2), teacher-forced: logits within rtol/atol 2e-3, as the port's other
  serve tests (K/V go through a bfloat16 cache in both);
* the ring all-gather matmul on 4 and 8 ranks (x (64, 128), w (128, 96)):
  within 1e-4 of ``x @ w`` and of the reference's, ``world - 1``
  ``ppermute``s and no all-gather; the all-gather baseline likewise;
* the pipeline (8 layers of ``tanh(h @ W)``, D 32, batch 16, 4
  microbatches, 4 stages): output, stage gradients and ``dx`` within 1e-5;
* each differentiable collective's backward by ``torch.autograd.gradcheck``
  in float64 on 2 ranks.

The reference's mesh programs need 8 host devices, so
``scripts/make_torch_ep_reference.py`` computes them into
``tests/data/torch_ep_reference.npz``; one case is recomputed live in a
subprocess (``--check --case``).  In this process: ``sorted_ep`` without
a registered mesh equals ``sorted``; on a one-rank mesh it equals the
reference's EP block; ``ep_moe_block`` raises without a mesh or a
``"model"`` axis.
"""
import dataclasses as dc
import functools
import os
import pickle
import queue
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from filelock import FileLock

import _torch_ep_cases as cases
from repro_torch.configs import get_config
from repro_torch.distributed import moe_parallel as MP
from repro_torch.distributed import pipeline as PP
from repro_torch.distributed import sharding
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
POOL_TIMEOUT_S = 240


@functools.lru_cache(maxsize=1)
def _stored():
    return np.load(cases.REFERENCE_FILE)


def stored(name: str) -> dict:
    arrays = _stored()
    out = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.split("|")[0] == name}
    if not out:
        pytest.fail(f"{cases.REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_ep_reference.py")
    return out


def _run_pool(rdv: Path) -> dict:
    """Every case on the 8-rank pool: name -> per-rank results, or the
    failure's text."""
    ctx = torch.multiprocessing.get_context("spawn")
    tasks = [ctx.Queue() for _ in range(cases.POOL_WORLD)]
    results = ctx.Queue()
    procs = [ctx.Process(target=cases.rank_main, daemon=True,
                         args=(r, cases.POOL_WORLD, str(rdv), tasks[r], results))
             for r in range(cases.POOL_WORLD)]
    for p in procs:
        p.start()
    out = {}
    try:
        for name in cases.STORED_CASES + ("gradcheck",):
            inp = cases.inputs(name)
            for q in tasks:
                q.put((name, inp))
            got, errors = {}, []
            for _ in range(cases.POOL_WORLD):
                try:
                    rank, n, status, payload = results.get(timeout=POOL_TIMEOUT_S)
                except queue.Empty:
                    return {k: out.get(k, f"{name}: a rank did not answer within "
                                          f"{POOL_TIMEOUT_S} s")
                            for k in cases.STORED_CASES + ("gradcheck",)}
                assert n == name
                if status == "error":
                    errors.append(f"rank {rank}:\n{payload}")
                elif status == "ok":
                    got[rank] = payload
            out[name] = ("\n".join(errors) if errors
                         else [got[r] for r in sorted(got)])
    finally:
        for q in tasks:
            q.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    return out


@pytest.fixture(scope="session")
def pool_results(tmp_path_factory):
    """The pool's results, computed once for the session: test processes
    share them through a file in the session's common temp dir."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_ep_pool.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            rdv = root / "torch_ep_rendezvous"
            rdv.unlink(missing_ok=True)
            path.write_bytes(pickle.dumps(_run_pool(rdv)))
    return pickle.loads(path.read_bytes())  # written by this session's pool


def ranks_of(pool_results, name: str) -> list[dict]:
    got = pool_results[name]
    if isinstance(got, str):
        pytest.fail(f"{name} failed on the pool:\n{got}")
    return got


def close(got, want, tol: float, what: str) -> None:
    """Within ``tol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# the EP block, rank by rank, against the reference's
# ---------------------------------------------------------------------------


def _mesh(name: str):
    shape, axes, _ = cases.MESHES[cases.BLOCKS[name]["mesh"]]
    return dict(zip(axes, shape)), axes


@pytest.mark.parametrize("name", list(cases.BLOCKS))
def test_ep_block_rank_equals_reference(name, pool_results):
    want = stored(name)
    shape, axes = _mesh(name)
    ranks = ranks_of(pool_results, name)
    assert len(ranks) == int(np.prod(list(shape.values())))
    ep = shape["model"]
    dp_axes = [a for a in axes if a != "model"]
    n_dp = int(np.prod([shape[a] for a in dp_axes]))
    e_loc = want["g_wi"].shape[0] // ep
    for r, got in enumerate(ranks):
        coords = dict(zip(axes, np.unravel_index(r, tuple(shape.values()))))
        d = int(np.ravel_multi_index([coords[a] for a in dp_axes],
                                     [shape[a] for a in dp_axes]))
        j = int(coords["model"])
        rows = slice(d * (cases.B // n_dp), (d + 1) * (cases.B // n_dp))
        experts = slice(j * e_loc, (j + 1) * e_loc)
        close(got["y"], want["y"][rows], 1e-5, f"{name} rank {r} y")
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=0, atol=1e-6)
        close(got["dx"], want["dx"][rows], 1e-5, f"{name} rank {r} dx")
        close(got["g_router/kernel"], want["g_router/kernel"][:, experts], 1e-5,
              f"{name} rank {r} router")
        for leaf in ("wi", "wg", "wo"):
            close(got[f"g_{leaf}"], want[f"g_{leaf}"][experts], 1e-5, f"{name} rank {r} {leaf}")
        assert got["imported"] == [], got["imported"]


def test_ep_block_drops_rows_as_the_reference(pool_results):
    """At capacity factor 1 the chunks overflow: both packages' routes drop
    the same number of rows (and y agrees, above)."""
    name = "ep-2x4-cf1"
    want = stored(name)
    cfg = cases.block_cfg(get_config, name)
    shape, _ = _mesh(name)
    chunk, _, cap = MP.chunking(cfg, cases.B // shape["data"] * cases.S)
    e = cfg.moe.num_experts
    want_drops = cases.drops(want["idx"], shape["data"], chunk, e, cap)
    got_idx = np.concatenate([r["idx"] for r in ranks_of(pool_results, name)
                              [::shape["model"]]])
    assert want_drops > 0
    assert cases.drops(got_idx, shape["data"], chunk, e, cap) == want_drops


def test_ep_block_collectives(pool_results):
    """A rank's collectives for the block forward and backward on (2, 4):
    per chunk 2 all-to-alls forward, 2 in the rematerialized forward and 2
    backward; one all-gather of the router's logits."""
    for got in ranks_of(pool_results, "ep-2x4"):
        n_chunks = cases.B // 2 * cases.S // 64
        assert got["collectives"]["all_to_all"] == 6 * n_chunks
        assert got["collectives"]["all_gather"] == 1
        assert got["collectives"]["ppermute"] == 0


def test_sorted_ep_serve_on_mesh_equals_reference(pool_results):
    want = stored("serve-2x2")["logits"]
    n = cases.SERVE["batch"] // 2
    for r, got in enumerate(ranks_of(pool_results, "serve-2x2")):
        d = r // 2
        np.testing.assert_allclose(got["logits"], want[d * n:(d + 1) * n], rtol=2e-3,
                                   atol=2e-3, err_msg=f"rank {r}")
        assert got["collectives"]["all_to_all"] > 0


@pytest.mark.parametrize("name", list(cases.RINGS))
def test_ring_allgather_matmul_equals_reference(name, pool_results):
    want = stored(name)
    inp = cases.inputs(name)
    ranks = ranks_of(pool_results, name)
    world = len(ranks)
    for r, got in enumerate(ranks):
        for kind in ("ring", "gathered"):
            np.testing.assert_allclose(got[kind], inp["x"] @ inp["w"], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[kind], want[kind], rtol=1e-4, atol=1e-4)
        assert got["ring_collectives"] == dict(all_gather=0, all_to_all=0, all_reduce=0,
                                               ppermute=world - 1), got["ring_collectives"]
        assert got["gathered_collectives"]["all_gather"] == 1


def test_pipeline_equals_reference(pool_results):
    want = stored("pipeline")
    ranks = ranks_of(pool_results, "pipeline")
    stages = len(ranks)
    per = cases.PIPELINE["layers"] // stages
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["g_params"], want["g_params"][r * per:(r + 1) * per],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dx"], want["dx"], rtol=1e-5, atol=1e-5)
        steps = cases.PIPELINE["microbatches"] + stages - 1
        assert got["collectives"]["ppermute"] == 2 * (steps - 1)  # forward and backward
    x = cases.inputs("pipeline")
    seq = x["x"]
    for w in x["params"]:
        seq = np.tanh(seq @ w)
    np.testing.assert_allclose(ranks[0]["y"], seq, rtol=1e-5, atol=1e-5)
    assert PP.bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert PP.bubble_fraction(4, 8) == pytest.approx(3 / 11)


@pytest.mark.parametrize("op", cases.GRADCHECKS)
def test_collective_backward_gradcheck(op, pool_results):
    ranks = ranks_of(pool_results, "gradcheck")
    assert len(ranks) == 2 and all(got[op] for got in ranks)


def test_reference_recomputed_live():
    """The stored file is the reference's output today: one case recomputed
    in a subprocess (8 host devices) equals it bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "make_torch_ep_reference.py"),
                        "--check", "--case", "ring-w4"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# in this process: the fallback, a one-rank mesh, the errors
# ---------------------------------------------------------------------------


def _block_model(name: str, mesh=None):
    inp = cases.inputs(name)
    cfg = cases.block_cfg(get_config, name)
    return cfg, M.params_from_numpy(cfg, inp["tree"], device="cpu", mesh=mesh).layers[0].moe, inp


@pytest.fixture
def no_mesh():
    saved = MP._CURRENT_MESH[0]
    MP.set_current_mesh(None)
    yield
    MP.set_current_mesh(saved)


@pytest.mark.parametrize("mesh_axes", [None, ("data", "model")])
def test_sorted_ep_without_mesh_is_sorted(mesh_axes, no_mesh):
    cfg, moe, inp = _block_model("ep-2x4")
    cfg = dc.replace(cfg, mesh_axes=mesh_axes)
    x = torch.from_numpy(inp["x"])
    y_ep, aux_ep = MOE.moe_block(moe, cfg, x, dispatch="sorted_ep")
    y, aux = MOE.moe_block(moe, cfg, x, dispatch="sorted")
    assert torch.equal(y_ep, y) and torch.equal(aux_ep, aux)


def test_one_rank_mesh_equals_reference_block(no_mesh):
    """``make_mesh((1, 1))`` without ``init_distributed``: every collective
    is a copy, and the block equals the reference's EP block on (2, 4)
    (the same chunks: its data shard of 2 sequences; the aux, and so the
    gradients, are this shard's alone, not the mean of two)."""
    mesh = sharding.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.sub(("data", "model")).group is None and mesh.world == 1
    cfg, moe, inp = _block_model("ep-2x4", mesh)
    want = stored("ep-2x4")
    MP.set_current_mesh(mesh)
    for t in moe.parameters():
        t.requires_grad_(True)
    x = torch.from_numpy(inp["x"][:2]).requires_grad_(True)
    y, aux = MOE.moe_block(moe, cfg, x)
    (y * torch.from_numpy(inp["ct"][:2])).sum().backward()
    close(y.detach(), want["y"][:2], 1e-5, "y")
    assert float(aux) > 0 and x.grad is not None and torch.isfinite(x.grad).all()


def test_ep_block_raises_without_mesh_or_model_axis(no_mesh):
    cfg, moe, inp = _block_model("ep-2x4")
    x = torch.from_numpy(inp["x"][:1])
    with pytest.raises(RuntimeError, match="set_current_mesh"):
        MP.ep_moe_block(moe, cfg, x)
    flat = sharding.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="'model' axis"):
        MP.ep_moe_block(moe, cfg, x, mesh=flat)
    MP.set_current_mesh(flat)  # a mesh without "model": moe_block serves sorted
    y, _ = MOE.moe_block(moe, cfg, x)
    assert torch.equal(y, MOE.moe_block(moe, cfg, x, dispatch="sorted")[0])


def test_sliced_layer_refuses_sorted_and_chunks_must_divide(no_mesh):
    mesh = sharding.make_mesh((1, 1), ("data", "model"), device="cpu")
    cfg, moe, inp = _block_model("ep-2x4", mesh)
    with pytest.raises(ValueError):
        MP.chunking(dc.replace(cfg, moe_chunk=48), 100)
    half = MOE.MoE(cfg, dtype=torch.float32, device="cpu", experts=(0, 4))
    assert half.wi.shape[0] == 4 and half.router.kernel.shape[1] == 4
    with pytest.raises(ValueError, match="slice"):
        MOE.moe_block(half, cfg, torch.from_numpy(inp["x"][:1]), dispatch="sorted")


def test_rank_draw_is_the_slice_of_one_process_draw():
    """``init(cfg, gen, mesh=)`` on model coordinate j keeps experts j*E_loc
    .. and those router columns of the one-process draw."""
    cfg = dc.replace(get_config(cases.ARCH, smoke=True), mesh_axes=("data", "model"))
    whole = M.init(cfg, torch.Generator().manual_seed(3))
    mesh = sharding.NamedMesh(axis_names=("data", "model"), shape={"data": 1, "model": 4},
                              coords={"data": 0, "model": 2}, rank=2, world=4,
                              device=torch.device("cpu"), backend="none", subs={})
    part = M.init(cfg, torch.Generator().manual_seed(3), mesh=mesh)
    lo, hi = MP.expert_slice(cfg, mesh)
    assert (lo, hi) == (4, 6)
    for a, b in zip(whole.layers, part.layers):
        for leaf in ("wi", "wg", "wo"):
            assert torch.equal(getattr(a.moe, leaf)[lo:hi], getattr(b.moe, leaf))
        assert torch.equal(a.moe.router.kernel[:, lo:hi], b.moe.router.kernel)
        assert torch.equal(a.attn.wq.kernel, b.attn.wq.kernel)
    assert torch.equal(whole.unembed, part.unembed)

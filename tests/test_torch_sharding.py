"""The model half of the port's sharding held against the JAX package's:
the logical-axis rules, the spec trees and the helpers around them for
every architecture on the meshes (2, 4), (16, 16) and (2, 16, 16); each
rank's shards of a model on (2, 4); the sharded train step, the global
norm, the elastic restore and the train driver on a mesh of gloo ranks;
the H100 roofline's model FLOPs.

The reference's results are computed by
``scripts/make_torch_sharding_reference.py`` (8 host devices, meshes of
``Auto`` axes) into ``tests/data/torch_sharding_reference.npz``
(``tests/_torch_sharding_cases.py`` says what each case holds); one case
is recomputed live.  The rank cases run on ``tests/test_torch_ep.py``'s
pool of 8 gloo ranks.  Tolerances: specs, shard shapes, shards of the
same weights and the FLOPs exactly; the sharded steps' losses within rtol
1e-5 and every leaf's and moment's shard within 1e-3 of that leaf's
largest magnitude (the largest differences are reported); the elastic
restore and the driver's resume bit for bit.
"""
import dataclasses as dc
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharding_cases as SC
from repro.configs import get_config as j_get_config
from repro.launch import roofline as JR
from repro.launch import steps as JST
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.launch import roofline as RF
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_ep import pool_results, ranks_of  # noqa: F401  (the session's pool)

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=1)
def _stored():
    return np.load(SC.REFERENCE_FILE)


def stored(name: str) -> dict:
    arrays = _stored()
    out = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.split("|")[0] == name}
    if not out:
        pytest.fail(f"{SC.REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_sharding_reference.py")
    return out


@functools.lru_cache(maxsize=None)
def reference_specs(arch: str) -> dict:
    return json.loads(str(stored("specs")[arch]))


def js(spec) -> list:
    return SC.spec_json(spec)


def flat(tree, prefix: str = "") -> dict:
    """The port's spec trees (dicts, pairs of dicts) by ``/``-joined path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and tree and all(isinstance(t, dict) for t in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def abstract(name: str) -> SH.AbstractMesh:
    shape, axes = SC.SPEC_MESHES[name]
    return SH.AbstractMesh.of(shape, axes)


def fake_rank(shape, axes, rank: int) -> SH.NamedMesh:
    """A rank's coordinates on a mesh, without its processes (for
    ``shard_of`` and ``valid_slices``, which read only those)."""
    return SH.NamedMesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)),
                        coords=SC.mesh_coords(shape, axes, rank), rank=rank,
                        world=int(np.prod(shape)), device=torch.device("cpu"), backend="none",
                        subs={})


def close(got, want, tol: float, what: str) -> float:
    """Within ``tol`` of the largest magnitude of ``want``; returns the
    difference over that magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-12)
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= tol, f"{what}: max |diff| {err} of the largest magnitude > {tol}"
    return err


# ---------------------------------------------------------------------------
# specs: every architecture, shape and mesh, exactly
# ---------------------------------------------------------------------------

CELLS = [(a, m) for a in SC.ARCHS for m in SC.SPEC_MESHES]


@pytest.mark.parametrize("arch", SC.ARCHS)
def test_logical_axes_and_abstract_init_equal_reference(arch):
    want = reference_specs(arch)
    cfg = get_config(arch)
    leaves, axes = ST.abstract_init(cfg)
    assert {k: list(v) for k, v in axes.items()} == want["axes"]
    got = {k: [list(t.shape), str(t.dtype).removeprefix("torch.")] for k, t in leaves.items()}
    assert got == want["leaves"]
    assert all(t.device.type == "meta" for t in leaves.values())
    assert list(axes) == list(M.param_leaves(M.abstract_model(cfg)))  # one order


@pytest.mark.parametrize("arch,mesh_name", CELLS)
def test_state_specs_equal_reference(arch, mesh_name):
    want = reference_specs(arch)["meshes"][mesh_name]
    cfg, mesh = get_config(arch), abstract(mesh_name)
    for opt in SC.OPTS:
        st = ST.state_shardings(cfg, mesh, opt)
        for field in ("params", "opt_m", "opt_v"):
            got = {k: js(v) for k, v in getattr(st, field).items()}
            assert got == want[f"{opt}/{field}"], (opt, field)
        assert js(st.step) == want[f"{opt}/step"]
    specs = SH.tree_specs(M.logical_axes(cfg), SH.rules_for_mesh(mesh))
    assert specs == ST.state_shardings(cfg, mesh, "adamw").params


@pytest.mark.parametrize("arch,mesh_name", CELLS)
def test_shard_shapes_equal_reference(arch, mesh_name):
    """GSPMD's shard shape of every leaf, padding included (the ceiling
    where a dimension does not divide its ranks)."""
    want = reference_specs(arch)["meshes"][mesh_name]["shard_shapes"]
    cfg, mesh = get_config(arch), abstract(mesh_name)
    specs = ST.state_shardings(cfg, mesh, "adamw").params
    got = {k: list(SH.shard_shape(shape, specs[k], mesh))
           for k, shape in M.leaf_shapes(cfg).items()}
    assert got == want


@pytest.mark.parametrize("arch,mesh_name", CELLS)
def test_batch_and_cache_specs_equal_reference(arch, mesh_name):
    want = reference_specs(arch)["meshes"][mesh_name]
    cfg, mesh = get_config(arch), abstract(mesh_name)
    assert {k: js(v) for k, v in flat(SH.cache_specs(cfg, mesh)).items()} == want["cache"]
    cells = {}
    for shape in ST.SHAPES:
        if ST.shape_skips(cfg, shape):
            continue
        ins = flat(ST.input_specs(cfg, shape))
        cells[shape] = {
            "inputs": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in ins.items()},
            "specs": {k: js(v) for k, v in flat(ST.batch_shardings(cfg, mesh, shape)).items()}}
    assert cells == want["cells"]


def test_batch_replicates_where_it_does_not_divide():
    """``long_500k``'s batch of 1 is replicated, its caches' batch too."""
    cfg, mesh = get_config("mamba2-2.7b"), abstract("16x16")
    got = ST.batch_shardings(cfg, mesh, "long_500k")
    assert got["token"] == () and got["caches"]["ssm"] == (None, None, "model", None, None)
    assert ST.batch_shardings(cfg, mesh, "decode_32k")["token"] == ("data", None)


def test_input_specs_allocate_nothing():
    ins = ST.input_specs(get_config("deepseek-v3-671b"), "decode_32k")
    for leaf in flat(ins).values():
        assert leaf.device.type == "meta" or leaf.numel() <= 61  # the host index


# ---------------------------------------------------------------------------
# a tensor's shard, in this process
# ---------------------------------------------------------------------------


def test_shard_of_pads_uneven_blocks_and_valid_slices_bound_them():
    """12 rows over 16 ranks (qwen2's heads on the production mesh): blocks
    of 1, the last 4 all padding; 10 rows over 4: blocks of 3, the last
    holds 1 row and 2 of zeros."""
    t = torch.arange(10 * 6, dtype=torch.float32).reshape(10, 6)
    spec = ("data", None)
    parts = [SH.shard_of(t, spec, fake_rank((4,), ("data",), r)) for r in range(4)]
    assert all(p.shape == (3, 6) for p in parts)
    assert torch.equal(torch.cat(parts)[:10], t) and not parts[3][1:].any()
    assert [SH.valid_slices(t.shape, spec, fake_rank((4,), ("data",), r))[0].stop
            for r in range(4)] == [3, 3, 3, 1]
    u = torch.ones(12, 2)
    for r in range(16):
        got = SH.shard_of(u, ("model", None), fake_rank((16,), ("model",), r))
        assert got.shape == (1, 2) and float(got.sum()) == (2.0 if r < 12 else 0.0)
    assert SH.shard_shape((12, 2), ("model", None), SH.AbstractMesh.of((16,), ("model",))) \
        == (1, 2)


def test_shard_of_tuple_axes_is_row_major():
    """A dimension split over ("pod", "data"): block pod * |data| + data."""
    t = torch.arange(8.0)
    for r in range(8):
        m = fake_rank((2, 2, 2), ("pod", "data", "model"), r)
        got = SH.shard_of(t, (("pod", "data"),), m)
        b = m.coords["pod"] * 2 + m.coords["data"]
        assert torch.equal(got, t[2 * b:2 * b + 2])


def test_conflict_pass_and_rules():
    assert SH.spec_from_axes(("layers", "expert", "embed", "mlp")) == (None, "model", "data",
                                                                        None)
    pod = SH.rules_for_mesh(SH.AbstractMesh.of((2, 16, 16), ("pod", "data", "model")))
    assert SH.spec_from_axes(("embed", "mlp"), pod) == (("pod", "data"), "model")
    assert SH.spec_from_axes(("embed", "embed"), pod) == (("pod", "data"), None)
    assert SH.spec_from_axes((None, "lora")) == (None, None)


def test_sharded_model_draw_is_the_one_process_draw_cut():
    """``init(..., sharded=True)`` on a rank keeps each leaf's block of the
    one-process draw (drawn and cut one tensor at a time)."""
    cfg = dc.replace(get_config("qwen3-moe-30b-a3b", smoke=True), mesh_axes=("data", "model"))
    whole = M.init(cfg, torch.Generator().manual_seed(3))
    m = fake_rank((2, 4), ("data", "model"), 6)
    part = M.init(cfg, torch.Generator().manual_seed(3), mesh=m, sharded=True)
    rules = SH.rules_for_mesh(m)
    got = dict(part.named_parameters())
    for n, t in whole.named_parameters():
        assert torch.equal(got[n], SH.shard_of(t, SH.spec_from_axes(t.axes, rules), m)), n
    assert part.layout.specs["layers.0.moe.wi"] == ("model", "data", None)
    assert part.layout.ep is False  # the smoke config dispatches "sorted"


# ---------------------------------------------------------------------------
# the sharded step on a mesh of one rank: every family, equal to one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SC.ARCHS)
def test_sharded_step_on_one_rank_equals_unsharded(arch):
    from repro_torch.data import DataLoader
    from repro_torch.launch.train import frontend_embeddings, make_batch

    cfg = get_config(arch, smoke=True)
    mesh = SH.make_mesh((1, 1), ("data", "model"), device="cpu")
    cfg_m = dc.replace(cfg, mesh_axes=("data", "model"))
    step0, init0, _ = ST.make_train_step(cfg, lr=1e-2)
    step1, init1, _ = ST.make_train_step(cfg_m, lr=1e-2, mesh=mesh)
    a, b = init0(torch.Generator().manual_seed(0)), init1(torch.Generator().manual_seed(0))
    assert isinstance(b.params.layout, FS.Layout)
    emb = frontend_embeddings(cfg) if cfg.frontend_stub else None
    batch = make_batch(cfg, DataLoader(cfg.vocab, 2, 32, seed=1).next(), torch.device("cpu"),
                       emb)
    for _ in range(2):
        a, ma = step0(a, batch)
        b, mb = step1(b, ST.local_batch(batch, mesh))
        np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]), rtol=1e-6)
    for (n, x), (_, y) in zip(a.params.named_parameters(), b.params.named_parameters()):
        close(y.detach(), x.detach(), 1e-3, n)


# ---------------------------------------------------------------------------
# on the pool of 8 gloo ranks
# ---------------------------------------------------------------------------


def test_init_shards_equal_reference_addressable_shards(pool_results):
    """Each rank's shard of every leaf (a stack's, layer by layer) equals
    the reference's addressable shard on the device at its coordinates."""
    want = stored("init-2x4")
    for got in ranks_of(pool_results, "init-2x4"):
        c = got["coords"]
        tag = f"@{c['data']},{c['model']}"
        for name, shard in got["shards"].items():
            path = M.leaf_path(name)
            ref = want[path + tag]
            if path.split("/")[0] in M.STACKED:
                ref = ref[int(name.split(".")[1])]
            assert shard.dtype == ref.dtype and np.array_equal(shard, ref), (name, tag)


def _expected_shard(full: np.ndarray, spec, coords) -> np.ndarray:
    m = fake_rank((2, 4), ("data", "model"), coords["data"] * 4 + coords["model"])
    return SH.shard_of(torch.from_numpy(np.array(full)), spec, m).numpy()


@pytest.mark.parametrize("name", list(SC.STEPS))
def test_sharded_train_step_equals_reference(name, pool_results):
    want = stored(name)
    arch, opt = SC.STEPS[name]
    cfg = SC.step_cfg(get_config, name)
    mesh = SH.AbstractMesh.of((2, 4), ("data", "model"))
    specs = ST.state_shardings(cfg, mesh, opt).params
    shapes = M.leaf_shapes(cfg)
    worst = {}
    for got in ranks_of(pool_results, name):
        np.testing.assert_allclose(got["losses"], want["loss"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["norms"], want["grad_norm"], rtol=1e-4, atol=0)
        c = got["coords"]
        for pname, shard in got["params"].items():
            path = M.leaf_path(pname)
            full = want[f"params/{path}"]
            spec = specs[path]
            if path.split("/")[0] in M.STACKED:
                full, spec = full[int(pname.split(".")[1])], spec[1:]
            err = close(shard, _expected_shard(full, spec, c), 1e-3, f"{name} {pname} {c}")
            worst[path] = max(worst.get(path, 0.0), err)
        for tag, first in (("m", True), ("v", False)):
            for k, shard in got[tag].items():
                full = want[f"{tag}/{k}"]
                spec = M.moment_spec(specs[k], shapes[k], full.shape, first)
                err = close(shard, _expected_shard(full, spec, c), 1e-3, f"{name} {tag} {k}")
                worst[f"{tag}/{k}"] = max(worst.get(f"{tag}/{k}", 0.0), err)
        assert got["collectives"]["all_gather"] > 0 and got["collectives"]["all_reduce"] > 0
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    print(f"{name}: largest differences (of each leaf's largest magnitude): {top}")


def test_clip_norm_counts_a_replicated_leaf_once(pool_results):
    """A leaf split over both axes (10 rows over 2: even; padded blocks
    elsewhere), one replicated over every rank and one split over
    ``"model"`` only: the norm is the global tensors', each counted once,
    and the clipped shards gather back to the clipped tensors."""
    inp = SC.inputs("clip")
    norm = float(np.sqrt(sum(float(np.sum(np.square(inp[k], dtype=np.float64)))
                             for k in ("split", "rep", "model"))))
    for got in ranks_of(pool_results, "clip"):
        np.testing.assert_allclose(got["norm"], norm, rtol=1e-6)
        for k, v in got["clipped"].items():
            np.testing.assert_allclose(v, inp[k] * min(1.0, 1.0 / norm), rtol=1e-6, atol=1e-7)
        c = got["coords"]
        np.testing.assert_allclose(got["split_shard"],
                                   _expected_shard(inp["split"] * min(1.0, 1.0 / norm),
                                                   ("data", "model"), c), rtol=1e-6, atol=1e-7)


def test_elastic_restore_onto_another_mesh(pool_results):
    """``tests/test_distributed.py``'s elastic restore on the port: saved
    from (8,) with w split by rows, restored onto (4, 2) with w split both
    ways and b over ``"model"``: each rank's shards are its blocks of the
    saved tensors, on the CPU like the tree it restored into."""
    inp = SC.inputs("elastic")
    for got in ranks_of(pool_results, "elastic"):
        assert got["step"] == 10 and got["loader"]["step"] == 10
        m = fake_rank((4, 2), ("data", "model"),
                      got["coords4"]["data"] * 2 + got["coords4"]["model"])
        for k, spec in (("w", ("data", "model")), ("b", ("model",))):
            want = SH.shard_of(torch.from_numpy(inp[k]), spec, m).numpy()
            np.testing.assert_array_equal(got["shards"][k], want)
        assert set(got["devices"].values()) == {"cpu"}


def test_train_on_a_mesh_resumes_bit_for_bit(pool_results):
    ranks = ranks_of(pool_results, "train-mesh")
    for got in ranks:
        assert got["first"] + got["rest"] == got["full"]
        assert got["full"] == ranks[0]["full"]  # every rank reports the global loss
        assert len(got["full"]) == SC.TRAIN_MESH["steps"] and np.isfinite(got["full"]).all()


def test_train_on_a_mesh_stops_together_on_one_ranks_signal(pool_results):
    """A SIGTERM that reaches rank 1 alone stops every rank after the same
    step, with the checkpoint saved there; the resume ends bit for bit as
    the run that was not stopped."""
    ranks = ranks_of(pool_results, "train-mesh")
    cut = SC.TRAIN_MESH["cut"] + 1
    for got in ranks:
        assert len(got["stopped"]) == cut, got["stopped"]
        assert got["stopped"] + got["resumed"] == got["full"]


def test_stored_reference_is_the_reference_output():
    """The stored file is the reference's output today: the init case
    recomputed in a subprocess (8 host devices) equals it bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "make_torch_sharding_reference.py"),
                        "--check", "--case", "init-2x4"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# checkpoints follow their tree's device; meshes; the roofline
# ---------------------------------------------------------------------------


def test_restore_defaults_to_the_tree_device(tmp_path):
    """A restore lands where ``tree_like``'s tensors are (a model's: its
    parameters'); with no tensor to follow it takes the card, and raises
    here, where there is none (nothing silently lands on the CPU)."""
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": 3}
    save_pytree(tree, str(tmp_path / "a"), step=1)
    got, _ = restore_pytree({"w": torch.zeros(2, 3), "n": 0}, str(tmp_path / "a"))
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], tree["w"]) and got["n"] == 3
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_pytree({"w": np.zeros((2, 3), np.float32), "n": 0}, str(tmp_path / "a"))
    cfg = get_config("llama3-8b", smoke=True)
    _, init_state, _ = ST.make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(state, 1)
    got, _ = mgr.restore(state)
    assert {t.device.type for t in got.opt_m.values()} == {"cpu"}


def test_production_meshes_need_their_ranks():
    with pytest.raises(ValueError, match="256 ranks"):
        LM.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        LM.make_production_mesh(multi_pod=True)
    assert LM.production_shape() == ((16, 16), ("data", "model"))
    assert LM.production_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="8 ranks"):
        LM.make_test_mesh((2, 4))
    one = LM.make_test_mesh((1, 1), device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.world == 1


@pytest.mark.parametrize("arch", SC.ARCHS)
@pytest.mark.parametrize("shape", list(ST.SHAPES))
def test_model_flops_equals_reference(arch, shape):
    kind = ST.SHAPES[shape]["kind"]
    assert ST.SHAPES[shape] == JST.SHAPES[shape]
    assert RF.model_flops(get_config(arch), ST.SHAPES[shape], kind) == JR.model_flops(
        j_get_config(arch), JST.SHAPES[shape], kind)


def test_roofline_terms_in_the_h100s_units():
    r = RF.from_measured(flops=989e12, hbm_bytes=3.35e12, coll_bytes=RF.LINKS * RF.LINK_BW,
                         chips=1, coll_breakdown={"all_gather": 1.0})
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0) and r.step_time_lower_bound == pytest.approx(1.0)
    d = r.as_dict()
    assert set(d) == {"flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev", "t_compute_s",
                      "t_memory_s", "t_collective_s", "bottleneck"}
    assert RF.from_measured(2 * RF.PEAK_FLOPS, RF.HBM_BW, 0.0, 1).bottleneck == "compute"
    assert RF.collective_bytes_of({"all_gather_bytes": 3, "all_reduce_bytes": 4, "card": 9}) \
        == {"all_gather": 3, "all_reduce": 4}

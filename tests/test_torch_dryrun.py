"""The port's dry-run planner (``launch/dryrun.py``, ``hillclimb.py``,
``make_report.py``) held against the JAX package's: its cell list, shape
skips, depth variants, overrides, hill-climbing cells and model FLOPs for
the ten architectures, exactly; the arguments' bytes a device of the
train, prefill and decode cells of three smoke configs with bfloat16
leaves on (2, 4), exactly against XLA's ``memory_analysis``; the meta
dry-run's collectives against the same steps run for real on the
8-rank gloo pool, by kind and bytes, exactly; the calibrated roofline's
two-depth extrapolation within 1% of the full-depth count; the report's
tables from fixed records.

The reference's results are computed by
``scripts/make_torch_dryrun_reference.py`` (8 host devices) into
``tests/data/torch_dryrun_reference.npz``; the rehearsal runs on
``tests/test_torch_ep.py``'s pool (``tests/_torch_dryrun_cases.py``).
"""
import dataclasses as dc
import functools
import json

import numpy as np
import pytest

import _torch_dryrun_cases as DC
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC
from repro_torch.launch import make_report as MR
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_ep import pool_results, ranks_of  # noqa: F401  (the session's pool)


@functools.lru_cache(maxsize=1)
def _stored():
    return np.load(DC.REFERENCE_FILE)


@functools.lru_cache(maxsize=1)
def planner() -> dict:
    return json.loads(str(_stored()["planner|planner"]))


@pytest.fixture
def rehearsal_shapes(monkeypatch):
    """The small rehearsal shapes in ``steps.SHAPES`` for one test."""
    monkeypatch.setattr(ST, "SHAPES", dict(ST.SHAPES, **DC.REHEARSAL))


def test_cell_list_and_hillclimb_cells_equal_reference():
    want = planner()
    assert [list(c) for c in DR.cells(True)] == want["all_cells"]
    assert {k: {"arch": v["arch"], "shape": v["shape"], "iters": [[t, o] for t, o in v["iters"]]}
            for k, v in HC.CELLS.items()} == json.loads(json.dumps(want["cells"]))
    assert sorted(all_arch_ids()) == sorted(DC.ARCHS)


@pytest.mark.parametrize("arch", DC.ARCHS)
def test_skips_depth_variants_overrides_and_model_flops_equal_reference(arch):
    want = planner()[arch]
    cfg = get_config(arch)
    assert {s: ST.shape_skips(cfg, s) for s in ST.SHAPES} == want["skips"]
    a, b, units = DR._depth_variants(cfg)
    assert [DC.config_json(a), DC.config_json(b), units] == want["depth_variants"]
    assert {s: RL.model_flops(cfg, ST.SHAPES[s], ST.SHAPES[s]["kind"])
            for s in ST.SHAPES} == want["model_flops"]
    got = {f"{c}/{t}": DC.config_json(DR.apply_overrides(cfg, o))
           for c, v in HC.CELLS.items() if v["arch"] == arch for t, o in v["iters"]}
    assert got == want["overrides"]


@pytest.mark.parametrize("cell", DC.ARG_SHAPES)
@pytest.mark.parametrize("arch", DC.ARG_ARCHS)
def test_argument_bytes_equal_xla_memory_analysis(arch, cell):
    """A rank's bytes at rest by the spec arithmetic (parameters, moments and
    step, the inputs' shards) equal XLA's ``argument_size_in_bytes`` of the
    reference's compiled cell on (2, 4)."""
    cfg = dc.replace(DC.smoke_bf16(get_config, arch), mesh_axes=DC.MESH[1])
    mesh = SH.meta_mesh(DC.MESH)
    _, at_rest, _ = DR.cell_step(cfg, cell, mesh)
    assert sum(at_rest.values()) == int(_stored()[f"args|{arch}/{cell}"])


def test_meta_dry_run_collectives_equal_the_ranks(pool_results, rehearsal_shapes):
    """The meta dry-run of each rehearsal step, rank by rank, counts the
    collectives and bytes that step moved on the gloo ranks."""
    from repro_torch.distributed import moe_parallel as MP

    ranks = ranks_of(pool_results, "rehearsal")
    assert len(ranks) == 8
    for got in ranks[1:]:  # every rank moved the same collectives
        assert {k: v for k, v in got.items() if k != "coords"} == \
            {k: v for k, v in ranks[0].items() if k != "coords"}
    for got in (ranks[0], ranks[5]):  # (0, 0) and (1, 1): the meta dry-run of each
        c = got["coords"]
        mesh = SH.meta_mesh(DC.MESH, rank=c["data"] * 4 + c["model"])
        for arch in DC.ARG_ARCHS:
            cfg = DC.rehearsal_cfg(get_config, arch)
            for cell in DC.REHEARSAL:
                MP.set_current_mesh(mesh)
                try:
                    fn, at_rest, _ = DR.cell_step(cfg, cell, mesh)
                    _, _, coll = DR._counted(fn)
                finally:
                    MP.set_current_mesh(None)
                want = got[f"{arch}/{cell}"]
                assert {k: coll[k] for k in want if k != "at_rest"} == \
                    {k: v for k, v in want.items() if k != "at_rest"}, (arch, cell, c)
                assert at_rest == want["at_rest"]
                assert coll["all_gather"] > 0


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_calibrated_roofline_extrapolates_the_full_depth_count(arch, rehearsal_shapes):
    """Two depths extrapolated to a 4-layer smoke config within 1% of the
    4-layer count, on the (16, 16) production mesh's rank 0."""
    cfg = dc.replace(DC.smoke_bf16(get_config, arch), n_layers=4)
    shape = "rehearse_train"
    ST.SHAPES[shape] = dict(kind="train", seq=32, batch=32)  # 2 rows a data rank
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DR, "get_config", lambda a: cfg)
        rec = DR.calibrated_roofline(arch, shape)
    assert rec["status"] == "ok" and rec["units"] == 4 and rec["chips"] == 256
    full = DR._measure_costs(cfg, shape, DR._mesh(False))
    rl = rec["roofline"]
    for got, want in zip((rl["flops_per_dev"], rl["hbm_bytes_per_dev"], rl["coll_bytes_per_dev"]),
                         full[:3]):
        assert abs(got - want) <= 0.01 * want, (got, want)
    assert rec["roofline"]["collective_counts"]["all-gather"] > 0


def test_dryrun_cell_records_and_skips():
    """A skip record where the reference skips; a decode cell's record in
    the H100's terms (rank 0 of (16, 16), the meta device)."""
    rec = DR.dryrun_cell("llama3-8b", "long_500k", verbose=False)
    assert rec == {"arch": "llama3-8b", "shape": "long_500k", "mesh": "16x16", "status": "skip",
                   "reason": ST.shape_skips(get_config("llama3-8b"), "long_500k")}
    assert DR.HBM_PER_CHIP == 80e9
    assert DR.dryrun_cell("hubert-xlarge", "decode_32k", verbose=False)["status"] == "skip"


def test_meta_tracker_counts_bytes_and_the_high_water_mark():
    import torch

    a = torch.empty((1024,), device="meta")
    with DR.MetaTracker() as t:
        b = a * 2  # 4 KiB read, 4 KiB written, one new storage
        c = b.view(32, 32)  # a view: nothing
        d = c + 1  # a second live storage
        del b, c
        e = d.sum()  # d's storage still alive
        del d
        f = e + 1
    assert t.hbm_bytes == 4096 * 2 + 4096 * 2 + (4096 + 4) + (4 + 4)
    assert t.temp_bytes == 2 * 4096  # b and d, before e
    assert t.live == 8 and f.device.type == "meta"


FIXED = [
    {"arch": "llama3-8b", "shape": "long_500k", "mesh": "16x16", "status": "skip",
     "reason": "long_500k needs sub-quadratic attention; full-attention arch"},
    {"arch": "x", "shape": "train_4k", "mesh": "16x16", "status": "error",
     "error": "ValueError: boom"},
    {"arch": "y", "shape": "decode_32k", "mesh": "2x16x16", "status": "ok", "meta_run_s": 1.5,
     "chips": 512, "memory": {"argument_bytes": 2e9, "temp_bytes": 1e9, "peak_bytes": 3e9,
                              "fits_80GB": True},
     "roofline": {"t_compute_s": 0.001, "t_memory_s": 0.004, "t_collective_s": 0.002,
                  "bottleneck": "memory", "model_flops": 512 * RL.PEAK_FLOPS * 0.002,
                  "useful_flops_frac": 0.25,
                  "collective_counts": {"all-gather": 7, "all-reduce": 2, "reduce-scatter": 0,
                                        "all-to-all": 1, "collective-permute": 0}}},
]


def test_make_report_tables_from_fixed_records():
    d = MR.dryrun_table(FIXED).splitlines()
    assert d[0].startswith("| arch | shape | mesh | status | meta run s |")
    assert d[2] == ("| llama3-8b | long_500k | 16x16 | SKIP: long_500k needs sub-quadratic "
                    "attention; full-attention arch | | | | | | |")
    assert d[3] == "| x | train_4k | 16x16 | **FAIL**: ValueError: boom | | | | | | |"
    assert d[4] == ("| y | decode_32k | 2x16x16 | ok | 1.5 | 2.00G | 1.00G | 3.00G | ✓ "
                    "| 7/2/0/1/0 |")
    t = MR.summary_table(FIXED + [dict(FIXED[2], mesh="16x16", memory=dict(
        FIXED[2]["memory"], peak_bytes=9e10, fits_80GB=False))]).splitlines()
    assert t[0] == "| arch | train_4k | prefill_32k | decode_32k | long_500k |"
    assert t[2] == "| llama3-8b |  |  |  | skip |"
    assert t[3] == "| x | FAIL |  |  |  |"
    assert t[4] == "| y |  |  | 3.0 / 90.0✗ · memo 4 ms |  |"
    r = MR.roofline_table(FIXED[:1] + FIXED[2:]).splitlines()
    assert r[2].startswith("| llama3-8b | long_500k | SKIP: long_500k")
    # the roofline fraction: model FLOPs over chips x the H100's bf16 peak, over the dominant term
    assert r[3] == ("| y | decode_32k | 1.0ms | 4.0ms | 2.0ms | **memory** | 1.01e+15 | 0.250 "
                    "| 0.500 |")

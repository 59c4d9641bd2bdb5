"""The port's front door held against the JAX package's:
``repro_torch.aggregate(...).relation()`` must equal
``repro.aggregate(...).relation()`` (keys and counts exactly, float
aggregates within rtol 1e-4), for the README's 54-bit ``KeySpec`` and for
a key of at most 32 bits.  The reference's results are stored in
``tests/data/torch_stream_reference.npz`` (``STORED_CASES``, written by
``scripts/make_torch_stream_reference.py``); ``LIVE`` is recomputed live
and must equal its stored result too."""
import json

import jax
import jax.experimental
import numpy as np
import pytest

import repro
import repro_torch
from repro.core.types import ExecConfig as JExecConfig
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_stream import stored

CFG = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)


@pytest.fixture(autouse=True)
def _reference_x64_scope(monkeypatch):
    """The reference scopes its uint64 work with
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; lend it the old name for one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


SPECS = {
    "readme_54bit": (dict(region=24, store=20, sku=10), (16, 8, 40)),
    "narrow_24bit": (dict(year=12, month=4, day=8), (30, 12, 28)),
}


STORED_CASES = tuple(f"schema-{name}" for name in SPECS)
LIVE = "narrow_24bit"
AGGS = ("count", "sum", "min", "max", "avg")
PLAN_KEYS = ("input_rows", "output_estimate", "in_memory", "predicted_spill_insort",
             "predicted_spill_hash")


def _columns(name, n=2500):
    bits, domains = SPECS[name]
    rng = np.random.default_rng(len(name))
    cols = {c: rng.integers(0, d, n).astype(np.uint32) for c, d in zip(bits, domains)}
    if name == "readme_54bit":  # reach the top bits of the widest column
        cols["region"] = cols["region"] << np.uint32(20)
    values = rng.normal(size=(n, 2)).astype(np.float32)
    return bits, cols, values


def compute(case: str, *, ref: bool = True) -> dict:
    """The JAX front door's result of stored case ``schema-<name>``."""
    bits, cols, values = _columns(case.removeprefix("schema-"))
    res = repro.aggregate(cols, by=repro.KeySpec.of(**bits), values=values, aggs=AGGS,
                          order_by=True, cfg=JExecConfig(**CFG), backend="xla")
    return dict(relation=res.relation(), stats=res.stats.as_dict(), sorted_by=res.sorted_by,
                key_dtype=str(np.dtype(res.state.keys.dtype)),
                plan={k: res.plan[k] for k in PLAN_KEYS})


def _reference(name):
    """The JAX front door's result: stored, or live for ``LIVE`` (which must
    equal its stored result)."""
    want = stored(f"schema-{name}")
    if name == LIVE:
        live = compute(f"schema-{name}")
        assert set(live["relation"]) == set(want["relation"])
        for c, arr in want["relation"].items():
            np.testing.assert_allclose(live["relation"][c], arr, rtol=1e-4, atol=1e-5, err_msg=c)
        for k in ("stats", "key_dtype", "plan", "sorted_by"):
            assert json.loads(json.dumps(live[k])) == want[k], k
    return want


@pytest.mark.parametrize("name", sorted(SPECS))
def test_aggregate_relation_matches_reference(name):
    bits, cols, values = _columns(name)
    want = _reference(name)
    got = repro_torch.aggregate(cols, by=repro_torch.KeySpec.of(**bits), values=values,
                                aggs=AGGS, order_by=True, cfg=repro_torch.ExecConfig(**CFG),
                                device="cpu")
    w, g = want["relation"], got.relation()
    assert list(g) == list(bits) + list(AGGS) and set(g) == set(w)
    for c in list(bits) + ["count"]:
        assert g[c].dtype == w[c].dtype, c
        np.testing.assert_array_equal(g[c], w[c], err_msg=c)
    for c in ("sum", "min", "max", "avg"):
        np.testing.assert_allclose(g[c], w[c], rtol=1e-4, atol=1e-5, err_msg=c)
    assert got.stats.as_dict() == want["stats"]
    assert json.loads(json.dumps(got.sorted_by)) == want["sorted_by"]
    assert str(got.state.key_dtype) == want["key_dtype"]
    for k in PLAN_KEYS:
        assert got.plan[k] == want["plan"][k], k


@pytest.mark.parametrize("name", sorted(SPECS))
def test_keyspec_pack_unpack_match_reference(name):
    bits, cols, _ = _columns(name)
    mine, ref = repro_torch.KeySpec.of(**bits), repro.KeySpec.of(**bits)
    packed = mine.pack(cols)
    np.testing.assert_array_equal(packed, ref.pack(cols))
    assert packed.dtype == ref.key_dtype
    for c, v in mine.unpack(packed).items():
        np.testing.assert_array_equal(v, ref.unpack(packed)[c])


def test_aggregate_count_only_carries_no_planes():
    _, cols, _ = _columns("narrow_24bit", n=300)
    spec = repro_torch.KeySpec.of(year=12, month=4, day=8)
    res = repro_torch.aggregate(cols, by=spec, cfg=repro_torch.ExecConfig(**CFG),
                                device="cpu")
    assert res.state.widths == (0, 0, 0)
    assert set(res.relation()) == {"year", "month", "day", "count"}


def test_order_by_must_be_a_key_prefix():
    _, cols, _ = _columns("narrow_24bit", n=50)
    spec = repro_torch.KeySpec.of(year=12, month=4, day=8)
    with pytest.raises(ValueError, match="prefix"):
        repro_torch.aggregate(cols, by=spec, order_by=("month",), device="cpu")


def test_unported_algorithms_raise():
    """Every algorithm runs now: ``"adaptive"`` on one-shot input raises as
    the reference does, and streamed input (an iterator of column batches)
    runs the streamed pipeline."""
    _, cols, _ = _columns("narrow_24bit", n=50)
    spec = repro_torch.KeySpec.of(year=12, month=4, day=8)
    with pytest.raises(ValueError, match="streamed input"):
        repro_torch.aggregate(cols, by=spec, algorithm="adaptive", device="cpu")
    streamed = repro_torch.aggregate(iter([cols]), by=spec, device="cpu")
    assert streamed.plan["streamed"] and streamed.occupancy() == len(np.unique(spec.pack(cols)))
    res = repro_torch.aggregate(cols, by=spec, algorithm="hash", device="cpu")
    assert res.plan["algorithm"] == "hash" and res.occupancy() == len(
        np.unique(spec.pack(cols)))

"""The port's types and package boundary held against the JAX package's:
the state carry-over (u32 and u64 keys, EMPTY, the mapped frontier zero),
``rows_to_state``, ``SpillStats``, the default device, and the rule that
neither ``repro_torch`` nor ``chip_smoke.py`` imports JAX or ``repro``."""
import ast
import dataclasses
import re
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
import repro_torch
from repro_torch.core import types

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True)
def _reference_x64_scope(monkeypatch):
    """The reference scopes its uint64 work with
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; lend it the old name for one test."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def _reference_state(key_dtype, n=64, width=2):
    keys = RNG.integers(0, np.iinfo(key_dtype).max, n, dtype=key_dtype, endpoint=True)
    keys[::7] = np.iinfo(key_dtype).max  # EMPTY rows
    keys[1] = 0  # the unsigned zero
    pay = RNG.normal(size=(n, width)).astype(np.float32)
    with jtypes.key_dtype_context(keys):
        st = jtypes.rows_to_state(keys, pay)
        return keys, pay, {f: np.asarray(getattr(st, f)) for f in types.FIELDS}


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_state_carry_over_round_trips(key_dtype):
    keys, _, arrs = _reference_state(key_dtype)
    st = types.state_from_numpy(arrs, device="cpu")
    assert st.keys.dtype == torch.int64 and st.key_dtype == np.dtype(key_dtype)
    assert bool((st.valid().numpy() == (keys != np.iinfo(key_dtype).max)).all())
    back = types.state_to_numpy(st)
    for f in types.FIELDS:
        np.testing.assert_array_equal(back[f], arrs[f], err_msg=f)
        assert back[f].dtype == arrs[f].dtype, f


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_key_mapping_keeps_order_and_sentinels(key_dtype):
    keys = np.sort(RNG.integers(0, np.iinfo(key_dtype).max, 500, dtype=key_dtype,
                                endpoint=True))
    mapped = types.keys_to_torch(keys, "cpu")
    assert bool((mapped[1:] >= mapped[:-1]).all())
    edge = np.array([0, np.iinfo(key_dtype).max], dtype=key_dtype)
    lo, hi = types.keys_to_torch(edge, "cpu").tolist()
    assert lo == types.zero_key(key_dtype) and hi == types.empty_key(key_dtype)
    if key_dtype == np.uint64:
        assert (lo, hi) == (types.INT64_MIN, types.INT64_MAX)
    else:
        assert (lo, hi) == (0, 0xFFFFFFFF)


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("widths", [None, (2, 0, 0), (0, 2, 2)])
def test_rows_to_state_matches_reference(key_dtype, widths):
    keys, pay, _ = _reference_state(key_dtype)
    with jtypes.key_dtype_context(keys):
        ref = jtypes.rows_to_state(keys, pay, widths=widths)
        want = {f: np.asarray(getattr(ref, f)) for f in types.FIELDS}
    st = types.rows_to_state(types.keys_to_torch(keys, "cpu"), torch.from_numpy(pay),
                             key_dtype=key_dtype, widths=widths)
    got = types.state_to_numpy(st)
    for f in types.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_spill_stats_fields_match_reference():
    assert ([f.name for f in dataclasses.fields(types.SpillStats)]
            == [f.name for f in dataclasses.fields(jtypes.SpillStats)])
    assert types.SpillStats().as_dict() == jtypes.SpillStats().as_dict()


@pytest.mark.parametrize("flag,error", [
    ("run_buffer_overflowed", RuntimeError),
    ("merge_dropped_rows", types.MergeOverflowError),
])
def test_device_spill_stats_finalize_raises_on_lost_rows(flag, error):
    stats = dataclasses.replace(types.DeviceSpillStats.zeros(), **{flag: torch.tensor(True)})
    with pytest.raises(error):
        stats.finalize()


def test_exec_config_rejects_inconsistent_knobs():
    with pytest.raises(ValueError):
        types.ExecConfig(memory_rows=64, page_rows=128)


def test_entry_point_defaults_to_cuda():
    """Without ``device=`` the port runs on the card; where there is none it
    raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    spec = repro_torch.KeySpec.of(k=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.aggregate({"k": np.arange(10, dtype=np.uint32)}, by=spec)


_FORBIDDEN = re.compile(r"^(from|import) (jax|repro)(\.|\s|$)")


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            lines = [f"import {a.name}" for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            lines = [f"from {node.module or ''} import"]
        else:
            continue
        for line in lines:
            assert not _FORBIDDEN.match(line), f"{path.name}:{node.lineno}: {line}"


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_row_helpers_match_reference(key_dtype):
    keys, pay, arrs = _reference_state(key_dtype, n=20)
    perm = RNG.permutation(20)
    with jtypes.key_dtype_context(keys):
        ref = jtypes.AggState(*(jax.numpy.asarray(arrs[f]) for f in types.FIELDS))
        ref = jtypes.slice_rows(jtypes.take(jtypes.concat_states(ref, ref), perm), 3, 9)
        want = {f: np.asarray(getattr(ref, f)) for f in types.FIELDS}
    st = types.state_from_numpy(arrs, device="cpu")
    got = types.slice_rows(types.take(types.concat_states(st, st), torch.from_numpy(perm)),
                           3, 9)
    for f in types.FIELDS:
        np.testing.assert_array_equal(types.state_to_numpy(got)[f], want[f], err_msg=f)
    empty = types.state_to_numpy(types.empty_like(st, 4))
    assert (empty["keys"] == np.iinfo(key_dtype).max).all() and not empty["count"].any()

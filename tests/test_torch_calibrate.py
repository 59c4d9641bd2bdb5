"""The port's calibration, ``scripts/calibrate_torch.py``, and its
committed constants.

``--smoke`` on the CPU writes a table the cost model accepts and leaves
the committed module alone; ``--check`` accepts the committed module; its
``cpu`` entry is the JAX package's committed one and its ``cuda`` entry was
measured on an H100 by the script; ``load_cost_constants`` returns each
device type's own entry.
"""
import importlib.util
from pathlib import Path

import pytest

from repro.core import _cost_constants as j_constants
from repro_torch.core import _cost_constants as constants
from repro_torch.core import cost_model
from test_torch_baselines import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "calibrate_torch.py"


@pytest.fixture(scope="module")
def calibrate():
    spec = importlib.util.spec_from_file_location("calibrate_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(path: Path) -> dict:
    ns: dict = {}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns


def test_smoke_writes_a_valid_table_and_leaves_the_committed_one(calibrate, tmp_path, capsys):
    committed = calibrate.CONSTANTS_PATH.read_bytes()
    out = tmp_path / "constants.py"
    assert calibrate.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    assert calibrate.CONSTANTS_PATH.read_bytes() == committed
    table = _load(out)["COST_CONSTANTS"]
    cost_model.validate_constants(table, source=str(out))
    entry = table["cpu"]
    assert entry["meta"]["smoke"] and entry["meta"]["generated_by"] == "scripts/calibrate_torch.py"
    assert set(entry["meta"]["spread_ns"]) >= {"sort_row_ns", "absorb_row_ns.rs"}
    assert all(lo <= hi for lo, hi in entry["meta"]["spread_ns"].values())
    assert table["cuda"] == constants.COST_CONSTANTS["cuda"]  # the other entries stay
    assert "crossover" in capsys.readouterr().out


def test_check_accepts_the_committed_module(calibrate, capsys):
    assert calibrate.main(["--check"]) == 0
    assert "backends: ['cpu', 'cuda']" in capsys.readouterr().out
    assert calibrate.render(constants.COST_CONSTANTS) == calibrate.CONSTANTS_PATH.read_text()


def test_cpu_entry_is_the_reference_and_cuda_the_card():
    assert constants.COST_CONSTANTS["cpu"] == j_constants.COST_CONSTANTS["cpu"]
    meta = constants.COST_CONSTANTS["cuda"]["meta"]
    assert meta["backend"] == "cuda" and not meta["smoke"]
    assert meta["generated_by"] == "scripts/calibrate_torch.py"
    assert "H100" in meta["device"] and " W" in meta["device"]
    assert "memory_rows=1048576 batch_rows=65536" in meta["note"]


@pytest.mark.parametrize("device", ["cpu", "cuda", "mps"])
def test_load_cost_constants_by_device_type(device):
    want = constants.COST_CONSTANTS.get(device, constants.COST_CONSTANTS["cpu"])
    got = cost_model.load_cost_constants(device)
    assert got == want
    surface = cost_model.cost_surface(1e6, 1e3, backend=device)
    assert surface["calibrated_backend"] == ("cuda" if device == "cuda" else "cpu")

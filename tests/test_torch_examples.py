"""The port's example twins must run: each is executed as a subprocess on
the CPU (``--device cpu``) at ``tests/test_examples.py``'s sizes (the LM
trainer cut to 2 layers and a 4,096-entry vocabulary, for 4 steps of 2 x 64
tokens with its restart after 2), and prints the
phrases that module asserts of its reference twin."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(name: str, env_extra: dict, timeout: int = 300, args=()) -> str:
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run([sys.executable, os.path.join("examples", name), "--device", "cpu",
                        *args], env=env, capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


@pytest.mark.parametrize("name,env,phrases", [
    ("torch_streaming_service.py", {"SERVICE_MINUTES": "16", "SERVICE_ROWS": "512"},
     ("mid-stream queries:", "rows retired", "surviving events", "sessionized service OK")),
    ("torch_quickstart.py", {"QUICKSTART_N": "8000"},
     ("distinct users:", "output arrives sorted", "front door:", "streamed ingest",
      "identical relation")),
    ("torch_intersect_warehouse.py", {"INTERSECT_N": "20000"},
     ("sort-based plan spill:", "'re_sorts': 0", "join-side sort term: 0 rows",
      "order-preserving pipeline OK")),
    ("torch_moe_sorted_dispatch.py", {},
     ("max |dense − sorted|", "dispatch tensor rows:", "sorted dispatch OK")),
    ("torch_train_lm.py", {"TRAIN_LM_LAYERS": "2", "TRAIN_LM_VOCAB": "4096",
                           "ARGS": "--steps 4 --batch 2 --seq 64"},
     ("param LM on cpu", "simulated restart", "resumed from step 2", "done: loss went")),
], ids=["streaming_service", "quickstart", "intersect_warehouse", "moe_sorted_dispatch",
        "train_lm"])
def test_example_twin_runs_on_the_cpu(name, env, phrases):
    env = dict(env)
    out = run_example(name, env, args=env.pop("ARGS", "").split())
    for phrase in phrases:
        assert phrase in out, phrase


def test_example_twins_import_nothing_of_the_reference():
    for name in ("torch_quickstart.py", "torch_intersect_warehouse.py",
                 "torch_streaming_service.py", "torch_moe_sorted_dispatch.py",
                 "torch_train_lm.py"):
        with open(os.path.join(ROOT, "examples", name), encoding="utf-8") as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    assert words[1].split(".")[0] not in ("jax", "repro"), (name, line)

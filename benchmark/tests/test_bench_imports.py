"""Nothing a run loads is JAX or the JAX package: each cell runs in a
process of its own (at its rehearsal size on the CPU), with trace 0 and
with trace 1, so every end-to-end and every per-layer reader is loaded,
and run.py exits with code 4, naming what it found, if sys.modules holds
jax, jaxlib, flax or starcat (top-level names compared whole) once the
check and every reader have run."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import core

CELLS = [w["name"] for w in core.load_json(core.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_no_jax(workload, trace):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                        "3", "--seconds", "0.2", "--trace", trace, "--rehearse"], cwd=core.ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "the JAX package or JAX" not in p.stderr


def test_a_reader_that_loads_jax_stops_the_run(tmp_path):
    """A per-layer metric file dropped into a copy of the checkout imports a
    module named jax (a stand-in on the path): the run, which loads that
    reader only after its window, exits 4 naming jax and reports nothing."""
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    shutil.copytree(core.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(core.ROOT / "starcat_torch", tmp_path / "starcat_torch")
    (tmp_path / "benchmark/metrics/loads_jax.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return None\n")
    spec["per_layer"].append({"name": "loads_jax", "unit": "calls", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "particle_steps_per_s", "workloads": ["flagship.smc"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "stand_in" / "jax").mkdir(parents=True)
    (tmp_path / "stand_in" / "jax" / "__init__.py").write_text("")
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": str(tmp_path / "stand_in")}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship.smc",
                        "--seed", "3", "--seconds", "0.2", "--trace", "1", "--rehearse"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 4, p.stderr[-3000:]
    assert "jax" in p.stderr.splitlines()[-1] and "check " not in p.stderr
    assert p.stdout.strip() == ""


def test_forbidden_names_are_whole():
    assert core.forbidden_modules(["starcat_torch", "starcat_torch.chees", "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["starcat.api", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "starcat"]


def test_no_card_no_result():
    """Without a card (this CPU) a plain run exits 2 and prints no result."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True,
                       text=True, timeout=120)
    if p.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert p.returncode == 2 and p.stdout.strip() == ""

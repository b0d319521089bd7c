"""Every cell of BENCHMARK.json resolves to its files by name, and a cell,
configuration, traffic mix or metric that a later change drops in is found
by name with no existing file edited."""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import core

SPEC = core.load_json(core.ROOT / "BENCHMARK.json")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x for x in layers)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(name):
    cell = core.load_cell(name)
    assert cell["config_data"]["name"] == cell["config"]
    assert cell["traffic_data"]["head"] in ("chees", "smc")
    assert (core.BENCH / "heads" / f"{cell['traffic_data']['head']}.py").exists()
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    e2e = {m["name"] for m in cell["metrics"][0]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["metrics"][1]
    for m in cell["metrics"][0] + cell["metrics"][1]:
        assert callable(core.reader(m["name"]))
        assert m["moves"] in e2e if "moves" in m else True


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_its_own(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    data = core.load_json(core.ROOT / entry["file"])
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"] == []
    assert sum(c["file"] == entry["file"] for c in SPEC["configs"]) == 1


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_dropped_in_cell_is_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a metric
    and a cell as new files and BENCHMARK.json entries; the harness finds
    and runs them, and no file that was there changed."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    spec = json.loads(json.dumps(SPEC))
    cfg = {**core.load_json(core.BENCH / "configs" / "flagship.json"),
           "name": "flagship_seed21", "truth_seed": 21, "data_seed": 22}
    (tmp_path / "benchmark/configs/flagship_seed21.json").write_text(json.dumps(cfg))
    mix = {**core.load_json(core.BENCH / "traffic" / "chees_8192.json"), "n_chains": 6,
           "n_warmup": 16, "block": 2}
    (tmp_path / "benchmark/traffic/chees_tiny.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/iterations_done.py").write_text(
        "def read(run):\n    return float(run.counters.get('iterations', 0)) or None\n")
    (tmp_path / "benchmark/limits/flagship_seed21.chees_tiny.json").write_text(
        json.dumps({"draws_off": 0.05, "accept_gap": 0.5}))
    spec["configs"].append({**SPEC["configs"][0], "name": "flagship_seed21",
                            "file": "benchmark/configs/flagship_seed21.json"})
    spec["workloads"].append({"name": "flagship_seed21.chees_tiny", "config": "flagship_seed21",
                              "traffic": "chees_tiny", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "iterations_done", "unit": "iterations",
                              "better": "higher", "source": "host_clock", "layer": "head loop",
                              "moves": "draws_per_s",
                              "workloads": ["flagship_seed21.chees_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.load_cell("flagship_seed21.chees_tiny", root=tmp_path)
    assert cell["config_data"]["truth_seed"] == 21 and cell["traffic_data"]["n_chains"] == 6
    assert [m["name"] for m in cell["metrics"][1]] == ["iterations_done"]
    from benchmark.heads.chees import Head

    head = Head(cell, 7, torch.device("cpu"))
    head.setup()
    head.window(0.2, lambda name: __import__("contextlib").nullcontext())
    value = core.reader("iterations_done", root=tmp_path)(type("R", (), {
        "counters": head.counters})())
    assert value is not None and value >= 2
    assert head.check()["draws_off"] == 0.0
    after = _digest(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("n_units", [1, 3, 40])
def test_sample_keeps_a_bounded_seeded_uniform_sample(n_units):
    """The window's reservoir holds unit 0 and at most k others however long
    the window runs, the same ones for the same seed, each of the others
    about equally often over seeds."""
    from collections import Counter

    from benchmark.heads.common import Sample

    def run(seed):
        s, most = Sample(seed, 3), 0
        for i in range(n_units):
            s.offer(i, lambda: str(i))  # noqa: B023
            most = max(most, len(s.units()))
        assert all(item == str(u) for u, item in s.units())
        return [u for u, _ in s.units()], most

    units, most = run(5)
    assert units[0] == 0 and units == sorted(set(units)) and most == min(n_units, 4)
    assert run(5)[0] == units
    counts = Counter(u for seed in range(3000) for u in run(seed)[0])
    assert counts[0] == 3000
    if n_units > 4:
        share = [counts[u] / 3000 for u in range(1, n_units)]
        assert max(share) - min(share) < 0.05 and abs(sum(share) - 3) < 1e-9

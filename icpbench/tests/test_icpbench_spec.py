"""BENCHMARK.json against the shape its format requires, and every file it names
found by name; a cell added as new files only."""

import hashlib
import json
import re

import pytest

from icpbench import spec
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for path in BENCH["paths"]:
        assert (ROOT / path).is_dir() and not path.endswith("_torch")
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_named_file_is_found(workload):
    cell = spec.load(workload)
    assert cell.config["name"] == cell.config_name
    assert callable(spec.plugin("entries", cell.traffic["entry"]).make_call)
    assert callable(spec.plugin("geometries", cell.traffic["geometry"]).sample_xy)
    assert set(cell.settings["limits"]) and cell.settings["check_pairs"] >= 1
    assert cell.end_to_end and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_cell_is_new_files_only(bench_copy):
    root = bench_copy
    before = _hashes(root / "icpbench")
    b = root / "icpbench"
    (b / "traffic" / "pairs_wide.json").write_text(json.dumps(
        {**json.loads((b / "traffic" / "pairs.json").read_text()), "angle_max": 0.05}))
    (b / "workloads" / "dragon.pairs_wide.json").write_text(
        (b / "workloads" / "dragon.pairs.json").read_text())
    (b / "metrics" / "pool_pairs.py").write_text(
        "def read(r):\n    return float(r.window_pairs) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dragon.pairs_wide", "config": "dragon",
                               "traffic": "pairs_wide", "chips": 1, "why": "wider motions"})
    bench["per_layer"].append({"name": "pool_pairs", "unit": "pairs", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "register_ms", "workloads": ["dragon.pairs_wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _hashes(root / "icpbench")
    assert all(after[p] == h for p, h in before.items())
    cell = spec.load("dragon.pairs_wide", root=root)
    assert cell.traffic["angle_max"] == 0.05
    assert "pool_pairs" in [m["name"] for m in cell.per_layer]
    assert "pool_pairs" not in [m["name"] for m in spec.load("dragon.pairs", root=root).per_layer]
    read = spec.metric_reader("pool_pairs", root)
    assert read(type("R", (), {"window_pairs": 7})()) == 7.0


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        spec.load("no.such.cell")

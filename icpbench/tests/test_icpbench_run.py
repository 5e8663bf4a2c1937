"""A whole run of a small cell on the CPU: the result line's keys, the
metrics each mode reports, and what the run may load."""

import json
import subprocess
import sys

from icpbench import run, spec
from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_result_line_has_the_required_keys(tiny_root, program):
    cell = spec.load("tiny.pairs", root=tiny_root)
    out, _, _ = run.run_cell(cell, seed=2**31 + 21, seconds=0.5, trace=False, device="cpu",
                             program=program)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"register_ms", "register_p90_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == set(cell.settings["limits"])
    assert json.loads(json.dumps(out)) == out


def test_traced_run_reads_per_layer_metrics(tiny_root, program):
    cell = spec.load("tiny.strips", root=tiny_root)
    out, _, _ = run.run_cell(cell, seed=2**31 + 22, seconds=0.1, trace=True, device="cpu",
                             program=program)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True
    # the CPU has no device trace: only the program's counters are read
    assert set(out["metrics"]) == {"iterations_per_reg", "host_reads_per_reg"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_new_entry_geometry_and_metric_are_new_files_only(tiny_root, program):
    b = tiny_root / "icpbench"
    before = {q: q.read_bytes() for q in b.rglob("*") if q.is_file()}
    (b / "entries" / "icp_register_counted.py").write_text(
        "CALLS = []\n"
        "def make_call(program, pool, cfg, device, fields):\n"
        "    def call(pairs):\n"
        "        CALLS.append(pairs)\n"
        "        (j,) = pairs\n"
        "        r = program.icp_register(pool.fixed[j], pool.movable[j], cfg, device=device)\n"
        "        return {k: getattr(r, k)[None] for k in fields}\n"
        "    return call\n")
    (b / "geometries" / "strips_y.py").write_text(
        "import torch\n"
        "def sample_xy(g, n_fix, n_mov, half, dtype, device):\n"
        "    xy = (torch.rand((n_fix + n_mov, 2), generator=g, dtype=dtype,\n"
        "                     device=device) * 2 - 1) * half\n"
        "    return xy[:n_fix], xy[n_fix:] + torch.tensor([0.0, half / 2], dtype=dtype,\n"
        "                                                  device=device)\n")
    (b / "metrics" / "pairs_per_s.py").write_text(
        "def read(r):\n"
        "    return r.window_pairs / r.window_seconds\n")
    traffic = json.loads((b / "traffic" / "strips.json").read_text())
    traffic.update(entry="icp_register_counted", geometry="strips_y", pool=2)
    (b / "traffic" / "strips_y.json").write_text(json.dumps(traffic))
    (b / "workloads" / "tiny.strips_y.json").write_text(
        (b / "workloads" / "tiny.strips.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.strips_y", "config": "tiny",
                               "traffic": "strips_y", "chips": 1, "why": "tests"})
    bench["end_to_end"].append({"name": "pairs_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.strips_y"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(q.read_bytes() == v for q, v in before.items())

    cell = spec.load("tiny.strips_y", root=tiny_root)
    out, r, _ = run.run_cell(cell, seed=2**31 + 23, seconds=0.2, trace=False, device="cpu",
                             program=program)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"register_ms", "register_p90_ms", "setup_s", "pairs_per_s"}
    entry = spec.plugin("entries", "icp_register_counted", tiny_root)
    assert entry is not None and r.window_pairs >= 1
    assert "pairs_per_s" not in spec.load("tiny.strips", root=tiny_root).end_to_end


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "simpleicp_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "simpleicp_tpu.models", object())
    assert run.forbidden_modules() == ["simpleicp_tpu"]


def test_run_path_loads_no_jax(tiny_root):
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "import icpbench.run as r, icpbench.calibrate\n"
        "from icpbench import spec\n"
        f"cell = spec.load('tiny.batch', root=Path({str(tiny_root)!r}))\n"
        "out, _, _ = r.run_cell(cell, seed=5, seconds=0.1, trace=False, device='cpu')\n"
        "print(out['correct'], r.forbidden_modules())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[-2] == "True []"


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "dragon.pairs", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_outside_a_checkout_the_run_fails(bench_copy):
    res = subprocess.run([sys.executable, "icpbench/run.py", "--workload", "dragon.pairs",
                          "--seed", "1", "--seconds", "1"], cwd=bench_copy,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""

"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
with small cells, run on the CPU through the program's plain versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small cells: each keeps a real cell's traffic and limits at 8 000 points.
TINY = {"tiny.pairs": ("pairs", "dragon.pairs"), "tiny.strips": ("strips", "airborne_lidar.strips"),
        "tiny.batch": ("tiny_batch", "dragon.batch32")}


def copy_benchmark(dst: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "icpbench", dst / "icpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


@pytest.fixture
def bench_copy(tmp_path):
    return copy_benchmark(tmp_path)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with a small configuration and its cells,
    added as new files and entries only."""
    root = copy_benchmark(tmp_path)
    b = root / "icpbench"
    cfg = json.loads((b / "configs" / "dragon.json").read_text())
    cfg.update(name="tiny", points_fixed=8000, points_movable=8000)
    cfg["icp"]["correspondences"] = 200
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    batch = json.loads((b / "traffic" / "batch32.json").read_text())
    batch.update(pool=8, pairs_per_call=4, warmup_calls=1)
    (b / "traffic" / "tiny_batch.json").write_text(json.dumps(batch))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "small copy of dragon",
                             "file": "icpbench/configs/tiny.json",
                             "reduced": ["points_fixed", "points_movable"], "why": "tests"})
    for name, (traffic, like) in TINY.items():
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "tests"})
        settings = json.loads((b / "workloads" / f"{like}.json").read_text())
        settings.update(check_pairs=3, trace_calls=1)
        (b / "workloads" / f"{name}.json").write_text(json.dumps(settings))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def program():
    import torch

    torch.set_num_threads(2)
    from icpbench.run import load_program

    return load_program()

"""What one cell of the benchmark is, read from files found by name.

``BENCHMARK.json`` (at the checkout's root) names the cell, its
configuration and its traffic. The configuration's file is the one the
entry names; the traffic mix is ``icpbench/traffic/<traffic>.json``; the
cell's own settings (how many calls the check and the trace take, and the
limit of each number the check compares) are
``icpbench/workloads/<cell>.json``; the traffic's entry and geometry are
``icpbench/entries/<entry>.py`` and ``icpbench/geometries/<geometry>.py``;
each metric, end-to-end or per-layer, is read by
``icpbench/metrics/<name>.py``. A new cell, configuration, traffic mix,
entry, geometry or metric is a new file and a new entry: nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    config: Dict        # the configuration's file
    traffic: Dict       # the traffic mix's file
    settings: Dict      # the cell's own file
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    root: Path = ROOT

    def icp_fields(self) -> Dict:
        """The IcpConfig fields of this cell: the configuration's, with the
        traffic's overrides on top."""
        return {**self.config["icp"], **self.traffic.get("icp", {})}


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; a name it lacks, or a
    file it names that is missing, raises."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / BENCH_DIR.name
    return Cell(
        name=workload, config_name=w["config"],
        chips=int(w["chips"]),
        config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        settings=_json(bench_dir / "workloads" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root,
    )


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module ``icpbench/<kind>/<name>.py`` of ``root``."""
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"icpbench_{kind}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``icpbench/metrics/<name>.py``."""
    return plugin("metrics", name, root).read

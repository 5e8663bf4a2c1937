"""The host's side of a run: the readings around the window, and the
set-up's freeze and pin (in a process of its own, so the tests' process
keeps its CPUs)."""

import subprocess
import sys

from icpbench import host
from conftest import ROOT


def test_watch_and_halves():
    with host.Watch() as w:
        sum(i * i for i in range(100_000))
    assert set(w.read) == {"thread_cpu_share", "steal_share"}
    assert 0.0 < w.read["thread_cpu_share"] <= 1.5 and 0.0 <= w.read["steal_share"] <= 1.0
    got = host.halves_ms([0.1, 0.1, 0.3, 0.3], [1, 1, 2, 2])
    assert got == {"first_half_ms": 100.0, "second_half_ms": 150.0}
    assert host.halves_ms([0.1], [1]) == {}


def test_steady_freezes_and_pins():
    code = (f"import sys, os, gc; sys.path.insert(0, {str(ROOT)!r})\n"
            "from icpbench import host\n"
            "host.steady()\n"
            "print(len(os.sched_getaffinity(0)), gc.get_freeze_count() > 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1", "True"]

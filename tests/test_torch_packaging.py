"""The port as an installed program.

A wheel is built by pip from a copy of the tree (the packaging files and
both packages, without built files), so that the checkout gains no build/
and no egg-info and this module does not race tests/test_packaging.py's
editable install of the checkout itself. It is installed with no network
into a fresh venv that sees the test interpreter's site-packages through a
.pth file, never the checkout. The helpers are chip_smoke.py's, whose
``install`` phase runs the same installed program on the card.
"""

import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from simpleicp_tpu_torch import __version__, _build
from simpleicp_tpu_torch.utils.xyz_io import write_xyz_plain

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "simpleicp_tpu_torch"
# A library left in a checkout's _build/ by an earlier first use.
STRAY_LIB = "simpleicp_tpu_torch/_build/libknn-0123456789abcdef.so"


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    src = chip_smoke.copy_tree(tmp_path_factory.mktemp("pkg") / "src")
    (src / STRAY_LIB).parent.mkdir()
    (src / STRAY_LIB).write_bytes(b"\x7fELF")
    return chip_smoke.build_wheel(src, tmp_path_factory.mktemp("wheel"))


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """(bin directory, site-packages) of the fresh venv."""
    return chip_smoke.install_wheel(wheel, tmp_path_factory.mktemp("prefix") / "venv")


def test_wheel_ships_the_sources_and_both_scripts(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        entry_points = next(z.read(n).decode() for n in names
                            if n.endswith(".dist-info/entry_points.txt"))
    sources = [p.relative_to(ROOT).as_posix()
               for p in sorted(PORT.glob("csrc/*.cu")) + sorted(PORT.glob("native/*.cpp"))]
    assert {"simpleicp_tpu_torch/csrc/knn.cu", "simpleicp_tpu_torch/csrc/dilate.cu",
            "simpleicp_tpu_torch/native/xyz_parser.cpp",
            "simpleicp_tpu_torch/native/xyz_writer.cpp"} <= set(sources)
    assert set(sources) <= names
    port = [n for n in names if n.startswith("simpleicp_tpu_torch/")]
    assert not [n for n in port if n.endswith(".so") or "/_build/" in n], port
    assert "simpleicp-tpu = simpleicp_tpu.cli:main" in entry_points
    assert "simpleicp-tpu-torch = simpleicp_tpu_torch.cli:main" in entry_points
    # the JAX package's part: its modules and its C++ with the Makefile
    jax_pkg = ROOT / "simpleicp_tpu"
    expected = {p.relative_to(ROOT).as_posix()
                for p in [*jax_pkg.rglob("*.py"), *jax_pkg.glob("native/*.cpp"),
                          jax_pkg / "native" / "Makefile"]
                if "__pycache__" not in p.parts}
    assert {n for n in names if n.startswith("simpleicp_tpu/")} == expected


def test_installed_console_script_version(installed):
    bin_dir, _ = installed
    proc = subprocess.run([str(bin_dir / "simpleicp-tpu-torch"), "--version"],
                          cwd=bin_dir.parent, env=chip_smoke.isolated_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == f"simpleicp-tpu-torch {__version__}" == \
        "simpleicp-tpu-torch 0.1.0"


def test_installed_cli_builds_from_installed_sources(installed, tmp_path):
    """The installed script on the CPU, started outside the checkout, reads
    and writes through a libnative built by g++ into the installed package
    from the installed native/*.cpp; its H rows and its export equal those
    of ``python -m simpleicp_tpu_torch`` run from the checkout."""
    bin_dir, sp = installed
    rng = np.random.default_rng(12)
    xy = rng.uniform(-1, 1, (3000, 2))
    X = np.column_stack([xy, 0.2 * np.sin(3 * xy[:, 0]) + 0.1 * np.cos(2 * xy[:, 1])])
    f1, f2 = tmp_path / "fix.xyz", tmp_path / "mov.xyz"
    write_xyz_plain(f1, X, fmt="%.6f")
    write_xyz_plain(f2, X + [0.02, -0.01, 0.005], fmt="%.6f")
    build_dir = sp / "simpleicp_tpu_torch" / "_build"
    assert not build_dir.exists() or not any(build_dir.iterdir())

    work = tmp_path / "work"
    work.mkdir()
    out_installed, out_checkout = work / "installed.xyz", tmp_path / "checkout.xyz"
    args = ["-f", str(f1), "-m", str(f2), "--device", "cpu"]
    rc, log, _, report = chip_smoke.run_installed(
        bin_dir, [*args, "--export", str(out_installed)], work)
    assert rc == 0, log[-3000:]
    assert "Finished in " in log
    chip_smoke.check_installed(report, sp, "installed CLI")
    assert len(list(build_dir.glob("libnative-*.so"))) == 1
    assert set(report["build_s"]) == {"native"}

    env = chip_smoke.isolated_env({"PYTHONPATH": str(ROOT)})
    proc = subprocess.run(
        [sys.executable, "-m", "simpleicp_tpu_torch", *args, "--export", str(out_checkout)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = chip_smoke.h_rows(log)
    assert len(rows) == 4 and rows == chip_smoke.h_rows(proc.stdout + proc.stderr)
    assert out_installed.read_bytes() == out_checkout.read_bytes()


@pytest.mark.parametrize("name", ["knn", _build.NATIVE])
def test_missing_source_raises_naming_it(name, tmp_path, monkeypatch):
    """An install without the package's sources fails at the first build
    with RuntimeError naming the missing path, before any compiler is
    looked up or started."""
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-such-toolkit"))
    missing = tmp_path / ("knn.cu" if name == "knn" else "*.cpp")
    with pytest.raises(RuntimeError, match="lacks the package's sources") as err:
        _build.build(name)
    assert f"missing source {missing}:" in str(err.value)
    assert "not found" not in str(err.value) and "failed on" not in str(err.value)
    assert not (tmp_path / "_build").exists() and not _build.BUILD_LOGS
    assert os.listdir(tmp_path) == []
